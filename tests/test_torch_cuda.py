"""On-card tests of the port's CUDA shear kernels (``requires_cuda``).

Each test asks for the ``cuda_device`` fixture, which skips where
``torch.cuda.is_available()`` is false. This file imports neither jax nor
the JAX package, so it also runs on a machine without JAX. There, run it
without the repository's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from deeplabv3plus_augmented_superresolution_tpu_torch.models import (
    DeepLabConfig,
    build_model,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.ops import shear_kernel
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.fused_operator import (
    OPERATOR_LAUNCHES,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
    WARP_LAUNCHES,
    shear_cols,
    shear_cols_dispatch,
    shear_rows,
    shear_rows_dispatch,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
    asr_step,
    asr_step_multiclass,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
    SRConfig,
    multiclass_max_mean_superresolution,
    precompute_gram_stencil,
)

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(seed=7, n=4, h=128, w=512, coef=0.15, off=200.0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (n, h, w)).astype(np.float32)
    coefs = rng.uniform(-coef, coef, n).astype(np.float32)
    offs = rng.uniform(-off, off, n).astype(np.float32)
    y = np.arange(h, dtype=np.float32)
    s = (coefs[:, None] * (y[None, :] - h / 2) + offs[:, None]).astype(np.float32)
    return torch.from_numpy(images), torch.from_numpy(s)


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


AXES = {
    "rows": (shear_kernel.shear_rows_cuda, shear_rows_dispatch, shear_rows),
    "cols": (shear_kernel.shear_cols_cuda, shear_cols_dispatch, shear_cols),
}


def _axis_case(axis, n=4, h=128, w=512, seed=7):
    """Images and shifts for one axis: s is (N, H) for rows, (N, W) for cols."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (n, h, w)).astype(np.float32)
    length = h if axis == "rows" else w
    coefs = rng.uniform(-0.15, 0.15, n).astype(np.float32)
    offs = rng.uniform(-0.4 * (w if axis == "rows" else h),
                       0.4 * (w if axis == "rows" else h), n).astype(np.float32)
    i = np.arange(length, dtype=np.float32)
    s = (coefs[:, None] * (i[None, :] - length / 2) + offs[:, None]).astype(np.float32)
    return torch.from_numpy(images), torch.from_numpy(s)


def _assert_matches_plain(got, inp, shift, plain, dtype):
    """f32 within 1e-5 (the kernel may contract to an FMA); bf16 within one
    bf16 ulp of the f32 result."""
    ref = plain(inp.float(), shift)
    tol = 1e-5 if dtype == torch.float32 else _bf16_ulp(ref)
    assert got.dtype == dtype and got.is_contiguous()
    assert bool(((got.float() - ref).abs() <= tol).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda_device, dtype):
    """Forward and backward (the same kernel with -s) against shear_rows on
    the same card: f32 within 1e-5 (the kernel may contract to an FMA);
    bf16 within one bf16 ulp of the f32 result."""
    images, s = _case()
    x = images.to(cuda_device, dtype)
    st = s.to(cuda_device)
    g = torch.rand(x.shape, generator=torch.Generator().manual_seed(1)).to(cuda_device, dtype)
    before = shear_kernel.shear_rows_cuda.launches
    xg = x.clone().requires_grad_(True)
    out = shear_rows_dispatch(xg, st)
    (grad,) = torch.autograd.grad(out, xg, g)
    torch.cuda.synchronize()
    assert shear_kernel.shear_rows_cuda.launches == before + 2
    for got, inp, shift in ((out, x, st), (grad, g, -st)):
        _assert_matches_plain(got, inp, shift, shear_rows, dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_column_kernel_matches_plain_version(cuda_device, dtype):
    """shear_cols forward and backward against its plain version, shifts up
    to 0.4 of the height so that both edges zero-fill."""
    images, s = _axis_case("cols")
    x = images.to(cuda_device, dtype)
    st = s.to(cuda_device)
    g = torch.rand(x.shape, generator=torch.Generator().manual_seed(1)).to(cuda_device, dtype)
    before = shear_kernel.shear_cols_cuda.launches
    xg = x.clone().requires_grad_(True)
    out = shear_cols_dispatch(xg, st)
    (grad,) = torch.autograd.grad(out, xg, g)
    torch.cuda.synchronize()
    assert shear_kernel.shear_cols_cuda.launches == before + 2
    for got, inp, shift in ((out, x, st), (grad, g, -st)):
        _assert_matches_plain(got, inp, shift, shear_cols, dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stride_0_and_channel_planes_on_card(cuda_device, axis, dtype):
    """An expanded (C, H, W) image (stride 0 over the copies) is read in
    place: same values as the kernel on the materialised batch, bit for bit,
    and within tolerance of the plain version; the image's gradient is the
    sum over the copies (1e-4: f32 sums of 4 terms in another order; bf16
    gradients are compared in f32 at 4 ulps of the sum)."""
    kernel, dispatch, plain = AXES[axis]
    images, s = _axis_case(axis, n=4, h=64, w=256, seed=11)
    st = s.to(cuda_device)
    planes = images[:3].to(cuda_device, dtype).requires_grad_(True)     # (C, H, W)
    expanded = planes[None].expand(4, 3, 64, 256)
    out = dispatch(expanded, st)
    copied = expanded.detach().contiguous()
    assert bool((out == kernel(copied, st)).all())
    _assert_matches_plain(out.detach(), copied, st, plain, dtype)
    g = torch.rand(out.shape, generator=torch.Generator().manual_seed(2)).to(cuda_device, dtype)
    (grad,) = torch.autograd.grad(out, planes, g)
    ref = plain(g.float(), -st).sum(0)
    tol = 1e-4 if dtype == torch.float32 else 4 * _bf16_ulp(ref)
    assert tuple(grad.shape) == (3, 64, 256)
    assert bool(((grad.float() - ref).abs() <= tol).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_odd_width_and_unaligned_views_on_card(cuda_device, axis, dtype):
    """Width 509 (no 16-byte rows: the row kernel's scalar path, the column
    kernel's one-column path) and a view that starts one element into its
    buffer (a base pointer off the vector boundary)."""
    kernel, _, plain = AXES[axis]
    for w, offset in ((509, 0), (512, 1)):
        images, s = _axis_case(axis, n=3, h=96, w=w, seed=13 + w)
        buffer = torch.zeros(images.numel() + offset, device=cuda_device, dtype=dtype)
        buffer[offset:] = images.to(cuda_device, dtype).flatten()
        x = buffer[offset:].view(images.shape)
        st = s.to(cuda_device)
        _assert_matches_plain(kernel(x, st), x, st, plain, dtype)


@pytest.mark.requires_cuda
def test_kernel_rejects_what_it_cannot_run(cuda_device):
    images, s = _case()
    x, st = images.to(cuda_device), s.to(cuda_device)
    for wrapper, dim in ((shear_kernel.shear_rows_cuda, 1),
                         (shear_kernel.shear_cols_cuda, 2)):
        for view in (x.transpose(1, 2), x[..., ::2]):
            with pytest.raises(ValueError, match="contiguous"):
                wrapper(view, torch.zeros(4, view.shape[dim], device=cuda_device))
    with pytest.raises(ValueError, match="s must be"):
        shear_kernel.shear_cols_cuda(x, st)            # (N, H) shifts, not (N, W)
    with pytest.raises(TypeError):
        shear_kernel.shear_rows_cuda(x.half(), st)
    with pytest.raises(ValueError, match="but s on"):
        shear_kernel.shear_rows_cuda(x, s)
    with pytest.raises(ValueError, match="CUDA"):
        shear_kernel.shear_cols_cuda(images, torch.zeros(4, 512))
    # Taken as they are: a batch-strided view and a stride-0 batch.
    strided = torch.cat([x, x])[::2]
    assert bool((shear_kernel.shear_rows_cuda(strided, st[[0, 2, 0, 2]])
                 == shear_kernel.shear_rows_cuda(strided.contiguous(), st[[0, 2, 0, 2]])).all())


@pytest.mark.requires_cuda
def test_asr_step_on_card_matches_cpu(cuda_device):
    """asr_step at 64 px (f32 model, 4 copies, 20 steps) on the card against
    the same call on the CPU: masks agree on >= 99% of pixels, the SR target
    within 1e-2 (TF32 off; see chip_smoke.py). With the stencil given, one
    image launches shear_rows 2 times and shear_cols once for the copies
    warp, and twice as many again for b = A^T y (the operator forward and
    its adjoint)."""
    cfg = DeepLabConfig(input_shape=(64, 64, 3), final_upsample=False)
    sr_cfg = SRConfig(num_aug=4, feature_size=(16, 16), output_size=(64, 64),
                      angle_max=0.15, num_iter=20, solver_impl="gram")
    rng = np.random.default_rng(2)
    image = torch.from_numpy(rng.uniform(0, 1, (64, 64, 3)).astype(np.float32))
    angles = torch.from_numpy(rng.uniform(-0.15, 0.15, 4).astype(np.float32))
    shifts = torch.from_numpy(rng.uniform(-8, 8, (4, 2)).astype(np.float32))
    angles[0], shifts[0] = 0.0, 0.0
    outs = {}
    for dev in (torch.device("cpu"), cuda_device):
        model = build_model(cfg, seed=0, device=dev)
        if not outs:
            with torch.no_grad():
                labels = model(image[None]).argmax(-1)
            class_id = int(torch.bincount(labels.flatten(), minlength=21).argmax())
        a, sh = angles.to(dev), shifts.to(dev)
        coeffs = precompute_gram_stencil(a, sh, sr_cfg)
        kernels = {"shear_rows": shear_kernel.shear_rows_cuda,
                   "shear_cols": shear_kernel.shear_cols_cuda}
        before = {name: k.launches for name, k in kernels.items()}
        out = asr_step(model, image.to(dev), a, sh, sr_cfg, class_id,
                       sr_types=("aug",), gram_coeffs=coeffs, return_targets=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            for name, k in kernels.items():
                assert k.launches - before[name] == (WARP_LAUNCHES[name]
                                                     + 2 * OPERATOR_LAUNCHES[name])
        outs[dev.type] = {k: v.cpu() for k, v in out.items()}
    for key in ("aug", "standard"):
        assert float((outs["cpu"][key] == outs["cuda"][key]).float().mean()) >= 0.99
    err = (outs["cpu"]["aug_target"] - outs["cuda"]["aug_target"]).abs().max()
    assert float(err) <= 1e-2


def _launches():
    return {"shear_rows": shear_kernel.shear_rows_cuda.launches,
            "shear_cols": shear_kernel.shear_cols_cuda.launches}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("axis", ["rows", "cols"])
def test_class_planes_on_card(cuda_device, axis):
    """The multi-class layout: (N, K, H, W) as the transpose of a (K, N, H, W)
    stack (stride H*W over the copies, N*H*W over the classes), one shift per
    copy shared by its K planes. Bit for bit the kernel on the materialised
    copy, and within 1e-5 of the plain version (f32)."""
    kernel, _, plain = AXES[axis]
    rng = np.random.default_rng(17)
    stack = torch.from_numpy(rng.uniform(0, 1, (3, 4, 64, 128)).astype(np.float32))
    view = stack.to(cuda_device).transpose(0, 1)                    # (N, K, H, W)
    _, s = _axis_case(axis, n=4, h=64, w=128, seed=19)
    st = s.to(cuda_device)
    out = kernel(view, st)
    assert bool((out == kernel(view.contiguous(), st)).all())
    _assert_matches_plain(out, view.contiguous(), st, plain, torch.float32)


@pytest.mark.requires_cuda
def test_inverse_warp_on_card_matches_cpu(cuda_device):
    """max/mean SR of K = 3 classes (the upsample 16 -> 64 and the inverse
    warp of the (N, K, 64, 64) stack) on the card against the CPU: 1e-5; one
    inverse warp, 2 shear_rows + 1 shear_cols launches, whatever K."""
    rng = np.random.default_rng(23)
    masks = torch.from_numpy(rng.uniform(0, 1, (3, 4, 16, 16, 1)).astype(np.float32))
    angles = torch.from_numpy(rng.uniform(-0.15, 0.15, 4).astype(np.float32))
    shifts = torch.from_numpy(rng.uniform(-8, 8, (4, 2)).astype(np.float32))
    cfg = SRConfig(num_aug=4, feature_size=(16, 16), output_size=(64, 64),
                   angle_max=0.15)
    cpu = multiclass_max_mean_superresolution(masks, angles, shifts, cfg)
    before = _launches()
    card = multiclass_max_mean_superresolution(masks.to(cuda_device),
                                               angles.to(cuda_device),
                                               shifts.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _launches().items()} == WARP_LAUNCHES
    for c, g in zip(cpu, card):
        assert tuple(g.shape) == (3, 64, 64, 1)
        assert float((c - g.cpu()).abs().max()) <= 1e-5


@pytest.mark.requires_cuda
@pytest.mark.parametrize("class_chunk", [0, 2])
def test_asr_step_multiclass_launches_on_card(cuda_device, class_chunk):
    """asr_step_multiclass of 3 classes with aug, max and mean on the card:
    the copies warp once, then per class group one b (the operator forward
    and its adjoint) and one inverse warp, so groups, not classes, count;
    the masks equal the CPU's on >= 99% of pixels."""
    cfg = DeepLabConfig(input_shape=(64, 64, 3), backbone="mobilenet",
                        final_upsample=False)
    sr_cfg = SRConfig(num_aug=4, feature_size=(8, 8), output_size=(64, 64),
                      angle_max=0.15, num_iter=10, solver_impl="gram")
    rng = np.random.default_rng(29)
    image = torch.from_numpy(rng.uniform(0, 1, (64, 64, 3)).astype(np.float32))
    angles = torch.from_numpy(rng.uniform(-0.15, 0.15, 4).astype(np.float32))
    shifts = torch.from_numpy(rng.uniform(-8, 8, (4, 2)).astype(np.float32))
    angles[0], shifts[0] = 0.0, 0.0
    groups = 2 if class_chunk == 2 else 1
    outs = {}
    for dev in (torch.device("cpu"), cuda_device):
        model = build_model(cfg, seed=0, device=dev)
        if not outs:  # the 3 classes the random model predicts most
            with torch.no_grad():
                labels = model(image[None]).argmax(-1)
            counts = torch.bincount(labels.flatten(), minlength=21)
            class_ids = tuple(int(c) for c in counts.argsort(descending=True)[:3])
        a, sh = angles.to(dev), shifts.to(dev)
        coeffs = precompute_gram_stencil(a, sh, sr_cfg)
        before = _launches()
        out = asr_step_multiclass(model, image.to(dev), a, sh, sr_cfg, class_ids,
                                  class_chunk=class_chunk, gram_coeffs=coeffs,
                                  return_label_map=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            for name, count in _launches().items():
                per_group = 2 * OPERATOR_LAUNCHES[name] + WARP_LAUNCHES[name]
                assert count - before[name] == WARP_LAUNCHES[name] + groups * per_group
        outs[dev.type] = {k: v.cpu() for k, v in out.items()}
    for key in ("aug", "max", "mean", "standard", "label_map"):
        assert float((outs["cpu"][key] == outs["cuda"][key]).float().mean()) >= 0.99


@pytest.mark.requires_cuda
@pytest.mark.parametrize("size", [32, 128])
def test_warp_augment_layouts_on_card(cuda_device, size):
    """The training layouts: a batch of 8 images (3 planes each, each sample
    its own angle and shift) and of 8 label maps through the nearest mode,
    on the card against the CPU: images 1e-5, labels (255 contours, the
    zero border) exactly; 4 shear_rows + 2 shear_cols launches."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
        warp_augment_batch_with_draws)

    rng = np.random.default_rng(31)
    images = torch.from_numpy(rng.uniform(0, 1, (8, size, size, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 21, (8, size, size)).astype(np.uint8))
    labels[:, size // 3] = 255
    draws = [torch.from_numpy(d) for d in (
        rng.uniform(-0.15, 0.15, 8).astype(np.float32),
        rng.uniform(-size / 6, size / 6, (8, 2)).astype(np.float32),
        (rng.uniform(0, 1, 8) < 0.5).astype(np.float32))]
    cpu = warp_augment_batch_with_draws(images, labels, *draws)
    before = _launches()
    card = warp_augment_batch_with_draws(images.to(cuda_device), labels.to(cuda_device),
                                         *(d.to(cuda_device) for d in draws))
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _launches().items()} == {
        k: 2 * v for k, v in WARP_LAUNCHES.items()}
    assert float((card[0].cpu() - cpu[0]).abs().max()) <= 1e-5
    assert card[1].dtype == torch.uint8 and torch.equal(card[1].cpu(), cpu[1])


def _conditioned_start(cfg):
    """tests/test_torch_train.py's start for one train step, where its
    gradient is well conditioned: the initial params with every
    BatchNorm's gamma drawn from U(0.25, 0.5) and beta from +-U(1, 2)."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.models import init_params

    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(7)
    for entry in params.values():
        if "gamma" in entry:
            n = entry["gamma"].shape
            entry["gamma"] = rng.uniform(0.25, 0.5, n).astype(np.float32)
            entry["beta"] = (rng.choice([-1.0, 1.0], n)
                             * rng.uniform(1.0, 2.0, n)).astype(np.float32)
    return params


@pytest.mark.requires_cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    """One train step of MobileNetV2 (alpha 0.35, 32 px, f32, sgd with
    Nesterov momentum at 1e-5, the non-finite guard on) on the card against
    the CPU, and the same step with remat on the card against the plain one
    (cuDNN's backward may sum in another order from run to run), from
    tests/test_torch_train.py's conditioned start with its tolerances."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.models import params_from_jax
    from deeplabv3plus_augmented_superresolution_tpu_torch.models.deeplab import DeepLab
    from deeplabv3plus_augmented_superresolution_tpu_torch.models.optim import (
        Schedule, TrainOptimizer)
    from deeplabv3plus_augmented_superresolution_tpu_torch.models.train import (
        MasterParams, make_train_step)
    from deeplabv3plus_augmented_superresolution_tpu_torch.models.weights import (
        to_reference_layout)

    cfg = DeepLabConfig(input_shape=(32, 32, 3), backbone="mobilenet", alpha=0.35,
                        weights=None, final_upsample=True, compute_dtype="float32")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 21, (2, 32, 32)).astype(np.int32))
    labels[:, :3] = 255
    start = _conditioned_start(cfg)
    outs = {}
    for dev, remat in ((torch.device("cpu"), False), (cuda_device, False),
                       (cuda_device, True)):
        master = MasterParams(params_from_jax(start), dev)
        tx = TrainOptimizer("sgd", Schedule("constant", 1e-5), momentum=0.9)
        step = make_train_step(DeepLab(cfg, device="meta"), tx, remat=remat,
                               skip_nonfinite=True)
        _, opt_state, loss = step(master, tx.init(master), images.to(dev), labels.to(dev))
        trace = {}
        for (layer, name), view in zip(master.keys,
                                       master.leaves(opt_state.tensors["trace"].cpu())):
            trace.setdefault(layer, {})[name] = to_reference_layout(name, view.numpy())
        outs[(dev.type, remat)] = (float(loss), master.numpy_params(), trace)
    for ref, other in ((("cpu", False), ("cuda", False)), (("cuda", False), ("cuda", True))):
        (l_ref, p_ref, t_ref), (l_other, p_other, t_other) = outs[ref], outs[other]
        assert l_other == pytest.approx(l_ref, rel=1e-5)
        _assert_step_close(p_other, t_other, p_ref, t_ref)


def _assert_step_close(got_params, got_trace, want_params, want_trace):
    """tests/test_torch_train.py's train-step tolerances: the moving
    statistics 1e-5 absolute + 1e-5 relative; the other parameters 1e-6
    absolute; sgd's momentum trace (the step's gradient) per leaf to 1% of
    that leaf's largest value + 1e-4 of the whole trace's."""
    scale = max(float(np.abs(v).max()) for e in want_trace.values() for v in e.values())
    for layer, entry in want_params.items():
        for name, w in entry.items():
            err = np.abs(got_params[layer][name] - w).max()
            if name.startswith("moving"):
                assert err <= 1e-5 + 1e-5 * np.abs(w).max(), (layer, name, err)
                continue
            assert err <= 1e-6, (layer, name, err)
            g = want_trace[layer][name]
            err = np.abs(got_trace[layer][name] - g).max()
            assert err <= 1e-2 * np.abs(g).max() + 1e-4 * scale, (
                layer, name, err, np.abs(g).max())
