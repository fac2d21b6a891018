"""On-card tests of the port's CUDA shear kernel (``requires_cuda``).

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
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
    SHEAR_PASSES,
    shear_rows,
    shear_rows_dispatch,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import asr_step
from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
    SRConfig,
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
        ref = shear_rows(inp.float(), shift)
        tol = 1e-5 if dtype == torch.float32 else _bf16_ulp(ref)
        assert got.dtype == dtype
        assert bool(((got.float() - ref).abs() <= tol).all())


@pytest.mark.requires_cuda
def test_kernel_rejects_what_it_cannot_run(cuda_device):
    images, s = _case()
    x, st = images.to(cuda_device), s.to(cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        shear_kernel.shear_rows_cuda(x.transpose(1, 2),
                                     torch.zeros(4, 512, device=cuda_device))
    with pytest.raises(TypeError):
        shear_kernel.shear_rows_cuda(x.half(), st)
    with pytest.raises(ValueError, match="but s on"):
        shear_kernel.shear_rows_cuda(x, s)


@pytest.mark.requires_cuda
def test_asr_step_on_card_matches_cpu(cuda_device):
    """asr_step at 64 px (f32 model, 4 copies, 20 steps) on the card against
    the same call on the CPU: masks agree on >= 99% of pixels, the SR target
    within 1e-2 (TF32 off; see chip_smoke.py). With the stencil given, one
    image launches the kernel 3 times for the copies warp and 6 times for
    b = A^T y."""
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
        before = shear_kernel.shear_rows_cuda.launches
        out = asr_step(model, image.to(dev), a, sh, sr_cfg, class_id,
                       gram_coeffs=coeffs, return_targets=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert shear_kernel.shear_rows_cuda.launches - before == 3 * SHEAR_PASSES
        outs[dev.type] = {k: v.cpu() for k, v in out.items()}
    for key in ("aug", "standard"):
        assert float((outs["cpu"][key] == outs["cuda"][key]).float().mean()) >= 0.99
    err = (outs["cpu"]["aug_target"] - outs["cuda"]["aug_target"]).abs().max()
    assert float(err) <= 1e-2
