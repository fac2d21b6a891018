"""Port parity: the per-row shear, the Paeth warp and the resize.

The same numpy inputs go through the JAX function and the PyTorch port's
plain version (CPU tensors take ``shear_rows``; the CUDA kernel is checked
against it on the card by tests/test_torch_cuda.py and by chip_smoke.py).
JAX runs on the CPU: its shear takes the XLA two-level-blend path
(``_shear_rows``), and the Pallas kernel runs in interpret mode.
"""

import concurrent.futures
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_augmented_superresolution_tpu.models import init_params as j_init_params
from deeplabv3plus_augmented_superresolution_tpu.ops.resize import resize as j_resize
from deeplabv3plus_augmented_superresolution_tpu.ops.pallas_shear import (
    candidates_for,
    shear_rows_pallas,
)
from deeplabv3plus_augmented_superresolution_tpu.ops.shear_warp import (
    _shear_rows,
    paeth_inverse_rotate_translate as j_inverse,
    paeth_rotate_translate as j_paeth,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.ops import shear_kernel
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.resize import resize
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
    paeth_inverse_rotate_translate,
    paeth_rotate_translate,
    shear_rows,
    shear_rows_dispatch,
    shear_taps,
)

# One intra-op thread in every port test file: at these sizes a second one
# gains no wall time, and its spin-waits cost ~24 s of CPU over the port's
# files, which the suite's workers share with the JAX package's tests.
torch.set_num_threads(1)

# The JAX references compile without most of XLA's optimisations (its
# backend at level 0, as jax_disable_most_optimizations sets it): the 64-px
# Xception forward compiles in ~1 s of CPU time against 5-6 s at level 1,
# which spreads its codegen over threads. The arithmetic stays float32; the
# results can differ from the default compile's in the last bits (6.8e-13 on
# that forward's logits). EXACT_COMPILE (level 1) gives the default compile's
# results bit for bit, for the references where those bits matter: the
# random MobileNetV2's logits are ~1e-11, so they exceed 1e-4 of the scale
# there, and the min-max normalization of the max stack amplifies them.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
EXACT_COMPILE = dict(FAST_COMPILE, xla_backend_optimization_level=1)


@functools.lru_cache(maxsize=None)
def jax_init_params(cfg, seed: int = 0):
    """The JAX package's init_params(cfg, seed), once per process: the port's
    files that read the same 64-px model share it (an Xception init takes
    ~1 s). Its arrays are immutable; callers do not change the dict."""
    return j_init_params(cfg, seed=seed)


def run_fast(jitted, *args, options=FAST_COMPILE, **static):
    """jitted (a jax.jit function) compiled with options for args and its
    static keyword arguments, then called on args."""
    return jitted.lower(*args, **static).compile(options)(*args)


def compile_side_by_side(*lowered, options=FAST_COMPILE):
    """Lowered programs (jitted.lower(...)) compiled with options on threads
    side by side: tracing and lowering hold the interpreter lock, XLA's
    compile releases it."""
    with concurrent.futures.ThreadPoolExecutor(len(lowered)) as pool:
        return list(pool.map(lambda lo: lo.compile(options), lowered))


def pallas_interpret(images, s, n_cand):
    """The reference's Pallas kernel in interpret mode, as one jitted program
    (interpreted eagerly it dispatches op by op)."""
    return run_fast(jax.jit(lambda im, sh: shear_rows_pallas(im, sh, n_cand, True)),
                    images, s)


BF16_ULP_AT_1 = 2.0 ** -8  # one bfloat16 ulp for values in [1, 2)


def _case(seed=0, n=3, h=64, w=64, coef=0.15, off=20.0):
    """Row shifts s = coef * (y - h/2) + off, as tests/test_pallas_shear.py."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (n, h, w)).astype(np.float32)
    coefs = rng.uniform(-coef, coef, n).astype(np.float32)
    offs = rng.uniform(-off, off, n).astype(np.float32)
    y = np.arange(h, dtype=np.float32)
    s = (coefs[:, None] * (y[None, :] - h / 2) + offs[:, None]).astype(np.float32)
    return images, s


# The XLA path jitted once: one compile per shape, not one per op.
_shear_rows_jit = jax.jit(_shear_rows, static_argnums=2)


def _xla_shear(images, s, span=64):
    return np.asarray(_shear_rows_jit(jnp.asarray(images)[..., None], jnp.asarray(s),
                                      span))[..., 0]


@pytest.mark.parametrize("seed,off", [(0, 20.0), (1, 100.0), (4, 240.0)])
def test_shear_rows_matches_xla_path(seed, off):
    """Same f32 2-tap arithmetic; the XLA path only adds exact zeros, so the
    two agree to f32 rounding (1e-6 for values in [0, 1])."""
    images, s = _case(seed=seed, off=off)
    ours = shear_rows(torch.from_numpy(images), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(ours, _xla_shear(images, s), atol=1e-6)


def test_shear_rows_matches_pallas_interpret_f32_and_bf16():
    """The Pallas kernel's own semantics (interpret mode): f32 to f32 rounding;
    bf16 input blended in f32 and rounded once, so within one bf16 ulp. 16
    rows: the interpret-mode kernel's cost grows with the rows."""
    images, s = _case(seed=2, h=16)
    n_cand = candidates_for(0.15)
    ref = np.asarray(pallas_interpret(jnp.asarray(images), jnp.asarray(s), n_cand))
    ours = shear_rows(torch.from_numpy(images), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6)

    ref16 = np.asarray(pallas_interpret(jnp.asarray(images, jnp.bfloat16),
                                        jnp.asarray(s), n_cand)).astype(np.float32)
    ours16 = shear_rows(torch.from_numpy(images).to(torch.bfloat16),
                        torch.from_numpy(s))
    assert ours16.dtype == torch.bfloat16
    np.testing.assert_allclose(ours16.float().numpy(), ref16, atol=BF16_ULP_AT_1)


def test_shear_budget_probe_at_240px():
    """The +-240 px budget probe of the reference's Pallas self-test: one copy
    near +240, one near -239.5, wide rows (32 of them: the interpret-mode
    kernel's cost grows with the rows, the probe does not need more)."""
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, 32, 512)).astype(np.float32)
    ramp = np.linspace(-1.0, 1.0, 32, dtype=np.float32)
    s = np.stack([ramp + 240.25, ramp - 239.5]).astype(np.float32)
    ours = shear_rows(torch.from_numpy(images), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(ours, _xla_shear(images, s, span=8), atol=1e-6)
    pallas = np.asarray(pallas_interpret(jnp.asarray(images), jnp.asarray(s), 8))
    np.testing.assert_allclose(ours, pallas, atol=1e-6)


def test_shear_backward_matches_jax_custom_vjp():
    """d/dx sum(shear(x)^2) through the autograd Function (backward = shift by
    -s) vs jax.grad through the reference's custom VJP; f32, 1e-5."""
    images, s = _case(seed=3)
    g_jax = np.asarray(run_fast(jax.jit(jax.grad(
        lambda im: jnp.sum(_shear_rows(im[..., None], jnp.asarray(s), 64) ** 2))),
        jnp.asarray(images)))
    x = torch.from_numpy(images).requires_grad_(True)
    (shear_rows_dispatch(x, torch.from_numpy(s)) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), g_jax, atol=1e-5)


def test_shear_backward_is_exact_adjoint():
    """<S x, g> == <x, S^T g> in float64 accumulation (1e-5 relative: the
    forward and the backward each round once in f32)."""
    images, s = _case(seed=5, off=60.0)
    g = np.random.default_rng(6).standard_normal(images.shape).astype(np.float32)
    x = torch.from_numpy(images).requires_grad_(True)
    y = shear_rows_dispatch(x, torch.from_numpy(s))
    (xt_g,) = torch.autograd.grad(y, x, torch.from_numpy(g))
    lhs = float(np.sum(y.detach().numpy().astype(np.float64) * g))
    rhs = float(np.sum(images.astype(np.float64) * xt_g.numpy()))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_dispatch_rejects_what_the_kernel_rejects():
    images, s = _case()
    x, st = torch.from_numpy(images), torch.from_numpy(s)
    with pytest.raises(ValueError, match="contiguous"):
        shear_rows_dispatch(x.transpose(1, 2), st)
    with pytest.raises(ValueError, match="contiguous"):
        shear_rows_dispatch(x[..., ::2], st)
    with pytest.raises(ValueError, match="s must be"):
        shear_rows_dispatch(x, st[:, :32])
    with pytest.raises(TypeError):
        shear_rows_dispatch(x.double(), st)
    with pytest.raises(TypeError):
        shear_rows_dispatch(x.half(), st)
    with pytest.raises(ValueError, match="but s on"):
        shear_rows_dispatch(x, st.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        shear_kernel.shear_rows_cuda(x, st)
    # What the kernel takes, the dispatch takes: a batch-strided view and a
    # stride-0 batch go through as they are.
    np.testing.assert_array_equal(
        shear_rows_dispatch(torch.from_numpy(np.repeat(images, 2, 0))[::2], st).numpy(),
        shear_rows_dispatch(x, st).numpy())
    np.testing.assert_array_equal(
        shear_rows_dispatch(x[0][None].expand(3, 64, 64), st).numpy(),
        shear_rows_dispatch(x[0][None].repeat(3, 1, 1), st).numpy())


def _smooth_batch(n=3, size=64, c=1, seed=0):
    rng = np.random.default_rng(seed)
    low = rng.standard_normal((n, 8, 8, c)).astype(np.float32)
    return np.array(j_resize(jnp.asarray(low), (size, size)))


def _warp_case(seed=1):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    shifts = rng.uniform(-8, 8, (3, 2)).astype(np.float32)
    angles[0], shifts[0] = 0.0, 0.0
    return angles, shifts


def _labels_case():
    gt = np.zeros((2, 96, 96, 1), np.float32)
    gt[:, 30:70, 25:75] = 8.0
    gt[:, 28:30, 23:77] = 255.0
    angles = np.array([0.27, -0.32], np.float32)
    shifts = np.array([[7.3, -9.6], [-11.0, 4.5]], np.float32)
    return gt, angles, shifts


def _bf16_case():
    img = np.random.default_rng(9).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    return torch.from_numpy(img).to(torch.bfloat16), *_warp_case(seed=2)


@pytest.fixture(scope="module")
def paeth_refs():
    """The reference's Paeth warps (angle_max 0.35), one jitted program: the
    forward of smooth f32 batches of 1 and 3 channels and the inverse of that
    forward; the forward and the inverse of the label images with the nearest
    mode; the f32 warp of the bf16 copies' image."""
    angles, shifts = _warp_case()
    imgs = {f"c{c}": _smooth_batch(3, 64, c, seed=c) for c in (1, 3)}
    gt, l_angles, l_shifts = _labels_case()
    img16, b_angles, b_shifts = _bf16_case()

    def refs(imgs, a, s, gt, la, ls, img, ba, bs):
        out = {}
        for c, x in imgs.items():
            fwd = j_paeth(x, a, s, 0.35)
            out[c] = (fwd, j_inverse(fwd, a, s, 0.35))
        out["nearest"] = (j_paeth(gt, la, ls, 0.35, "nearest"),
                          j_inverse(gt, la, ls, 0.35, "nearest"))
        out["bf16"] = j_paeth(jnp.broadcast_to(img, (3, 64, 64, 3)), ba, bs, 0.35)
        return out

    ref = run_fast(jax.jit(refs), {c: jnp.asarray(x) for c, x in imgs.items()},
                   *(jnp.asarray(v) for v in (angles, shifts, gt, l_angles, l_shifts,
                                              img16.float().numpy(), b_angles, b_shifts)))
    return imgs, jax.tree.map(np.asarray, ref)


@pytest.mark.parametrize("channels", [1, 3])
def test_paeth_forward_and_inverse_match_jax(paeth_refs, channels):
    """Three shear passes in f32. Row shifts reach ~40 px, so a 1-ulp trig
    difference moves a tap weight by ~4e-6: 2e-5 on unit-scale images.
    Angles stay inside shear_taps(0.35, 64), the reference's static span."""
    assert shear_taps(0.35, 64) >= int(np.ceil(0.35 * 64))
    imgs, refs = paeth_refs
    imgs = imgs[f"c{channels}"]
    angles, shifts = _warp_case()
    ours = paeth_rotate_translate(torch.from_numpy(imgs), torch.from_numpy(angles),
                                  torch.from_numpy(shifts), 0.35)
    ref, ref_inv = refs[f"c{channels}"]
    assert ours.shape == imgs.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)

    inv = paeth_inverse_rotate_translate(ours, torch.from_numpy(angles),
                                         torch.from_numpy(shifts), 0.35)
    np.testing.assert_allclose(inv.numpy(), ref_inv, atol=2e-5)


def test_paeth_nearest_matches_jax_on_labels(paeth_refs):
    """interpolation='nearest' rounds each pass's shift: a pure pixel selection,
    so the label images agree exactly and no label is invented."""
    gt, angles, shifts = _labels_case()
    ref, ref_inv = paeth_refs[1]["nearest"]
    ours = paeth_rotate_translate(torch.from_numpy(gt), torch.from_numpy(angles),
                                  torch.from_numpy(shifts), 0.35,
                                  interpolation="nearest").numpy()
    np.testing.assert_array_equal(ours, ref)
    assert set(np.unique(ours)) <= {0.0, 8.0, 255.0}

    inv = paeth_inverse_rotate_translate(torch.from_numpy(gt), torch.from_numpy(angles),
                                         torch.from_numpy(shifts), 0.35,
                                         interpolation="nearest").numpy()
    np.testing.assert_array_equal(inv, ref_inv)


def test_paeth_bf16_copies_within_three_roundings(paeth_refs):
    """The serving path warps bf16 copies. The port rounds to bf16 once per
    pass (blends in f32); the reference XLA path blends in bf16. Against the
    f32 reference warp: three roundings of half an ulp plus the bf16 input,
    under 3 bf16 ulps of 1.0 for images in [0, 1]."""
    img16, angles, shifts = _bf16_case()
    batched = img16[None].expand(3, 64, 64, 3)
    ours = paeth_rotate_translate(batched, torch.from_numpy(angles),
                                  torch.from_numpy(shifts), 0.35)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), paeth_refs[1]["bf16"],
                               atol=3 * BF16_ULP_AT_1)


@pytest.mark.parametrize("shape,size", [((2, 128, 128, 1), (32, 32)),
                                        ((1, 37, 50, 3), (100, 64)),
                                        ((64, 64, 3), (128, 16))])
def test_resize_bilinear_matches_jax(shape, size):
    """Same interpolation matrices, f32 products of two nonzero taps: 1e-6."""
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    ours = resize(torch.from_numpy(x), size).numpy()
    ref = np.asarray(j_resize(jnp.asarray(x), size))
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_resize_nearest_and_bf16_match_jax():
    labels = np.random.default_rng(1).integers(0, 21, (1, 512, 512, 1)).astype(np.int32)
    ours = resize(torch.from_numpy(labels), (128, 128), "nearest")
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(j_resize(jnp.asarray(labels), (128, 128),
                                                    "nearest")))
    # bf16 resizes in bf16 on both sides: compare at one bf16 ulp of 1.0.
    x = np.random.default_rng(2).uniform(0, 1, (1, 32, 32, 4)).astype(np.float32)
    ours16 = resize(torch.from_numpy(x).to(torch.bfloat16), (128, 128))
    assert ours16.dtype == torch.bfloat16
    ref16 = np.asarray(j_resize(jnp.asarray(x, jnp.bfloat16), (128, 128)),
                       np.float32)
    np.testing.assert_allclose(ours16.float().numpy(), ref16, atol=BF16_ULP_AT_1)
