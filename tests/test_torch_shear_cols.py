"""Port parity: the column shear (the y pass) and the kernels' input layouts.

The same numpy inputs go through the JAX y pass and the PyTorch port's plain
version ``shear_cols`` (CPU tensors; the CUDA kernel is checked against it on
the card by tests/test_torch_cuda.py and by chip_smoke.py). The JAX package
computes the y pass as its row shear on the transposed array: on the CPU that
is the XLA two-level blend (``_shear_pass_y``), and the Pallas kernel in
interpret mode on the swapped axes. The layout tests hold what the wrappers
accept (strided and stride-0 batches, channels as planes) against the same
call on a materialised copy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_augmented_superresolution_tpu.ops.pallas_shear import (
    candidates_for,
    shear_rows_pallas,
)
from deeplabv3plus_augmented_superresolution_tpu.ops.shear_warp import (
    _shear_pass_y,
    shear_taps as j_shear_taps,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.ops import shear_kernel
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
    paeth_rotate_translate,
    pass_shifts,
    shear_cols,
    shear_cols_dispatch,
    shear_rows,
    shear_rows_dispatch,
)

torch.set_num_threads(2)

SIZE = 64
CENTER = (SIZE - 1) / 2.0
DISPATCH = {"rows": shear_rows_dispatch, "cols": shear_cols_dispatch}


def _case(seed=0, n=3, coef=0.3, off=20.0):
    """Images and per-column shifts s = coef * (x - center) + offset whose
    arithmetic is exact in float32 (coef in 1/64ths, offset in 1/128ths), so
    both sides blend with bit-identical weights whatever their compilers fuse."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (n, SIZE, SIZE)).astype(np.float32)
    coefs = (rng.integers(-int(coef * 64), int(coef * 64) + 1, n) / 64.0).astype(np.float32)
    offs = (rng.integers(-int(off * 128), int(off * 128) + 1, n) / 128.0).astype(np.float32)
    return images, coefs, offs


def _s(coefs, offs):
    return pass_shifts(torch.from_numpy(coefs), torch.from_numpy(offs), CENTER, SIZE)


def _jax_y_pass(images, coefs, offs):
    span = j_shear_taps(0.35, SIZE)
    return _shear_pass_y(jnp.asarray(images)[..., None], jnp.asarray(coefs),
                         jnp.asarray(offs), CENTER, span, candidates_for(0.35))[..., 0]


@pytest.mark.parametrize("seed,off", [(0, 5.0), (1, 20.0), (2, 45.0)])
def test_shear_cols_matches_jax_y_pass(seed, off):
    """Same f32 2-tap arithmetic on the same exact shifts; the XLA path only
    adds exact zeros: 1e-6 for values in [0, 1]. Offsets up to 45 px push
    whole columns' ends out of the 64 px frame (zero fill at both edges)."""
    images, coefs, offs = _case(seed=seed, off=off)
    ours = shear_cols(torch.from_numpy(images), _s(coefs, offs))
    assert ours.is_contiguous()
    np.testing.assert_allclose(ours.numpy(), np.asarray(_jax_y_pass(images, coefs, offs)),
                               atol=1e-6)


def test_shear_cols_bf16_matches_pallas_interpret_on_swapped_axes():
    """bf16 input, the blend in f32, one rounding: within one bf16 ulp of the
    Pallas kernel (interpret mode) run on the swapped axes, which is how the
    JAX y pass reaches it. Values lie in [0, 1): one ulp is at most 2**-8."""
    images, coefs, offs = _case(seed=3)
    s = _s(coefs, offs)
    ref = np.asarray(jnp.swapaxes(shear_rows_pallas(
        jnp.swapaxes(jnp.asarray(images, jnp.bfloat16), 1, 2), jnp.asarray(s.numpy()),
        candidates_for(0.35), True), 1, 2)).astype(np.float32)
    ours = shear_cols(torch.from_numpy(images).to(torch.bfloat16), s)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=2.0 ** -8)


def test_shear_cols_backward_is_exact_adjoint_and_matches_jax_vjp():
    """<S x, g> == <x, S^T g> in float64 accumulation (1e-5 relative: the
    forward and the backward each round once in f32), and S^T g equals
    jax.vjp of the JAX y pass (its custom VJP is the shift by -s; 1e-6)."""
    images, coefs, offs = _case(seed=4, off=30.0)
    g = np.random.default_rng(5).standard_normal(images.shape).astype(np.float32)
    x = torch.from_numpy(images).requires_grad_(True)
    y = shear_cols_dispatch(x, _s(coefs, offs))
    (xt_g,) = torch.autograd.grad(y, x, torch.from_numpy(g))
    lhs = float(np.sum(y.detach().numpy().astype(np.float64) * g))
    rhs = float(np.sum(images.astype(np.float64) * xt_g.numpy()))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)

    _, vjp = jax.vjp(lambda im: _jax_y_pass(im, coefs, offs), jnp.asarray(images))
    np.testing.assert_allclose(xt_g.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-6)


def test_shear_cols_nearest_selects_input_values():
    """Rounded shifts make the lerp a selection: every output value is an
    input value or the fill."""
    labels = np.zeros((2, SIZE, SIZE), np.float32)
    labels[:, 20:40, 10:50] = 8.0
    labels[:, 18:20, 8:52] = 255.0
    coefs = np.array([0.27, -0.31], np.float32)
    offs = np.array([7.3, -9.6], np.float32)
    s = pass_shifts(torch.from_numpy(coefs), torch.from_numpy(offs), CENTER, SIZE,
                    "nearest")
    out = shear_cols(torch.from_numpy(labels), s).numpy()
    assert set(np.unique(out)) <= {0.0, 8.0, 255.0}
    assert (out == 255.0).any() and (out == 8.0).any()


@pytest.mark.parametrize("axis", ["rows", "cols"])
def test_expanded_input_equals_its_materialised_copy(axis):
    """A stride-0 batch (one image expanded over the copies) gives the same
    values as the copied batch, bit for bit, and the gradient with respect to
    the one image is the copies' gradients summed (autograd's expand backward;
    1e-5: the sum over 4 copies is taken in another order)."""
    images, coefs, offs = _case(seed=6, n=4)
    s = _s(coefs, offs)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4, SIZE, SIZE)).astype(np.float32))
    one = torch.from_numpy(images[0]).requires_grad_(True)
    expanded = one[None].expand(4, SIZE, SIZE)
    assert expanded.stride(0) == 0
    out = DISPATCH[axis](expanded, s)
    (grad,) = torch.autograd.grad(out, one, g)

    copied = torch.from_numpy(images[0])[None].repeat(4, 1, 1).requires_grad_(True)
    ref = DISPATCH[axis](copied, s)
    (ref_grad,) = torch.autograd.grad(ref, copied, g)
    assert out.is_contiguous() and tuple(out.shape) == (4, SIZE, SIZE)
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    assert tuple(grad.shape) == (SIZE, SIZE)
    np.testing.assert_allclose(grad.numpy(), ref_grad.sum(0).numpy(), atol=1e-5)


@pytest.mark.parametrize("axis", ["rows", "cols"])
def test_channels_as_planes_share_the_copy_shift(axis):
    """(N, C, H, W) input: the C planes of a copy take the copy's shift, as
    the (N * C, H, W) call with the shifts repeated; a batch-strided view
    (every second copy of a larger array) and an expanded (C, H, W) image are
    taken as they are."""
    rng = np.random.default_rng(8)
    big = torch.from_numpy(rng.uniform(0, 1, (6, 2, SIZE, SIZE)).astype(np.float32))
    _, coefs, offs = _case(seed=9, n=3)
    s = _s(coefs, offs)
    strided = big[::2]
    assert not strided.is_contiguous()
    out = DISPATCH[axis](strided, s)
    flat = DISPATCH[axis](strided.reshape(6, SIZE, SIZE),
                          s.repeat_interleave(2, dim=0))
    assert out.is_contiguous() and tuple(out.shape) == (3, 2, SIZE, SIZE)
    np.testing.assert_array_equal(out.numpy(), flat.reshape(3, 2, SIZE, SIZE).numpy())

    expanded = big[0][None].expand(3, 2, SIZE, SIZE)
    np.testing.assert_array_equal(DISPATCH[axis](expanded, s).numpy(),
                                  DISPATCH[axis](expanded.contiguous(), s).numpy())


@pytest.mark.parametrize("channels", [1, 3])
def test_paeth_on_an_expanded_batch_equals_the_copied_batch(channels):
    """The copies warp hands an expanded image to the first pass without
    copying it: same values as the warp of the materialised batch, and the
    image's gradient is the sum over the copies (1e-5, summation order)."""
    rng = np.random.default_rng(10 + channels)
    image = torch.from_numpy(rng.uniform(0, 1, (SIZE, SIZE, channels)).astype(np.float32))
    angles = torch.from_numpy(rng.uniform(-0.3, 0.3, 3).astype(np.float32))
    shifts = torch.from_numpy(rng.uniform(-8, 8, (3, 2)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, SIZE, SIZE, channels)).astype(np.float32))
    one = image.clone().requires_grad_(True)
    out = paeth_rotate_translate(one[None].expand(3, SIZE, SIZE, channels), angles, shifts)
    (grad,) = torch.autograd.grad(out, one, g)
    copied = image[None].repeat(3, 1, 1, 1).requires_grad_(True)
    ref = paeth_rotate_translate(copied, angles, shifts)
    (ref_grad,) = torch.autograd.grad(ref, copied, g)
    assert tuple(out.shape) == (3, SIZE, SIZE, channels)
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    np.testing.assert_allclose(grad.numpy(), ref_grad.sum(0).numpy(), atol=1e-5)


def _images(shape=(3, SIZE, SIZE)):
    return torch.zeros(shape)


@pytest.mark.parametrize("name,images,s,axis", [
    ("contiguous", _images(), torch.zeros(3, SIZE), "rows"),
    ("stride-0 batch", _images((SIZE, SIZE))[None].expand(3, SIZE, SIZE),
     torch.zeros(3, SIZE), "rows"),
    ("strided batch", _images((6, SIZE, SIZE))[::2], torch.zeros(3, SIZE), "cols"),
    ("odd batch stride", _images((3, SIZE * SIZE + 3))[:, :SIZE * SIZE]
     .unflatten(1, (SIZE, SIZE)), torch.zeros(3, SIZE), "rows"),
    ("expanded planes", _images((2, SIZE, 48))[None].expand(3, 2, SIZE, 48),
     torch.zeros(3, 48), "cols"),
    ("bfloat16", _images().to(torch.bfloat16), torch.zeros(3, SIZE), "cols"),
])
def test_check_args_accepts(name, images, s, axis):
    shear_kernel.check_args(images, s, axis)


@pytest.mark.parametrize("name,images,s,axis,error,match", [
    ("transposed planes", _images().transpose(1, 2), torch.zeros(3, SIZE), "rows",
     ValueError, "contiguous"),
    ("strided last dimension", _images((3, SIZE, 2 * SIZE))[..., ::2],
     torch.zeros(3, SIZE), "cols", ValueError, "contiguous"),
    ("row gaps", _images((3, SIZE, 2 * SIZE))[..., :SIZE], torch.zeros(3, SIZE), "rows",
     ValueError, "contiguous"),
    ("s of the other axis", _images((3, SIZE, 48)), torch.zeros(3, SIZE), "cols",
     ValueError, "s must be"),
    ("s per plane, not per copy", _images((3, 2, SIZE, SIZE)), torch.zeros(6, SIZE),
     "rows", ValueError, "s must be"),
    ("two dimensions", _images((SIZE, SIZE)), torch.zeros(SIZE), "rows",
     ValueError, "images must be"),
    ("float16", _images().half(), torch.zeros(3, SIZE), "rows", TypeError, "float16"),
    ("float64 shifts", _images(), torch.zeros(3, SIZE).double(), "cols",
     TypeError, "s must be float32"),
    ("strided shifts", _images(), torch.zeros(3, 2 * SIZE)[:, ::2], "rows",
     ValueError, "s must be contiguous"),
    ("mixed devices", _images(), torch.zeros(3, SIZE, device="meta"), "rows",
     ValueError, "but s on"),
    ("unknown axis", _images(), torch.zeros(3, SIZE), "diagonal", ValueError, "axis"),
])
def test_check_args_rejects(name, images, s, axis, error, match):
    with pytest.raises(error, match=match):
        shear_kernel.check_args(images, s, axis)


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback inside the wrappers: a CPU tensor never reaches a kernel
    and never takes the plain version there."""
    for wrapper in (shear_kernel.shear_rows_cuda, shear_kernel.shear_cols_cuda):
        before = wrapper.launches
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(_images(), torch.zeros(3, SIZE))
        assert wrapper.launches == before
    # shear_rows on 4-D planes is the 3-D call on the folded planes.
    x = torch.rand((2, 3, 8, 16), generator=torch.Generator().manual_seed(0))
    s = torch.linspace(-3.0, 3.0, 16).reshape(2, 8)
    np.testing.assert_array_equal(
        shear_rows(x, s).numpy(),
        shear_rows(x.reshape(6, 8, 16), s.repeat_interleave(3, dim=0))
        .reshape(2, 3, 8, 16).numpy())
