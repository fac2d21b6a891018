"""Port parity: the fused warp+downsample operator and the Gram stencil.

The same numpy target, angles and shifts go through the JAX functions and
the PyTorch port (plain shear on CPU tensors). The port's adjoint comes from
autograd through the shear Function; the reference's from jax.vjp.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_augmented_superresolution_tpu.ops.fused_operator import (
    fused_warp_downsample as j_fused,
)
from deeplabv3plus_augmented_superresolution_tpu.ops.gram import (
    extract_gram_stencil_aliased as j_extract_aliased,
)
from deeplabv3plus_augmented_superresolution_tpu.ops.resize import resize as j_resize
from deeplabv3plus_augmented_superresolution_tpu.sr import (
    OptimizerConfig as JOptimizerConfig,
    SRConfig as JSRConfig,
    forward_operator as j_forward_operator,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.fused_operator import (
    fused_warp_downsample,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.gram import (
    apply_gram,
    extract_gram_stencil,
    extract_gram_stencil_aliased,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.resize import resize
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
    paeth_rotate_translate,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
    OptimizerConfig,
    SRConfig,
    forward_operator,
    precompute_gram_stencil,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.sr.solver import _normal_op
from test_torch_shear import run_fast

torch.set_num_threads(1)


def _smooth(h, seed):
    rng = np.random.default_rng(seed)
    low = rng.uniform(0, 1, (1, h // 16, h // 16, 1)).astype(np.float32)
    return np.array(j_resize(jnp.asarray(low), (h, h)))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_fused_operator_matches_jax():
    """Three shifts and two f32 decimation matmuls on both sides; the trig of
    the offsets differs by an f32 ulp, which moves tap weights by ~1e-5 at
    30 px shifts: 2e-5 on unit-scale images."""
    img = _smooth(128, 0)
    rng = np.random.default_rng(1)
    angles = rng.uniform(-0.25, 0.25, 6).astype(np.float32)
    shifts = rng.uniform(-15, 15, (6, 2)).astype(np.float32)
    ours = fused_warp_downsample(*_t(img, angles, shifts), (32, 32), 0.3)
    ref = np.asarray(j_fused(jnp.asarray(img), jnp.asarray(angles),
                             jnp.asarray(shifts), (32, 32), 0.3))
    assert ours.shape == (6, 32, 32, 1)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)


def test_fused_operator_at_production_extremes():
    """512 px, angle_max 0.5, shifts +-80 (tests/test_fused_operator.py:53):
    pass-B offsets reach ~170 px. The port matches the JAX fused operator
    (1e-4: 170 px shifts carry f32 offset rounding of ~1e-5 px per pass), and
    the staged composition (paeth warp then resize) in the interior as the
    reference's own test requires (max 0.06, mean 0.01)."""
    img = _smooth(512, 4)
    angles = np.asarray([0.0, 0.45, -0.45, 0.49, 0.30, -0.30], np.float32)
    shifts = np.asarray([[0, 0], [78, 75], [-78, -75], [80, -80],
                         [-60, 70], [55, -65]], np.float32)
    ta, tsh = _t(angles, shifts)
    fused = fused_warp_downsample(torch.from_numpy(img), ta, tsh, (128, 128), 0.5)
    ref = np.asarray(j_fused(jnp.asarray(img), jnp.asarray(angles),
                             jnp.asarray(shifts), (128, 128), 0.5))
    np.testing.assert_allclose(fused.numpy(), ref, atol=1e-4)

    big = torch.from_numpy(img).expand(6, 512, 512, 1)
    staged = resize(paeth_rotate_translate(big, ta, tsh, 0.5), (128, 128))
    err = (fused - staged).abs()[:, 16:112, 16:112]
    assert float(err.max()) < 0.06 and float(err.mean()) < 0.01


def test_fused_operator_adjoint_identity():
    """<A x, y> == <x, A^T y>, A^T through autograd: 1e-5 relative (f32
    forward and backward chains, float64 inner products)."""
    img = _smooth(64, 2)
    rng = np.random.default_rng(3)
    angles = rng.uniform(-0.3, 0.3, 4).astype(np.float32)
    shifts = rng.uniform(-6, 6, (4, 2)).astype(np.float32)
    y = rng.standard_normal((4, 16, 16, 1)).astype(np.float32)
    ta, tsh, ty = _t(angles, shifts, y)
    x = torch.from_numpy(img).requires_grad_(True)
    ax = fused_warp_downsample(x, ta, tsh, (16, 16), 0.3)
    (aty,) = torch.autograd.grad(ax, x, ty)
    lhs = float((ax.detach().double() * ty.double()).sum())
    rhs = float((x.detach().double() * aty.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def _gram_setup(n=6, seed=4):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-0.25, 0.25, n).astype(np.float32)
    shifts = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    angles[0], shifts[0] = 0.0, 0.0
    kw = dict(num_aug=n, feature_size=(16, 16), output_size=(64, 64),
              angle_max=0.3, num_iter=10, solver_impl="gram")
    return (angles, shifts, SRConfig(**kw, optimizer=OptimizerConfig()),
            JSRConfig(**kw, optimizer=JOptimizerConfig()))


def test_aliased_stencil_matches_jax():
    """precompute_gram_stencil (35 aliased probes) vs the reference's aliased
    extraction on its own operator: 1e-5 of the coefficient scale (f32 chains
    and the cumulative sums of the disentangling, as tests/test_gram.py)."""
    angles, shifts, cfg, jcfg = _gram_setup()

    def j_normal_op(x):
        out, vjp = jax.vjp(lambda z: j_forward_operator(
            z, jnp.asarray(angles), jnp.asarray(shifts), jcfg.feature_size, jcfg), x)
        return vjp(out)[0]

    # jitted: one compile for the 35 probes and the disentangling
    ref = np.asarray(run_fast(jax.jit(lambda: j_extract_aliased(j_normal_op,
                                                                jcfg.output_size))))
    ours = precompute_gram_stencil(*_t(angles, shifts), cfg).numpy()
    assert ours.shape == ref.shape == (7, 9, 64, 64)
    np.testing.assert_allclose(ours, ref, atol=1e-5 * np.abs(ref).max())


def test_stencil_apply_equals_normal_operator():
    """apply_gram(x) == A^T A x through autograd (2e-4 of the scale, the
    reference's bound for the aliased extraction); dense and aliased
    extraction give the same coefficients (1e-5 of the scale)."""
    angles, shifts, cfg, _ = _gram_setup(n=5, seed=8)
    ta, tsh = _t(angles, shifts)
    normal_op = _normal_op(lambda z: forward_operator(z, ta, tsh, cfg.feature_size, cfg))
    aliased = extract_gram_stencil_aliased(normal_op, (64, 64), device="cpu")
    dense = extract_gram_stencil(normal_op, (64, 64), device="cpu")
    np.testing.assert_allclose(aliased.numpy(), dense.numpy(),
                               atol=1e-5 * float(dense.abs().max()))
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 1))
                         .astype(np.float32))
    direct = normal_op(x)
    scale = float(direct.abs().max())
    np.testing.assert_allclose(apply_gram(x, aliased).numpy(), direct.numpy(),
                               atol=2e-4 * scale)


def test_forward_operator_is_the_fused_path():
    """forward_operator with the serving config is the fused operator (the
    same JAX parity, 2e-5); the staged operator and the gather warp are
    other paths (held against JAX in tests/test_torch_warp.py): the staged
    shear operator stays within the fused one's interior bound of
    test_fused_operator_at_production_extremes; with aug-axis padding
    (num_valid) the operator is the same: every copy is applied, and the
    data terms weight the padded ones 0."""
    angles, shifts, _, _ = _gram_setup(n=3)
    kw = dict(num_aug=3, feature_size=(16, 16), output_size=(64, 64), angle_max=0.3)
    img = _smooth(64, 5)
    ours = forward_operator(*_t(img, angles, shifts), (16, 16), SRConfig(**kw))
    ref = np.asarray(j_forward_operator(jnp.asarray(img), jnp.asarray(angles),
                                        jnp.asarray(shifts), (16, 16), JSRConfig(**kw)))
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)
    staged = forward_operator(*_t(img, angles, shifts), (16, 16),
                              SRConfig(**kw, operator_impl="staged"))
    err = (staged - ours).abs()[:, 2:14, 2:14]
    assert float(err.max()) < 0.06 and float(err.mean()) < 0.01
    gather = SRConfig(**kw, warp_impl="gather")
    torch.testing.assert_close(
        forward_operator(*_t(img, angles, shifts), (16, 16),
                         dataclasses.replace(gather, num_valid=2)),
        forward_operator(*_t(img, angles, shifts), (16, 16), gather), rtol=0, atol=0)
