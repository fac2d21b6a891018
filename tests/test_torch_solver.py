"""Port parity: the optimizer, the regularizers, the OPMs, the Gram solve and
the threshold.

The same numpy inputs go through the JAX functions and the PyTorch port.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deeplabv3plus_augmented_superresolution_tpu.ops import gradients as j_grad
from deeplabv3plus_augmented_superresolution_tpu.ops.opm import (
    extract_masks as j_extract_masks,
    prepare_sr_inputs as j_prepare,
)
from deeplabv3plus_augmented_superresolution_tpu.sr import (
    OptimizerConfig as JOptimizerConfig,
    SRConfig as JSRConfig,
    augmented_superresolution as j_asr,
    forward_operator as j_forward_operator,
    make_optimizer,
    stencil_cache_key as j_stencil_cache_key,
    threshold_image as j_threshold,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.ops import gradients
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.opm import (
    extract_masks,
    prepare_sr_inputs,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
    Adam,
    OptimizerConfig,
    SRConfig,
    augmented_superresolution,
    load_stencil,
    make_optimizer as make_port_optimizer,
    save_stencil,
    stencil_cache_key,
    threshold_image,
)
from test_torch_shear import run_fast

torch.set_num_threads(1)


SERVING = dict(learning_rate=1e-3, amsgrad=True, lr_scheduler=True,
               decay_steps=60, decay_rate=0.3)


@pytest.mark.parametrize("opt_kw", [
    SERVING,                                                   # the serving AMSGrad
    dict(learning_rate=5e-2, amsgrad=False, lr_scheduler=False),  # plain Adam
    dict(learning_rate=2e-2, amsgrad=True, lr_scheduler=False),
], ids=["amsgrad-serving-schedule", "adam", "amsgrad-constant-lr"])
def test_optimizer_matches_optax_over_300_steps(opt_kw):
    """300 steps on a quadratic-plus-TV objective whose gradient both sides
    compute in the same f32 ops. The update is optax's (max over the
    bias-corrected nu; lr0 * rate^(k/60) from k = 0); the trajectories agree
    to 1e-5 after 300 steps (f32 rounding of the host-side scalars)."""
    rng = np.random.default_rng(0)
    x0 = rng.uniform(0, 1, (1, 16, 16, 1)).astype(np.float32)
    w = rng.uniform(0.1, 3.0, x0.shape).astype(np.float32)
    c = rng.uniform(-1, 1, x0.shape).astype(np.float32)

    jcfg = JOptimizerConfig(**opt_kw)
    opt = make_optimizer(jcfg)

    def jgrad(x):
        return w * (x - c) + 0.3 * jax.grad(j_grad.total_variation)(x)

    def jstep(carry, _):
        x, state = carry
        updates, state = opt.update(jgrad(x), state, x)
        return (optax.apply_updates(x, updates), state), None

    x_j = jnp.asarray(x0)
    (x_j, _), _ = jax.lax.scan(jstep, (x_j, opt.init(x_j)), None, length=300)

    tw, tc = torch.from_numpy(w), torch.from_numpy(c)
    x_t = torch.from_numpy(x0)
    adam = Adam(OptimizerConfig(**opt_kw), x_t)
    for _ in range(300):
        z = x_t.clone().requires_grad_(True)
        (tv_grad,) = torch.autograd.grad(gradients.total_variation(z), z)
        x_t = adam.step(x_t, tw * (x_t - tc) + 0.3 * tv_grad)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-5)


def test_optimizer_rejects_unported_names():
    """Every name of the reference is ported (test_torch_solvers holds each
    against optax); an unknown name raises, and so does a config whose name
    is not the class's."""
    with pytest.raises(ValueError, match="rmsprop"):
        make_port_optimizer(OptimizerConfig(name="rmsprop"), torch.zeros(3))
    with pytest.raises(ValueError, match="sgd"):
        Adam(OptimizerConfig(name="sgd"), torch.zeros(3))


def test_tv_and_btv_values_and_gradients_match_jax():
    """Mask-like input with many exactly equal neighbours, where the
    derivative of |.| at 0 decides the gradient: jax's is +1 (its abs JVP
    passes the tangent where x >= 0), and the port follows it. f32 sums over
    1024 terms: 1e-4 relative on the values, 1e-6 on the gradients."""
    rng = np.random.default_rng(1)
    x = (rng.uniform(0, 1, (1, 32, 32, 1)) > 0.6).astype(np.float32)
    x[0, 10:20, 10:20] = 0.5
    for j_fn, fn in ((j_grad.total_variation, gradients.total_variation),
                     (j_grad.bilateral_tv, gradients.bilateral_tv)):
        jv, jg = run_fast(jax.jit(jax.value_and_grad(j_fn)), jnp.asarray(x))
        z = torch.from_numpy(x).requires_grad_(True)
        v = fn(z)
        (g,) = torch.autograd.grad(v, z)
        np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)


@pytest.mark.parametrize("mode", ["argmax", "slice", "slice_max"])
@pytest.mark.parametrize("global_normalize", [True, False])
def test_opm_modes_match_jax(mode, global_normalize):
    """extract_masks + prepare_sr_inputs: argmax masks exactly; the min-max
    normalizations to f32 rounding (1e-6)."""
    rng = np.random.default_rng(2)
    preds = rng.standard_normal((4, 8, 8, 21)).astype(np.float32)
    preds[..., 8] += 1.0  # class 8 wins somewhere
    jm, jmax = j_prepare(*j_extract_masks(jnp.asarray(preds), 8, mode), mode,
                         global_normalize)
    m, mx = prepare_sr_inputs(*extract_masks(torch.from_numpy(preds), 8, mode), mode,
                              global_normalize)
    assert m.shape == (4, 8, 8, 1) and m.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-6)
    assert (mx is None) == (jmax is None)
    if mx is not None:
        np.testing.assert_allclose(mx.numpy(), np.asarray(jmax), atol=1e-6)


def test_threshold_image_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (32, 32, 1)).astype(np.float32)
    other = rng.uniform(0, 1, (32, 32, 1)).astype(np.float32)
    for kw_j, kw_t in (({"th_factor": 0.5}, {"th_factor": 0.5}),
                       ({"th_mask": jnp.asarray(other)},
                        {"th_mask": torch.from_numpy(other)})):
        ref = np.asarray(j_threshold(jnp.asarray(img), 8, **kw_j), np.float32)
        ours = threshold_image(torch.from_numpy(img), 8, **kw_t)
        assert ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(), ref)


def test_gram_solve_matches_jax():
    """augmented_superresolution(solver_impl='gram') with the serving optimizer
    (AMSGrad, lr 1e-3 decaying 0.3 per 60 steps, 300 steps), stencil
    extracted inline, on masks from the reference operator. Adam normalizes
    each step, so where the gradient cancels to ~0 the f32 rounding of either
    side picks the step's sign: up to lr per step at such pixels. Hence max
    5e-3 (the reference's own gram-vs-direct test allows 1.5e-2), mean 1e-4,
    and the final loss to 1e-4 relative."""
    n = 6
    rng = np.random.default_rng(4)
    angles = rng.uniform(-0.25, 0.25, n).astype(np.float32)
    shifts = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    angles[0], shifts[0] = 0.0, 0.0
    kw = dict(num_aug=n, feature_size=(16, 16), output_size=(64, 64),
              angle_max=0.3, num_iter=300, solver_impl="gram")
    jcfg = JSRConfig(**kw, optimizer=JOptimizerConfig(**SERVING))
    cfg = SRConfig(**kw, optimizer=OptimizerConfig(**SERVING))
    gt = np.zeros((1, 64, 64, 1), np.float32)
    gt[0, 20:44, 16:48] = 1.0
    masks = np.array(run_fast(jax.jit(lambda g, a, s: j_forward_operator(g, a, s, (16, 16),
                                                                         jcfg)),
                              jnp.asarray(gt), jnp.asarray(angles), jnp.asarray(shifts)))
    ref, ref_loss = run_fast(j_asr, jnp.asarray(masks), jnp.asarray(angles),
                             jnp.asarray(shifts), cfg=jcfg)
    ours, loss = augmented_superresolution(torch.from_numpy(masks),
                                           torch.from_numpy(angles),
                                           torch.from_numpy(shifts), cfg)
    assert ours.shape == (64, 64, 1)
    err = np.abs(ours.numpy() - np.asarray(ref))
    assert err.max() <= 5e-3 and err.mean() <= 1e-4, (err.max(), err.mean())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    with pytest.raises(ValueError, match="solver_impl"):
        augmented_superresolution(torch.from_numpy(masks), torch.from_numpy(angles),
                                  torch.from_numpy(shifts),
                                  dataclasses.replace(cfg, solver_impl="newton"))


def test_stencil_cache_is_tagged_and_roundtrips(tmp_path):
    """The port's key differs from the reference's for the same TTA set and
    config, so neither side loads the other's stencil."""
    angles = np.linspace(-0.1, 0.1, 4).astype(np.float32)
    shifts = np.ones((4, 2), np.float32)
    kw = dict(num_aug=4, feature_size=(16, 16), output_size=(64, 64))
    assert stencil_cache_key(angles, shifts, SRConfig(**kw)) != \
        j_stencil_cache_key(angles, shifts, JSRConfig(**kw))
    coeffs = np.random.default_rng(0).standard_normal((7, 9, 64, 64)).astype(np.float32)
    assert load_stencil(str(tmp_path), angles, shifts, SRConfig(**kw)) is None
    save_stencil(str(tmp_path), angles, shifts, SRConfig(**kw), coeffs)
    np.testing.assert_array_equal(load_stencil(str(tmp_path), angles, shifts,
                                               SRConfig(**kw)), coeffs)
