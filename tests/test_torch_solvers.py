"""Port parity: the direct solver (full copies, copy minibatching, copy
dropout), IRLS-CG and every optimizer.

The same numpy masks, angles and shifts go through the JAX package and the
PyTorch port (plain versions on the CPU). The RNG streams differ, so the
minibatch order and the dropout mask that JAX draws from its key are handed
to the port (``solve_with_draws``). 24 px targets, 6 copies at factor 4,
10 steps; each jitted JAX reference is computed once per module (the
target size keeps their compiles, the bulk of this file's time, short).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_augmented_superresolution_tpu.sr import (
    OptimizerConfig as JOptimizerConfig,
    SRConfig as JSRConfig,
    augmented_superresolution as j_asr,
    make_optimizer as j_make_optimizer,
)
from deeplabv3plus_augmented_superresolution_tpu.sr.solver import (
    _dropout_weights as j_dropout_weights,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.gradients import total_variation
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.gram import apply_gram
from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
    OPTIMIZERS,
    OptimizerConfig,
    SRConfig,
    augmented_superresolution,
    dropout_weights,
    forward_operator,
    make_optimizer,
    minibatch_permutation,
    precompute_gram_stencil,
    solve_with_draws,
    sr_loss,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.sr.solver import _gram_system
from test_torch_shear import FAST_COMPILE, run_fast

torch.set_num_threads(1)


N = 6
SERVING = dict(learning_rate=1e-3, amsgrad=True, lr_scheduler=True, decay_steps=60,
               decay_rate=0.3)
BASE = dict(num_aug=N, feature_size=(6, 6), output_size=(24, 24), angle_max=0.3,
            num_iter=10)
MINIBATCH = dict(sgd_copies=4, copy_dropout=0.34)   # windows of 4 of 6; 2 dropped
CG = dict(solver_impl="cg", cg_outer=2, cg_inner=5)


def _configs(**kw):
    return (JSRConfig(**BASE, optimizer=JOptimizerConfig(**SERVING), **kw),
            SRConfig(**BASE, optimizer=OptimizerConfig(**SERVING), **kw))


def _tta():
    rng = np.random.default_rng(4)
    angles = rng.uniform(-0.25, 0.25, N).astype(np.float32)
    shifts = rng.uniform(-3, 3, (N, 2)).astype(np.float32)
    angles[0], shifts[0] = 0.0, 0.0
    return angles, shifts


def _masks(k):
    """(k, N, 6, 6, 1) LR observations of k rectangles through the port's
    operator, with noise so that the copies disagree as model masks do."""
    angles, shifts = _tta()
    gt = np.zeros((k, 24, 24), np.float32)
    for i in range(k):
        gt[i, 5 + 2 * i:17 + i, 4 + 2 * i:19 - i] = 1.0
    _, cfg = _configs(solver_impl="direct")
    lr = forward_operator(torch.from_numpy(gt), torch.from_numpy(angles),
                          torch.from_numpy(shifts), (6, 6), cfg)     # (N, 6, 6, k)
    noise = np.random.default_rng(5).uniform(-0.1, 0.1, (k, N, 6, 6, 1))
    return (lr.permute(3, 0, 1, 2)[..., None].numpy() + noise).astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    angles, shifts = _tta()
    return _masks(1)[0], angles, shifts


@pytest.fixture(scope="module")
def stencil(problem):
    """The problem's Gram stencil, handed to both CG solves, so that they
    compare the CG iteration itself (the extraction is held against the
    reference's in test_torch_operator.py)."""
    _, angles, shifts = problem
    _, cfg = _configs(**CG)
    return precompute_gram_stencil(torch.from_numpy(angles), torch.from_numpy(shifts),
                                   cfg).numpy()


@pytest.fixture(scope="module")
def jax_refs(problem, stencil):
    """The JAX solves, jitted once each: direct on every copy; direct on
    minibatches with dropout (key 1), with the key's draws; IRLS-CG on the
    given stencil."""
    masks, angles, shifts = (jnp.asarray(a) for a in problem)
    key = jax.random.key(1)
    jcfg_mb, _ = _configs(solver_impl="direct", **MINIBATCH)
    return {
        "direct": run_fast(j_asr, masks, angles, shifts,
                           cfg=_configs(solver_impl="direct")[0]),
        "minibatch": j_asr.lower(masks, angles, shifts, cfg=jcfg_mb, dropout_key=key)
                          .compile(FAST_COMPILE)(masks, angles, shifts, dropout_key=key),
        "perm": np.array(jax.random.permutation(jax.random.fold_in(key, 997), N)),
        "weights": np.array(j_dropout_weights(key, jcfg_mb)),
        "cg": j_asr.lower(masks, angles, shifts, cfg=_configs(**CG)[0],
                          gram_coeffs=jnp.asarray(stencil))
                   .compile(FAST_COMPILE)(masks, angles, shifts,
                                          gram_coeffs=jnp.asarray(stencil)),
    }


def _check(ours, ref, max_err, mean_err, loss_rtol):
    x, loss = ours
    err = np.abs(x.numpy() - np.asarray(ref[0]))
    assert x.shape == (24, 24, 1)
    assert err.max() <= max_err and err.mean() <= mean_err, (err.max(), err.mean())
    np.testing.assert_allclose(float(loss), float(ref[1]), rtol=loss_rtol)


def test_direct_solver_matches_jax(problem, jax_refs):
    """solver_impl='direct' on all 6 copies, 10 serving AMSGrad steps, the
    operator differentiated by autograd every step. Bounds of the gram
    test (tests/test_torch_solver.py): Adam's normalized steps can take
    either sign where the gradient cancels, so max 5e-3, mean 1e-4, and the
    last step's loss to 1e-4 relative. A given stencil raises: this solver
    reads none."""
    _, cfg = _configs(solver_impl="direct")
    masks, angles, shifts = (torch.from_numpy(a) for a in problem)
    _check(augmented_superresolution(masks, angles, shifts, cfg), jax_refs["direct"],
           5e-3, 1e-4, 1e-4)
    with pytest.raises(ValueError, match="gram_coeffs"):
        augmented_superresolution(masks, angles, shifts, cfg,
                                  gram_coeffs=torch.zeros(7, 9, 24, 24))


def test_minibatch_and_dropout_match_jax(problem, jax_refs):
    """sgd_copies=4 of 6 (windows that wrap through the duplicated head, the
    data term scaled by 6/4) with copy_dropout 0.34 (2 copies weighted 0),
    JAX's permutation and weights handed in. Bounds as the direct test. The
    draws matter: the result differs from the full-copy solve by more than
    the bound."""
    _, cfg = _configs(solver_impl="direct", **MINIBATCH)
    weights, perm = jax_refs["weights"], jax_refs["perm"]
    assert sorted(weights.tolist()) == [0, 0, 1, 1, 1, 1]
    masks, angles, shifts = (torch.from_numpy(a) for a in problem)
    ours = solve_with_draws(masks, angles, shifts, cfg,
                            copy_weights=torch.from_numpy(weights),
                            perm=torch.from_numpy(perm))
    _check(ours, jax_refs["minibatch"], 5e-3, 1e-4, 1e-4)
    full = np.asarray(jax_refs["direct"][0])
    assert np.abs(ours[0].numpy() - full).max() > 5e-3
    # The public entry draws its own mask and order from a generator: 2 zeros.
    gen = torch.Generator().manual_seed(0)
    assert int((dropout_weights(gen, cfg) == 0).sum()) == 2
    assert sorted(minibatch_permutation(gen, N).tolist()) == list(range(N))


def test_cg_matches_jax_and_classes_do_not_couple(problem, stencil, jax_refs):
    """IRLS-CG (2 reweightings x 5 CG steps) on one stencil against the
    reference's _cg_solve: CG has no normalized steps, so the f32 rounding of either
    side stays small: 1e-4 on values in [0, 1], mean 1e-6, objective 1e-5
    relative. Three classes at once equal three single solves: the targets
    exactly (every inner product is per class), the objectives to 1e-6
    relative (their sums run over a stack). use_BTV raises as in the
    reference."""
    _, cfg = _configs(**CG)
    masks, angles, shifts = (torch.from_numpy(a) for a in problem)
    coeffs = torch.from_numpy(stencil)
    _check(augmented_superresolution(masks, angles, shifts, cfg, gram_coeffs=coeffs),
           jax_refs["cg"], 1e-4, 1e-6, 1e-5)
    stack = torch.from_numpy(_masks(3))
    together, losses = augmented_superresolution(stack, angles, shifts, cfg,
                                                 gram_coeffs=coeffs)
    assert together.shape == (3, 24, 24, 1) and losses.shape == (3,)
    for k in range(3):
        alone, loss = augmented_superresolution(stack[k], angles, shifts, cfg,
                                                gram_coeffs=coeffs)
        torch.testing.assert_close(together[k], alone, rtol=0, atol=0)
        torch.testing.assert_close(losses[k], loss, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="use_BTV"):
        augmented_superresolution(masks, angles, shifts,
                                  dataclasses.replace(cfg, use_BTV=True))


def test_gram_system_folds_in_copy_weights(problem):
    """The weighted normal equations equal the weighted direct objective:
    2 (G x - b) from the stencil extracted with 0/1 copy weights is the
    autograd gradient of sum_i w_i |A_i x - y_i|^2 (2.5e-4 of its scale, the
    stencil bound of chip_smoke), and the two objectives' values agree to
    1e-4 relative, sr_loss's too. A precomputed stencil with copy dropout
    raises, as in the reference."""
    _, cfg = _configs(solver_impl="gram", copy_dropout=0.34)
    masks, angles, shifts = (torch.from_numpy(a) for a in problem)
    weights = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
    x = torch.rand((1, 24, 24, 1), generator=torch.Generator().manual_seed(2))
    coeffs, b, y_const = _gram_system(x, masks[None], angles, shifts, cfg, None, weights)
    z = x.clone().requires_grad_(True)
    lr_est = forward_operator(z[..., 0], angles, shifts, cfg.feature_size, cfg)
    df = (torch.square(lr_est - masks)
          * weights[:, None, None, None]).sum()
    (want,) = torch.autograd.grad(df, z)
    got = 2.0 * (apply_gram(x, coeffs) - b)
    assert float((got - want).abs().max()) <= 2.5e-4 * float(want.abs().max())
    direct_value = float(df.detach())
    gram_value = float((x * apply_gram(x, coeffs)).sum() - 2 * (x * b).sum() + y_const[0])
    assert gram_value == pytest.approx(direct_value, rel=1e-4)
    reg = 0.3 * float(total_variation(x)) + 0.7 * float((x * x).sum())
    loss = sr_loss(x, masks, angles, shifts, cfg, copy_weights=weights)
    assert loss.shape == () and float(loss) == pytest.approx(direct_value + reg, rel=1e-5)
    with pytest.raises(ValueError, match="copy_dropout"):
        _gram_system(x, masks[None], angles, shifts, cfg, coeffs, weights)


@pytest.mark.parametrize("opt_kw", [
    dict(name="adam", learning_rate=5e-2, amsgrad=True),
    dict(name="adam", learning_rate=5e-2),
    dict(name="adamax", learning_rate=5e-2),
    dict(name="adagrad", learning_rate=2e-1),
    dict(name="adadelta", learning_rate=5.0),
    dict(name="sgd", learning_rate=1e-1),
    dict(name="sgd", learning_rate=1e-1, momentum=0.9, nesterov=True),
    dict(name="sgd", learning_rate=1e-1, momentum=0.5),
], ids=["amsgrad", "adam", "adamax", "adagrad", "adadelta", "sgd", "sgd-nesterov",
        "sgd-momentum"])
def test_optimizer_matches_optax_over_20_steps(opt_kw):
    """20 steps with the decaying schedule (every 5 steps by 0.3) on a
    quadratic whose gradient both sides compute in the same f32 ops: the
    port's update is optax's (make_optimizer of the JAX package) to 1e-6."""
    kw = dict(lr_scheduler=True, decay_steps=5, decay_rate=0.3, **opt_kw)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(0, 1, (1, 8, 8, 1)).astype(np.float32)
    w = rng.uniform(0.1, 3.0, x0.shape).astype(np.float32)
    c = rng.uniform(-1, 1, x0.shape).astype(np.float32)

    opt = j_make_optimizer(JOptimizerConfig(**kw))
    x_j = jnp.asarray(x0)
    state = opt.init(x_j)
    for _ in range(20):
        updates, state = opt.update(w * (x_j - c), state, x_j)
        x_j = x_j + updates

    x_t, tw, tc = (torch.from_numpy(a) for a in (x0, w, c))
    ours = make_optimizer(OptimizerConfig(**kw), x_t)
    for _ in range(20):
        x_t = ours.step(x_t, tw * (x_t - tc))
    assert float(np.abs(np.asarray(x_j) - x0).max()) > 1e-2  # it moved
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-6)
    assert opt_kw["name"] in OPTIMIZERS
