"""Port parity: the training slice (cli/train.py on one card).

The same numpy parameters, images and labels go through the JAX package and
the PyTorch port (plain versions on the CPU): one jitted JAX train step,
MobileNetV2 alpha 0.35 at 32 px in float32 with ``optax.sgd`` (Nesterov),
shared by the module and called twice; batch-statistics BatchNorm, the loss
and the moving-statistics EMA eagerly; every optimizer x schedule x clip
against optax on a small Keras-named dict; the npz train state both ways;
``synthetic_batch``; ``warp_augment_batch`` with JAX's draws; the port's CLI.
Xception has no JAX train-step reference here (its compile alone takes
~40 s): its training forward is held against the port's inference forward,
itself held against JAX by ``test_torch_model.py``.

Tolerances: float32 on both sides. The train steps start where their
gradient is well conditioned, and the gradient itself is compared, leaf by
leaf. At the initial parameters (every gamma 1, every beta 0) it is not:
a dead channel normalises to exactly beta = 0, a ReLU tie, and many ReLU
inputs lie within float32 rounding of 0 (32 values a channel at 4x4
features), so one ulp of noise on the input images moves single leaves'
gradients by whole percents: whether a ReLU input flips sign depends on
the last bit of a BatchNorm output. Some leaves have a gradient of 0 in
exact arithmetic (a beta whose BatchNorm feeds, through a linear path,
a conv and another batch-statistics BatchNorm, which removes any constant
shift): theirs is rounding noise. The comparison this one replaced read
parameters after a step at lr 1e-5 and allowed each 10% of its move
+ 1e-6, which passes any error in a leaf whose gradient is under ~0.05: a
sign flip in aspp0_BN/gamma's gradient passed it, and a card-against-CPU
run read 348% of a leaf's move there (expanded_conv_16_project_BN/beta,
one of the zero-gradient betas, whose gradient is rounding noise). So the
steps start from the initial parameters with every gamma drawn from
U(0.25, 0.5) and every beta from +-U(1, 2): a channel's ReLU inputs then
sit at least two standard deviations to one side of 0, so few lie near a
tie (the derivative at a tie is held by
test_activation_and_its_derivative_match_jax, and the masks of a negative
beta's channels stay in the step). The gradient is
read exactly from sgd's momentum trace (after a step from a zero trace it
is the gradient; after the second, the gradient + 0.9 x the first) and
held per leaf to 1% of the leaf's largest value + 1e-4 of the largest in
the whole trace (the zero-gradient leaves): a sign flip in any one leaf's
gradient, a 5% error in a large one, or a 1e-3 offset in a zero-gradient
one fails; the port stays an order of magnitude inside that bound. The
loss 1e-5 relative; the other parameters 1e-6 absolute (the move is
1.9e-5 x the gradient); the moving statistics 1e-5 absolute + 1e-5
relative. The second step starts from the reference's state after the
first. The optimizers
1e-6 relative over 5 steps (the same arithmetic, summed in another order);
labels warped with the nearest mode exactly.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deeplabv3plus_augmented_superresolution_tpu.data.synthetic import (
    synthetic_batch as j_synthetic_batch)
from deeplabv3plus_augmented_superresolution_tpu.models import (
    DeepLabConfig as JDeepLabConfig,
    build_model as j_build_model,
    build_train_step as j_build_train_step,
    segmentation_loss as j_segmentation_loss,
    update_bn_stats as j_update_bn_stats,
)
from deeplabv3plus_augmented_superresolution_tpu.models.layers import (
    ParamStore as JParamStore,
    batch_norm as j_batch_norm,
    relu as j_relu,
    relu6 as j_relu6,
)
from deeplabv3plus_augmented_superresolution_tpu.pipeline import (
    warp_augment_batch as j_warp_augment_batch)
from deeplabv3plus_augmented_superresolution_tpu.utils import (
    load_train_state as j_load_train_state,
    restore_opt_state as j_restore_opt_state,
    save_train_state as j_save_train_state,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.cli import train as cli_train
from deeplabv3plus_augmented_superresolution_tpu_torch.data.synthetic import synthetic_batch
from deeplabv3plus_augmented_superresolution_tpu_torch.models import (
    DeepLabConfig, init_params, load_params_npz, params_from_jax)
from deeplabv3plus_augmented_superresolution_tpu_torch.models.deeplab import DeepLab
from deeplabv3plus_augmented_superresolution_tpu_torch.models.layers import (
    BatchNorm, BatchStatStore, relu, relu6)
from deeplabv3plus_augmented_superresolution_tpu_torch.models.optim import (
    Schedule, TrainOptimizer, make_optimizer)
from deeplabv3plus_augmented_superresolution_tpu_torch.models.train import (
    MasterParams, build_train_step, segmentation_loss, update_bn_stats)
from deeplabv3plus_augmented_superresolution_tpu_torch.models.weights import (
    to_reference_layout)
from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
    warp_augment_batch_with_draws)
from deeplabv3plus_augmented_superresolution_tpu_torch.utils.checkpoint import (
    load_train_state, restore_opt_state, save_train_state)

torch.set_num_threads(2)

SIZE = 32
# The train steps' sgd step size (see the module docstring); LR is the
# optimizers' step against optax.
TRAIN_LR = 1e-5
LR = 0.05
# Xception's training forward against its inference forward: 64 px (4x4
# features). At 32 px (2x2 features, 8 values per BN channel) rounding
# differences compound through the 16 middle-flow units to 0.9 in the
# logits; at 64 px to 5e-3 (logits up to 4).
XCEPTION_SIZE, XCEPTION_ATOL = 64, 2e-2
MOMENTUM = 0.9


def _cfgs(backbone="mobilenet", size=SIZE, **kw):
    common = dict(input_shape=(size, size, 3), classes=21, backbone=backbone,
                  alpha=0.35, weights=None, final_upsample=True,
                  compute_dtype="float32", **kw)
    return JDeepLabConfig(**common), DeepLabConfig(**common)


def _batch(seed=0, n=2, size=SIZE):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 21, (n, size, size)).astype(np.int32)
    labels[:, :3] = 255
    return images, labels


def _assert_params_close(got, want, atol):
    assert set(got) == set(want)
    for layer in want:
        assert set(got[layer]) == set(want[layer])
        for name in want[layer]:
            np.testing.assert_allclose(got[layer][name], np.asarray(want[layer][name]),
                                       atol=atol, rtol=0, err_msg=f"{layer}/{name}")


def _port_sgd():
    return TrainOptimizer("sgd", Schedule("constant", TRAIN_LR), momentum=MOMENTUM)


def _conditioned_start(params):
    """The train steps' starting parameters, where the step's gradient is
    well conditioned (see the module docstring): params with every
    BatchNorm's gamma drawn from U(0.25, 0.5) and beta from +-U(1, 2)."""
    rng = np.random.default_rng(7)
    for entry in params.values():
        if "gamma" in entry:
            n = entry["gamma"].shape
            entry["gamma"] = rng.uniform(0.25, 0.5, n).astype(np.float32)
            entry["beta"] = (rng.choice([-1.0, 1.0], n)
                             * rng.uniform(1.0, 2.0, n)).astype(np.float32)
    return params


def _jit(fn, *args):
    """jax.jit(fn) compiled for args without most of XLA's optimisations,
    as jax_disable_most_optimizations does (the train step compiles in half
    the time; the arithmetic is still float32)."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0,
                                             "xla_llvm_disable_expensive_passes": True})


@pytest.fixture(scope="module")
def setup():
    """The JAX references of the module: the conditioned start and two
    chained jitted train steps from it on one batch, with the optimizer
    state between them. (The guard is off in the reference: on a finite
    batch it changes nothing, and it triples the compile.)"""
    jcfg, cfg = _cfgs()
    images, labels = _batch()
    params = _conditioned_start(init_params(cfg, seed=0))
    tx = optax.sgd(TRAIN_LR, momentum=MOMENTUM, nesterov=True)
    batch = (jnp.asarray(images), jnp.asarray(labels))
    states = [(params, (optax.TraceState(trace=jax.tree.map(np.zeros_like, params)),
                        optax.EmptyState()))]   # tx.init(params), without running it
    step = _jit(j_build_train_step(jcfg, tx), *states[0], *batch)
    losses = []
    for _ in range(2):
        p, o, loss = step(*states[-1], *batch)
        states.append(jax.tree.map(np.asarray, (p, o)))
        losses.append(float(loss))
    out = dict(cfg=cfg, params=params, images=images, labels=labels, states=states,
               losses=losses)
    out["port_step"] = _port_step(out)   # shared by two tests
    return out


def _port_step(setup, params=None, j_opt_state=None, remat=False):
    """One port step (sgd, the guard on) from params (the start) and the
    reference's optimizer state (zero): the parameters, sgd's momentum trace
    (both as the reference's dicts) and the loss."""
    master = MasterParams(params_from_jax(setup["params"] if params is None else params),
                          "cpu")
    tx = _port_sgd()
    opt_state = tx.init(master)
    if j_opt_state is not None:
        restore_opt_state(opt_state, master, jax.tree_util.tree_leaves(j_opt_state))
    step = build_train_step(DeepLab(setup["cfg"], device="meta"), tx, remat=remat,
                            skip_nonfinite=True)
    master, opt_state, loss = step(master, opt_state, torch.as_tensor(setup["images"]),
                                   torch.as_tensor(setup["labels"]))
    trace = {}
    for (layer, name), view in zip(master.keys, master.leaves(opt_state.tensors["trace"])):
        trace.setdefault(layer, {})[name] = to_reference_layout(name, view.numpy().copy())
    return master.numpy_params(), trace, float(loss)


def _assert_step_close(got_params, got_trace, want_params, want_trace):
    """A train step's result against the reference's (see the module
    docstring): the moving statistics to 1e-5 absolute + 1e-5 relative;
    the other parameters to 1e-6 absolute; and sgd's momentum trace, the
    gradient (plus 0.9 x the last one), per leaf to 1% of that leaf's
    largest value + 1e-4 of the whole trace's."""
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


def test_train_steps_match_jax(setup):
    """The whole slice (batch-stat BN, loss, gradients, sgd with Nesterov
    momentum, EMA): the first step from the conditioned start, and the
    second from the reference's state after the first (its params and
    momentum, restored through the checkpoint's leaf order), each against
    the reference's step: the loss before the update, the parameters and
    the moving statistics after it, and the momentum trace."""
    (p0, _), (p1, o1), (p2, o2) = setup["states"]
    got1, trace1, loss1 = setup["port_step"]
    assert loss1 == pytest.approx(setup["losses"][0], rel=1e-5)
    _assert_step_close(got1, trace1, p1, o1[0].trace)
    assert np.abs(got1["Conv_BN"]["moving_mean"] - p0["Conv_BN"]["moving_mean"]).max() \
        > 1e-3   # the EMA moved them

    got2, trace2, loss2 = _port_step(setup, p1, o1)
    assert loss2 == pytest.approx(setup["losses"][1], rel=1e-5)
    _assert_step_close(got2, trace2, p2, o2[0].trace)


def test_remat_equals_no_remat(setup):
    """A step with each block checkpointed equals the plain one exactly:
    the loss, the parameters, and the moving statistics (the recomputation
    records no second set of statistics)."""
    p_plain, t_plain, l_plain = setup["port_step"]
    p_remat, t_remat, l_remat = _port_step(setup, remat=True)
    assert l_remat == l_plain
    _assert_params_close(p_remat, p_plain, atol=0)
    _assert_params_close(t_remat, t_plain, atol=0)


def test_skip_nonfinite_is_atomic(setup):
    """A NaN batch leaves params, optimizer state (count included) and moving
    statistics unchanged; a clean step after it equals a clean step alone."""
    clean = (setup["images"], setup["labels"])
    bad = (np.full_like(setup["images"], np.nan), setup["labels"])
    master = MasterParams(params_from_jax(setup["params"]), "cpu")
    tx = TrainOptimizer("adam", Schedule("cosine", TRAIN_LR, steps=4, warmup_steps=1))
    opt_state = tx.init(master)
    step = build_train_step(DeepLab(setup["cfg"], device="meta"), tx,
                            skip_nonfinite=True)
    flat_before = master.flat.clone()
    state_before = {slot: t.clone() for slot, t in opt_state.tensors.items()}
    master, opt_state, loss = step(master, opt_state, *map(torch.as_tensor, bad))
    assert not np.isfinite(float(loss))
    assert torch.equal(master.flat, flat_before)
    for slot, t in opt_state.tensors.items():
        assert torch.equal(t, state_before[slot]), slot
    after_bad, *_ = step(master, opt_state, *map(torch.as_tensor, clean))
    fresh = MasterParams(params_from_jax(setup["params"]), "cpu")
    alone, *_ = step(fresh, tx.init(fresh), *map(torch.as_tensor, clean))
    assert torch.equal(after_bad.flat, alone.flat)


def test_loss_and_bn_ema_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (2, 8, 8, 21)).astype(np.float32)
    labels = rng.integers(0, 21, (2, 8, 8)).astype(np.int32)
    labels[0, :4] = 255
    want = float(jax.jit(j_segmentation_loss)(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(segmentation_loss(torch.as_tensor(logits), torch.as_tensor(labels)))
    assert got == pytest.approx(want, rel=1e-6)
    all_void = np.full_like(labels, 255)
    assert float(segmentation_loss(torch.as_tensor(logits), torch.as_tensor(all_void))) == 0.0

    params = {f"bn{i}": {k: rng.normal(size=4).astype(np.float32) for k in
                         ("gamma", "beta", "moving_mean", "moving_variance")}
              for i in range(2)}
    stats = {"bn1": tuple(rng.normal(size=4).astype(np.float32) for _ in range(2))}
    want = jax.jit(j_update_bn_stats, static_argnames="momentum")(params, stats, momentum=0.9)
    got = update_bn_stats(params_from_jax(params),
                          {k: tuple(map(torch.as_tensor, v)) for k, v in stats.items()},
                          momentum=0.9)
    _assert_params_close({k: {n: t.numpy() for n, t in e.items()} for k, e in got.items()},
                         want, atol=1e-7)


@pytest.mark.parametrize("case", ["float32", "bfloat16", "one value per channel"])
def test_batch_norm_batch_mode_matches_jax(case):
    """Output, recorded (mean, var) and the gradients of <out, w> with respect
    to the input, gamma and beta."""
    rng = np.random.default_rng(2)
    shape = (1, 1, 1, 16) if case == "one value per channel" else (2, 8, 8, 16)
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    w = rng.normal(size=shape).astype(np.float32)
    entry = {"gamma": rng.uniform(0.5, 1.5, 16).astype(np.float32),
             "beta": rng.normal(size=16).astype(np.float32),
             "moving_mean": np.zeros(16, np.float32),
             "moving_variance": np.ones(16, np.float32)}
    jdt = jnp.bfloat16 if case == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if case == "bfloat16" else torch.float32

    def j_fn(xx, gamma, beta):
        store = JParamStore({"bn": dict(entry, gamma=gamma, beta=beta)}, bn_mode="batch")
        out = j_batch_norm(store, "bn", xx.astype(jdt))
        return jnp.sum(out.astype(jnp.float32) * w), (out, store.bn_batch_stats["bn"])

    (_, (j_out, (j_mean, j_var))), j_grads = jax.jit(jax.value_and_grad(
        j_fn, argnums=(0, 1, 2), has_aux=True))(jnp.asarray(x), entry["gamma"], entry["beta"])

    leaves = {k: torch.tensor(v, requires_grad=k in ("gamma", "beta")) for k, v in entry.items()}
    xt = torch.tensor(x, requires_grad=True)
    store = BatchStatStore({"bn": leaves})
    out = BatchNorm("bn", 16, device="meta")(xt.permute(0, 3, 1, 2).to(tdt), store)
    out = out.permute(0, 2, 3, 1)
    (out.float() * torch.as_tensor(w)).sum().backward()
    mean, var = store.bn_batch_stats["bn"]
    assert out.dtype == tdt and mean.dtype == var.dtype == torch.float32
    out_atol = 1e-2 if case == "bfloat16" else 1e-5
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(j_out, np.float32), atol=out_atol)
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(j_var), rtol=1e-5, atol=1e-6)
    grad_atol = 2e-2 if case == "bfloat16" else 1e-4
    for got, want in zip((xt.grad, leaves["gamma"].grad, leaves["beta"].grad), j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   atol=grad_atol, rtol=1e-4)


@pytest.mark.parametrize("name", ["relu", "relu6"])
def test_activation_and_its_derivative_match_jax(name):
    """Values and derivatives below, at and near 0, inside, at 6 and above:
    at a tie both take 1/2 (jnp.maximum and jnp.clip split it; torch.relu
    gives 0, torch.clamp 1)."""
    j_fn, fn = {"relu": (j_relu, relu), "relu6": (j_relu6, relu6)}[name]
    x = np.array([-2.0, -1e-7, 0.0, 1e-7, 3.0, 6.0, 7.0], np.float32)
    want = np.asarray(j_fn(jnp.asarray(x)))
    want_grad = np.asarray(jax.jit(jax.vmap(jax.grad(j_fn)))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    out = fn(xt)
    out.sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), want)
    np.testing.assert_array_equal(xt.grad.numpy(), want_grad)
    assert 0.0 < want_grad[2] < 1.0


def _j_optimizer(name, schedule, clip, steps):
    if schedule == "constant":
        sched = LR
    elif schedule == "cosine":
        sched = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=LR, warmup_steps=2, decay_steps=max(steps, 3))
    else:
        sched = optax.exponential_decay(init_value=LR, transition_steps=2,
                                        decay_rate=0.5, staircase=False)
    tx = {"adam": lambda: optax.adam(sched),
          "adamw": lambda: optax.adamw(sched, weight_decay=0.1),
          "sgd": lambda: optax.sgd(sched, momentum=MOMENTUM, nesterov=True)}[name]()
    return optax.chain(optax.clip_by_global_norm(0.5), tx) if clip else tx


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("schedule", ["constant", "cosine", "exponential"])
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_matches_optax(name, schedule, clip):
    """5 steps on a small Keras-named dict (a conv, its BN, a head with a
    bias; zero gradients for the moving statistics, as in training): the
    parameters, and the state as optax's leaves (count, shapes, order and
    values, reference layout)."""
    steps = 5
    rng = np.random.default_rng(3)
    params = {"conv": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32)},
              "conv_BN": {k: rng.normal(size=4).astype(np.float32) for k in
                          ("gamma", "beta", "moving_mean", "moving_variance")},
              "head": {"kernel": rng.normal(size=(1, 1, 4, 3)).astype(np.float32),
                       "bias": rng.normal(size=3).astype(np.float32)}}
    grads = [{layer: {k: (np.zeros_like(v) if k.startswith("moving")
                          else rng.normal(size=v.shape).astype(np.float32))
                      for k, v in entry.items()} for layer, entry in params.items()}
             for _ in range(steps)]
    tx = _j_optimizer(name, schedule, clip, steps)
    j_params, j_state = params, tx.init(params)
    for g in grads:
        updates, j_state = tx.update(g, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)

    args = cli_train.parse_args([
        "--optimizer", name, "--lr", str(LR), "--lr_schedule", schedule,
        "--warmup_steps", "2", "--steps", str(steps), "--decay_steps", "2",
        "--decay_rate", "0.5", "--weight_decay", "0.1", "--momentum", str(MOMENTUM),
        "--grad_clip", "0.5" if clip else "0"])
    port = make_optimizer(args)
    master = MasterParams(params_from_jax(params), "cpu")
    state = port.init(master)
    leaves = state.leaves(master)
    want_leaves = jax.tree_util.tree_leaves(tx.init(params))
    assert len(leaves) == len(want_leaves)
    for g in grads:
        flat_g = MasterParams(params_from_jax(g), "cpu").flat
        new_flat, new_state = port.update(flat_g, state, master.flat)
        master.flat.copy_(new_flat)
        state.assign(new_state)
    np.testing.assert_allclose(master.flat.numpy(),
                               MasterParams(params_from_jax(j_params), "cpu").flat.numpy(),
                               rtol=1e-6, atol=1e-7)
    if name == "adamw":   # the decoupled decay shrinks the moving statistics too
        assert not np.allclose(j_params["conv_BN"]["moving_mean"],
                               params["conv_BN"]["moving_mean"])
    with torch.no_grad():
        saved = _leaves_as_saved(state, master)
    for i, (got, want) in enumerate(zip(saved, jax.tree_util.tree_leaves(j_state))):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, i
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=str(i))


def _leaves_as_saved(state, master, tmp=None):
    """The optimizer leaves as save_train_state writes them."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "s.npz")
        save_train_state(path, master, state, 0)
        leaves, _ = load_train_state(path)
    return leaves


def test_checkpoint_both_ways(tmp_path, setup):
    """A JAX train-state npz (adam + cosine, MobileNetV2) resumes in the port;
    the port writes it back with identical keys and arrays; the port's file
    loads in JAX's build_model and restore_opt_state; a checkpoint of
    another optimizer raises ValueError."""
    jcfg, _ = _cfgs()
    params = setup["params"]
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup_steps=2, decay_steps=10)
    tx = optax.adam(sched)
    rng = np.random.default_rng(4)
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                            jax.eval_shape(tx.init, params))   # tx.init, not run
    j_state = jax.tree.map(
        lambda x: (np.asarray(7, np.int32) if np.ndim(x) == 0
                   else rng.normal(size=np.shape(x)).astype(np.float32)), template)
    j_path = str(tmp_path / "jax.npz")
    j_save_train_state(j_path, params, j_state, 7)

    master = MasterParams(params_from_jax(load_params_npz(j_path)), "cpu")
    args = cli_train.parse_args(["--lr_schedule", "cosine", "--warmup_steps", "2",
                                 "--steps", "10"])
    state = make_optimizer(args).init(master)
    leaves, step = load_train_state(j_path)
    assert step == 7
    restore_opt_state(state, master, leaves)
    t_path = str(tmp_path / "torch.npz")
    save_train_state(t_path, master, state, step)
    with np.load(j_path) as a, np.load(t_path) as b:
        assert set(a.files) == set(b.files)
        for key in a.files:
            x, y = a[key], b[key]
            assert x.dtype == y.dtype, key
            np.testing.assert_array_equal(x, y, err_msg=key)

    j_loaded, _ = j_build_model(jcfg, params=params, weights_path=t_path)
    _assert_params_close(j_loaded, params, atol=0)
    j_leaves, j_step = j_load_train_state(t_path)
    restored = j_restore_opt_state(template, j_leaves)
    for got, want in zip(jax.tree_util.tree_leaves(restored),
                         jax.tree_util.tree_leaves(j_state)):
        np.testing.assert_array_equal(np.asarray(got), want)
    assert j_step == 7

    sgd_state = _port_sgd().init(master)
    with pytest.raises(ValueError):
        restore_opt_state(sgd_state, master, leaves)


@pytest.mark.parametrize("hard", [False, True], ids=["easy", "hard"])
def test_synthetic_batch_bit_for_bit(hard):
    want = j_synthetic_batch(np.random.default_rng(5), 2, size=(SIZE, SIZE), hard=hard)
    got = synthetic_batch(np.random.default_rng(5), 2, size=(SIZE, SIZE), hard=hard)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_warp_augment_batch_matches_jax_draws():
    """JAX's warp_augment_batch and the port's ..._with_draws on JAX's own
    draws (the key split as the reference splits it): images 1e-5, labels
    (nearest, 255 contours, border 0) exactly."""
    rng = np.random.default_rng(6)
    n, angle_max, shift_max = 4, 0.15, 5.0
    images = rng.uniform(0, 1, (n, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, 21, (n, SIZE, SIZE)).astype(np.int32)
    labels[:, 10:12] = 255
    key = jax.random.key(11)
    j_img, j_lab = j_warp_augment_batch(key, jnp.asarray(images), jnp.asarray(labels),
                                        angle_max=angle_max, shift_max=shift_max)

    @jax.jit
    def draws(key):
        k_a, k_s, k_p = jax.random.split(key, 3)
        return (jax.random.uniform(k_a, (n,), jnp.float32, -angle_max, angle_max),
                jax.random.uniform(k_s, (n, 2), jnp.float32, -shift_max, shift_max),
                (jax.random.uniform(k_p, (n,)) < 0.5).astype(jnp.float32))

    angles, shifts, take = draws(key)
    assert 0 < float(take.sum()) < n   # warped and untouched samples both
    img, lab = warp_augment_batch_with_draws(
        torch.as_tensor(images), torch.as_tensor(labels),
        *(torch.as_tensor(np.array(d)) for d in (angles, shifts, take)))
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=1e-5)
    assert lab.dtype == torch.int32
    np.testing.assert_array_equal(lab.numpy(), np.asarray(j_lab))
    assert (lab.numpy() == 0).sum() > (labels == 0).sum()   # the border is background


_XCEPTION_PARAMS: dict = {}


def _xception_params(cfg):
    """Random port-layout params for an Xception variant: the standard
    model's init (41 M values, drawn once and shared) for every layer the
    variant shapes the same, and a draw of its own for the others (the
    decoder's)."""
    if not _XCEPTION_PARAMS:
        _, standard = _cfgs("xception", size=XCEPTION_SIZE, first_upsample_size=(16, 16))
        ref = init_params(standard, seed=0)
        _XCEPTION_PARAMS.update(ref=ref, port=params_from_jax(ref))
    rng = np.random.default_rng(8)
    params: dict = {}
    for layer, name, shape, init in DeepLab(cfg, device="meta").specs():
        if _XCEPTION_PARAMS["ref"].get(layer, {}).get(name, np.empty(0)).shape == tuple(shape):
            weight = _XCEPTION_PARAMS["port"][layer][name]
        else:
            value = {"glorot": lambda: rng.uniform(-0.05, 0.05, shape),
                     "zeros": lambda: np.zeros(shape), "ones": lambda: np.ones(shape)}[init]()
            weight = params_from_jax({layer: {name: value}})[layer][name]
        params.setdefault(layer, {})[name] = weight
    return params


@pytest.mark.parametrize("variant", ["standard", "only_dcnn", "only_aspp"])
def test_xception_training_forward_matches_inference(variant):
    """Xception in training mode: every BN layer of the variant records its
    statistics (ASPP's too with only_DCNN, as the reference's forward runs
    it), and with the moving statistics set to those batch statistics the
    inference forward (BN folded; held against JAX elsewhere) gives the same
    logits on the same batch."""
    _, cfg = _cfgs("xception", size=XCEPTION_SIZE,
                   only_dcnn_output=variant == "only_dcnn",
                   only_aspp_output=variant == "only_aspp",
                   first_upsample_size=(16, 16))
    model = DeepLab(cfg, device="cpu").eval()
    params = _xception_params(cfg)
    images = torch.as_tensor(_batch(seed=7, size=XCEPTION_SIZE)[0])
    with torch.no_grad():
        logits, stats = model.forward_train(images, params)
    bn_layers = {layer.keras_name for layer in model.keras_layers()
                 if isinstance(layer, BatchNorm)}
    assert set(stats) == bn_layers
    for name, (mean, var) in stats.items():
        params[name] = dict(params[name], moving_mean=mean, moving_variance=var)
    with torch.no_grad():
        folded = model.load_params(params)(images)
    np.testing.assert_allclose(logits.numpy(), folded.numpy(), rtol=0, atol=XCEPTION_ATOL)


def _cli(tmp_path, *extra):
    base = ["--device", "cpu", "--backbone", "mobilenet", "--alpha", "0.35",
            "--size", str(SIZE), "--batch", "2", "--train_set", "4",
            "--eval_images", "2", "--log_every", "2", "--lr", "3e-3",
            "--lr_schedule", "exponential", "--decay_steps", "3",
            "--decay_rate", "0.5", "--compute_dtype", "float32", "--warp_augment",
            "--save_params", ""]
    return cli_train.main(base + list(extra))


def test_cli_checkpoint_resume_equals_uninterrupted(tmp_path):
    """The port's CLI on the CPU: 4 steps straight, and 2 steps with a
    checkpoint then 2 resumed from it (Adam moments, schedule position and
    the chunk-seeded data restored): the same per-step losses; the final
    params and the summary keys."""
    long_run = _cli(tmp_path, "--steps", "4", "--save_params", str(tmp_path / "final.npz"))
    first = _cli(tmp_path, "--steps", "2", "--ckpt_dir", str(tmp_path / "ck"),
                 "--ckpt_every", "2", "--out", str(tmp_path / "first.json"))
    resumed = _cli(tmp_path, "--steps", "2", "--resume", str(tmp_path / "ck" / "step_2.npz"))
    assert resumed["start_step"] == 2 and resumed["total_steps"] == 4
    np.testing.assert_allclose(first["losses"] + resumed["losses"], long_run["losses"],
                               rtol=1e-6)
    assert np.all(np.isfinite(long_run["losses"])) and len(long_run["losses"]) == 4
    assert set(load_params_npz(str(tmp_path / "final.npz"))) == set(
        load_params_npz(str(tmp_path / "ck" / "step_2.npz")))
    assert set(first) == {
        "backbone", "size", "steps", "start_step", "total_steps", "global_batch",
        "devices", "optimizer", "lr_schedule", "remat", "compute_dtype", "loss_first",
        "loss_final", "losses", "train_s", "steps_per_s", "held_out_miou", "evals"}
    assert (tmp_path / "first.json").exists()


@pytest.mark.parametrize("flags", [["--devices", "2"], ["--multihost"], ["--data", "voc"],
                                   ["--ckpt_format", "orbax"]],
                         ids=["devices", "multihost", "voc", "orbax"])
def test_cli_rejects_unported_flags(flags, capsys):
    with pytest.raises(SystemExit):
        cli_train.parse_args(flags)
    err = capsys.readouterr().err
    assert "not ported" in err and flags[0] in err
