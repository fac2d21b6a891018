"""Port parity: ``parallel/`` (the (data, aug) mesh, aug-axis padding in the
solver, sharded serving and the data-parallel train step).

(a) The mesh's layout, the padding rules and run_asr's factorisation
against the JAX functions on the same inputs (the JAX mesh over the 8 fake
CPU devices of tests/conftest.py), errors included. (b) The solver with
``num_valid``: 7 copies padded to 8 at 64 px (feature 16), the padded
copy's masks junk; the padded stencil, the gram, CG and direct (copy
minibatches and dropout, JAX's draws handed in through
``solve_with_draws``) solvers and max/mean against the JAX solver with the
same padded config, one jitted program. (c) One spawn of two gloo ranks
for the file (tests/torch_parallel_worker.py), serving a 64-px
MobileNetV2: ``make_asr_batch_fn`` on (1, 2) and (2, 1) meshes,
``run_asr.main --batch 2`` under torchrun's environment and one sharded
train step with synchronised BatchNorm, each against the JAX package's
``make_asr_batch_fn`` / ``make_sharded_train_step`` on a JAX mesh of the
same shape (the (1, 2) case against the (2, 1) program's first image: the
padded copy weighs 0, so padding changes no result). The ranks run while
the JAX references are traced, one after another, and compiled, side by
side.

Tolerances, those of the single-card parity tests of the same functions:
masks agree on >= 99% of pixels and the aug target within 5e-3
(test_torch_pipeline.py); max/mean 1e-5 (test_torch_multiclass.py); the
gram and direct solves max 5e-3, mean 1e-4, loss 1e-4 relative, CG 1e-4,
1e-6, 1e-5 (test_torch_solvers.py); the stencil through apply_gram 2.5e-4
of scale (chip_smoke.py's stencil bound); the train step as
test_torch_train.py's (its gradient per leaf to 1% of the leaf's largest
value + 1e-4 of the whole gradient's, from a start away from ReLU ties).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deeplabv3plus_augmented_superresolution_tpu.models import (
    DeepLabConfig as JDeepLabConfig)
from deeplabv3plus_augmented_superresolution_tpu.parallel import (
    make_asr_batch_fn as j_make_asr_batch_fn,
    make_mesh as j_make_mesh,
    make_sharded_train_step as j_make_sharded_train_step,
    multihost_mesh_shape as j_multihost_mesh_shape,
    padded_aug_count as j_padded_aug_count,
    padded_sr_cfg as j_padded_sr_cfg,
    shard_batch as j_shard_batch,
    shard_train_batch as j_shard_train_batch,
)
from deeplabv3plus_augmented_superresolution_tpu.sr import (
    OptimizerConfig as JOptimizerConfig,
    SRConfig as JSRConfig,
    augmented_superresolution as j_asr,
    forward_operator as j_forward_operator,
    max_mean_superresolution as j_max_mean,
    stencil_cache_key as j_stencil_cache_key,
)
from deeplabv3plus_augmented_superresolution_tpu.sr.solver import (
    _dropout_weights as j_dropout_weights,
    multiclass_max_mean_superresolution as j_multiclass_max_mean,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.cli import run_asr
from deeplabv3plus_augmented_superresolution_tpu_torch.data.io import load_image, save_img
from deeplabv3plus_augmented_superresolution_tpu_torch.models import (
    DeepLabConfig, build_model, init_params)
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.gram import apply_gram
from deeplabv3plus_augmented_superresolution_tpu_torch.parallel import (
    aug_sharding, data_sharding, initialize_distributed, make_mesh, multihost_mesh_shape,
    padded_aug_count, padded_sr_cfg)
from deeplabv3plus_augmented_superresolution_tpu_torch.parallel.mesh import (
    TORCHRUN_ENV, Mesh, free_port, rank_device)
from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import sample_augmentations
from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
    SRConfig, forward_operator, load_stencil, max_mean_superresolution,
    multiclass_max_mean_superresolution, precompute_gram_stencil, save_stencil,
    solve_with_draws, stencil_cache_key)
from test_torch_shear import compile_side_by_side, jax_init_params
from test_torch_train import (TRAIN_LR, _assert_step_close, _batch, _cfgs,
                              _conditioned_start)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
SIZE, N_REAL, N_PAD = 64, 7, 8
# The served model: MobileNetV2 (OS8, feature 8) at 64 px.
SERVE_MODEL = dict(input_shape=(SIZE, SIZE, 3), backbone="mobilenet", final_upsample=False)
FEATURE = (8, 8)
# run_asr's flags of the served runs; the (1, 2) and (2, 1) cases serve with
# the same configuration, so the (2, 1) JAX program serves main's batches too.
MAIN_FLAGS = ["--num_aug", str(N_REAL), "--num_iter", "5", "--shift_max", "8"]
SR_TYPES = ("aug", "max", "mean")
MASK_AGREE = 0.99
TARGET_ATOL = 5e-3


def _jax_cfg(cfg: SRConfig) -> JSRConfig:
    fields = dataclasses.asdict(cfg)
    return JSRConfig(**dict(fields, optimizer=JOptimizerConfig(**fields["optimizer"])))


def _cli_cfg() -> SRConfig:
    args = run_asr.parse_args(["--images", "unused.jpg", *MAIN_FLAGS])
    return run_asr.make_sr_config(args, num_aug=N_REAL, feature_size=FEATURE,
                                  output_size=(SIZE, SIZE), angle_max=args.angle_max)


def _run_set():
    """run_asr's fixed set for these flags (SEED, 7 copies, shifts +-8 px)."""
    return sample_augmentations(torch.Generator().manual_seed(run_asr.SEED), N_REAL,
                                0.15, 8.0, device="cpu")


def _images(n):
    """Smooth random 64-px scenes: colour fields upsampled 8x."""
    rng = np.random.default_rng(21)
    low = rng.uniform(0, 1, (n, 8, 8, 3)).astype(np.float32)
    return np.kron(low, np.ones((1, 8, 8, 1), np.float32))


# ---- (a) the mesh and the padding rules --------------------------------------

def test_mesh_layout_and_shardings_match_jax():
    """Rank r of a (d, a) mesh sits where JAX's make_mesh puts device r, and
    its data / aug shards are that device's slices of JAX's NamedShardings;
    a shape that is not the world's raises JAX's ValueError; the default
    mesh of one process is (1, 1)."""
    devices = jax.devices()
    x = np.arange(8 * 16).reshape(8, 16)
    for shape in ((1, 8), (2, 4), (4, 2), (8, 1)):
        jmesh = j_make_mesh(devices, shape)
        spec = {"data": jax.sharding.PartitionSpec("data"),
                "aug": jax.sharding.PartitionSpec("data", "aug")}
        for rank in range(8):
            mesh = Mesh({"data": shape[0], "aug": shape[1]}, rank)
            where = tuple(np.argwhere(jmesh.devices == devices[rank])[0])
            assert (mesh.data_index, mesh.aug_index) == where
            for name, sharding in (("data", data_sharding), ("aug", aug_sharding)):
                index = jax.sharding.NamedSharding(jmesh, spec[name]).devices_indices_map(
                    x.shape)[devices[rank]]
                assert np.array_equal(sharding(mesh)(torch.from_numpy(x)).numpy(), x[index])
    assert make_mesh().shape == dict(j_make_mesh(devices[:1]).shape) == {"data": 1, "aug": 1}
    with pytest.raises(ValueError) as ours:
        make_mesh((2, 1))
    with pytest.raises(ValueError) as theirs:
        j_make_mesh(devices[:1], (2, 1))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("num_aug, aug", [(7, 2), (8, 2), (100, 3), (100, 8)])
def test_padding_rules_match_jax(num_aug, aug):
    """padded_aug_count and padded_sr_cfg (num_aug padded, num_valid the real
    count) as JAX's; a config that already sets num_valid and needs padding
    raises JAX's ValueError."""
    jmesh = j_make_mesh(jax.devices()[:aug], (1, aug))
    mesh = Mesh({"data": 1, "aug": aug}, 0)
    assert padded_aug_count(num_aug, mesh) == j_padded_aug_count(num_aug, jmesh)
    ours = padded_sr_cfg(SRConfig(num_aug=num_aug), mesh)
    theirs = j_padded_sr_cfg(JSRConfig(num_aug=num_aug), jmesh)
    assert (ours.num_aug, ours.num_valid, ours.n_valid) == \
        (theirs.num_aug, theirs.num_valid, theirs.n_valid)
    if ours.num_aug != num_aug:
        with pytest.raises(ValueError, match="managed by the parallel layer"):
            padded_sr_cfg(SRConfig(num_aug=num_aug, num_valid=num_aug - 1), mesh)
        with pytest.raises(ValueError, match="managed by the parallel layer"):
            j_padded_sr_cfg(JSRConfig(num_aug=num_aug, num_valid=num_aug - 1), jmesh)


def test_run_asr_factorisation_and_entry_guards(monkeypatch):
    """run_asr's (data, aug) factors are the JAX CLI's (cli/run_asr.py: the
    largest data axis dividing the batch and the device count); the
    multi-host split is JAX's; initialize_distributed does nothing without
    torchrun's environment; a LOCAL_RANK with no card raises; main with
    several ranks and --batch <= 1 exits."""
    for batch in range(1, 9):
        for world in range(1, 9):
            data = min(batch, world)
            while world % data or batch % data:
                data -= 1
            assert run_asr.mesh_shape(batch, world) == (data, world // data)
    assert multihost_mesh_shape(2, 4) == j_multihost_mesh_shape(2, 4)
    assert multihost_mesh_shape(16, 8) == j_multihost_mesh_shape(16, 8)
    for key in TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    assert initialize_distributed("cpu") is False
    assert rank_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="names no card"):
        rank_device("cuda", local_rank=torch.cuda.device_count())
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="would serve every image"):
        run_asr.main(["--images", "unused.jpg", "--batch", "1"])


def test_stencil_cache_key_holds_the_real_copy_count():
    """ROADMAP F8: 102 transforms whose last two are identity key one stencil
    in the JAX package's cache whether those two are padding (num_valid 100,
    weighted 0) or real copies, which give another stencil; the port's key
    holds the count of real copies and tells them apart."""
    angles = np.pad(np.linspace(-0.1, 0.1, 100, dtype=np.float32), (0, 2))
    shifts = np.zeros((102, 2), np.float32)
    real, padded = dict(num_aug=102), dict(num_aug=102, num_valid=100)
    assert j_stencil_cache_key(angles, shifts, JSRConfig(**real)) == \
        j_stencil_cache_key(angles, shifts, JSRConfig(**padded))
    assert stencil_cache_key(angles, shifts, SRConfig(**real)) != \
        stencil_cache_key(angles, shifts, SRConfig(**padded))


def test_stencil_cache_key_holds_the_solve_dtype(tmp_path):
    """ROADMAP F10: the staged operator's stencil in bfloat16 and in float32
    differ, and so do their keys and files in the port's cache (the JAX key
    lacks solve_dtype as well)."""
    angles = np.linspace(-0.1, 0.1, 4, dtype=np.float32)
    shifts = np.zeros((4, 2), np.float32)
    f32, bf16 = (SRConfig(num_aug=4, operator_impl="staged", solve_dtype=dtype)
                 for dtype in ("float32", "bfloat16"))
    assert j_stencil_cache_key(angles, shifts, _jax_cfg(f32)) == \
        j_stencil_cache_key(angles, shifts, _jax_cfg(bf16))
    assert stencil_cache_key(angles, shifts, f32) != stencil_cache_key(angles, shifts, bf16)
    paths = {save_stencil(str(tmp_path), angles, shifts, cfg, np.full((1,), i, np.float32))
             for i, cfg in enumerate((f32, bf16))}
    assert len(paths) == 2
    assert load_stencil(str(tmp_path), angles, shifts, f32)[0] == 0.0
    assert load_stencil(str(tmp_path), angles, shifts, bf16)[0] == 1.0


# ---- the references: two gloo ranks and JAX's programs ------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Starts the two ranks, then computes the JAX references while they run:
    (b)'s program and (c)'s three. Returns (b)'s case and references, the
    ranks' outputs (rank0/rank1 npz), main's PNGs and (c)'s references."""
    work = tmp_path_factory.mktemp("parallel")
    padded = _padded_case()
    # main serves img0, img1 and img2, a copy of img1: its ragged second
    # step's one image is one that the first step's JAX program served.
    images = _images(2)
    os.makedirs(work / "images")
    for i, image in enumerate(images[[0, 1, 1]]):
        save_img(str(work / "images" / f"img{i}.jpg"), image * 255.0, scale=False)
    decoded = np.stack([load_image(str(work / "images" / f"img{i}.jpg"),
                                   image_size=(SIZE, SIZE), normalize=True)
                        for i in range(2)]).astype(np.float32)
    jcfg = JDeepLabConfig(**SERVE_MODEL)
    params = jax_init_params(jcfg, seed=0)
    model = build_model(DeepLabConfig(**SERVE_MODEL), params=params, device="cpu")
    with torch.no_grad():
        labels = model(torch.from_numpy(decoded[:1])).argmax(-1)
    class_id = int(torch.bincount(labels.flatten(), minlength=21)[1:].argmax()) + 1
    cfg = _cli_cfg()
    angles, shifts = _run_set()
    # The set's stencil under the padded config of the (1, 2) mesh (equal to
    # the unpadded one: the padded copy weighs 0), which every case serves.
    stencil = precompute_gram_stencil(angles, shifts, dataclasses.replace(
        cfg, num_aug=N_PAD, num_valid=N_REAL))
    _, tcfg = _cfgs()
    start = _conditioned_start(init_params(tcfg, seed=0))
    train_images, train_labels = _batch(n=4)
    arrays = {"images": decoded, "angles": angles.numpy(), "shifts": shifts.numpy(),
              "stencil": stencil.numpy(), "train_images": train_images,
              "train_labels": train_labels}
    arrays.update({f"train_params/{layer}/{name}": value
                   for layer, entry in start.items() for name, value in entry.items()})
    np.savez(work / "inputs.npz", **arrays)
    with open(work / "config.json", "w") as f:
        json.dump({"sr": dataclasses.asdict(cfg), "class_id": class_id,
                   "train_lr": TRAIN_LR}, f)
    port = free_port()
    logs = [open(work / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
                               str(r), str(port), str(work)], stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        refs = _run_programs([
            _jax_padded_refs(padded),
            _jax_serve_ref((2, 1), params, jcfg, cfg, class_id, decoded, angles, shifts,
                           stencil),
            _jax_train_ref(start, train_images, train_labels)])
        for proc in procs:
            proc.wait(timeout=300)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for log in logs:
            log.close()
    for r, proc in enumerate(procs):
        assert proc.returncode == 0, (work / f"rank{r}.log").read_text()[-4000:]
    outs = [dict(np.load(work / f"rank{r}.npz")) for r in range(2)]
    pngs = {f"img{i}_{key}": load_image(str(work / "main_out" / f"img{i}_{key}.png"),
                                        is_png=True, normalize=False)
            for i in range(3) for key in SR_TYPES + ("standard",)}
    return dict(padded=dict(padded, ref=refs.pop("padded")), outs=outs, pngs=pngs,
                refs=refs, class_id=class_id)


def _padded_case():
    """(b)'s case: 7 real copies + 1 identity padding at 64 px (feature 16,
    as test_torch_solvers.py's CG bound was set for factor 4)
    of two classes' LR masks (noisy, the padded copy's junk), the configs
    of the three solvers, the port's padded stencil and a probe x."""
    cfg = dataclasses.replace(_cli_cfg(), num_aug=N_PAD, num_valid=N_REAL,
                              feature_size=(16, 16))
    angles, shifts = _run_set()
    angles8 = torch.nn.functional.pad(angles, (0, 1))
    shifts8 = torch.nn.functional.pad(shifts, (0, 0, 0, 1))
    gt = np.zeros((2, SIZE, SIZE), np.float32)
    gt[0, 16:44, 12:50], gt[1, 20:56, 8:30] = 1.0, 1.0
    lr = forward_operator(torch.from_numpy(gt), angles8, shifts8, cfg.feature_size, cfg)
    noise = np.random.default_rng(5).uniform(-0.1, 0.1, (2, N_PAD, 16, 16, 1))
    masks = (lr.permute(3, 0, 1, 2)[..., None].numpy() + noise).astype(np.float32)
    masks[:, N_REAL] = np.random.default_rng(6).uniform(-5, 5, masks[:, N_REAL].shape)
    cfgs = {"gram": cfg, "cg": dataclasses.replace(cfg, solver_impl="cg", cg_outer=2,
                                                   cg_inner=5),
            "direct": dataclasses.replace(cfg, solver_impl="direct", sgd_copies=3,
                                          copy_dropout=0.3)}
    return dict(cfgs=cfgs, masks=torch.from_numpy(masks), angles=angles8, shifts=shifts8,
                stencil=precompute_gram_stencil(angles, shifts, cfg),
                x=torch.rand((1, SIZE, SIZE, 1), generator=torch.Generator().manual_seed(3)))


def _run_programs(programs):
    """programs: (jitted, args, finish) each. Each is traced and lowered here,
    one after another (tracing holds the interpreter lock), compiled with
    FAST_COMPILE on threads side by side (XLA releases the lock), then run
    on args; finish turns its outputs into entries of the returned dict."""
    compiled = compile_side_by_side(*(jitted.lower(*args) for jitted, args, _ in programs))
    refs = {}
    for fn, (_, args, finish) in zip(compiled, programs):
        refs.update(finish(fn(*args)))
    return refs


def _jax_padded_refs(case):
    """(b)'s JAX references in one program: A^T (w A x) of the padded
    set with the padded copy weighted 0, gram and CG on the port's stencil
    (as test_torch_solvers.py hands CG one stencil), direct on minibatches
    of 3 with dropout (key 1, its draws returned), max/mean of one class
    and of two."""
    key = jax.random.key(1)
    valid = (np.arange(N_PAD) < N_REAL).astype(np.float32)[:, None, None, None]
    jcfg = {name: _jax_cfg(c) for name, c in case["cfgs"].items()}

    def refs(m, a, s, coeffs, z):
        fwd = lambda v: j_forward_operator(v, a, s, jcfg["gram"].feature_size,
                                           jcfg["gram"]) * valid
        out, vjp = jax.vjp(fwd, z)
        return {"normal": vjp(out)[0],
                "gram": j_asr(m[0], a, s, jcfg["gram"], gram_coeffs=coeffs),
                "cg": j_asr(m[0], a, s, jcfg["cg"], gram_coeffs=coeffs),
                "direct": j_asr(m[0], a, s, jcfg["direct"], dropout_key=key),
                "weights": j_dropout_weights(key, jcfg["direct"]),
                "perm": jax.random.permutation(jax.random.fold_in(key, 997), N_REAL),
                "max_mean": j_max_mean(m[0], a, s, jcfg["gram"]),
                "classes": j_multiclass_max_mean(m, a, s, jcfg["gram"])}

    args = [jnp.asarray(case[k].numpy()) for k in ("masks", "angles", "shifts", "stencil", "x")]
    return jax.jit(refs), args, lambda out: {"padded": jax.tree.map(np.array, out)}


def _jax_serve_ref(shape, params, jcfg, cfg, class_id, images, angles, shifts, stencil):
    """JAX's make_asr_batch_fn on a mesh of this shape over the fake CPU
    devices, the images one a data index (a program for _run_programs)."""
    mesh = j_make_mesh(jax.devices()[:2], shape)
    fn = j_make_asr_batch_fn(mesh, jcfg, _jax_cfg(cfg), class_id, th_factor=0.2,
                             sr_types=SR_TYPES, gram_coeffs=jnp.asarray(stencil.numpy()),
                             return_targets=True)
    b = len(images)
    args = j_shard_batch(mesh, params, images, np.broadcast_to(angles.numpy(), (b, N_REAL)),
                         np.broadcast_to(shifts.numpy(), (b, N_REAL, 2)))
    return fn, args, lambda out: {f"{shape[0]}x{shape[1]}": jax.tree.map(np.asarray, out)}


def _jax_train_ref(start, images, labels):
    """JAX's make_sharded_train_step on a (1, 2) mesh from the conditioned
    start, sgd from a zero trace (a program for _run_programs)."""
    mesh = j_make_mesh(jax.devices()[:2], (1, 2))
    tcfg, _ = _cfgs()
    step = j_make_sharded_train_step(mesh, tcfg, optax.sgd(TRAIN_LR, momentum=0.9,
                                                           nesterov=True))
    state = (optax.TraceState(trace=jax.tree.map(np.zeros_like, start)), optax.EmptyState())

    def finish(out):
        p, o, loss = out
        return {"train": (jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o[0].trace),
                          float(loss))}

    return step, (start, state, *j_shard_train_batch(mesh, images, labels)), finish


# ---- (b) the solver with a padded aug axis -----------------------------------

def test_padded_stencil_matches_jax(run):
    """The stencil of 7 copies under the padded config (the set padded with
    an identity copy weighted 0): G x against JAX's normal operator of the
    padded set with the padded copy weighted 0, A^T (w A x) (2.5e-4 of
    scale), and against the port's 7-copy stencil without padding (1e-6 of
    scale: the padded copy adds nothing)."""
    padded = run["padded"]
    coeffs = padded["stencil"]
    want = torch.from_numpy(padded["ref"]["normal"])
    scale = float(want.abs().max())
    assert float((apply_gram(padded["x"], coeffs) - want).abs().max()) <= 2.5e-4 * scale
    plain = precompute_gram_stencil(padded["angles"][:N_REAL], padded["shifts"][:N_REAL],
                                    dataclasses.replace(padded["cfgs"]["gram"],
                                                        num_aug=N_REAL, num_valid=0))
    assert float((coeffs - plain).abs().max()) <= 1e-6 * float(plain.abs().max())


@pytest.mark.parametrize("solver, bounds", [
    ("gram", (5e-3, 1e-4, 1e-4)), ("cg", (1e-4, 1e-6, 1e-5)),
    ("direct", (5e-3, 1e-4, 1e-4))])
def test_padded_solvers_match_jax(run, solver, bounds):
    """Each solver on the padded stack against JAX's: gram and CG on the
    padded stencil, direct on windows of 3 of the 7 real copies with 2
    dropped (JAX's weights, a 0 for the padded copy, and its order of the
    real copies handed in)."""
    padded = run["padded"]
    ref = padded["ref"]
    kw = {}
    if solver == "direct":
        kw = dict(copy_weights=torch.from_numpy(ref["weights"]),
                  perm=torch.from_numpy(ref["perm"]))
        assert ref["weights"][N_REAL] == 0 and int((ref["weights"] == 0).sum()) == 3
    else:
        kw = dict(gram_coeffs=padded["stencil"])
    x, loss = solve_with_draws(padded["masks"][0], padded["angles"], padded["shifts"],
                               padded["cfgs"][solver], **kw)
    err = np.abs(x.numpy() - ref[solver][0])
    max_err, mean_err, loss_rtol = bounds
    assert err.max() <= max_err and err.mean() <= mean_err, (err.max(), err.mean())
    np.testing.assert_allclose(float(loss), float(ref[solver][1]), rtol=loss_rtol)


def test_padded_max_mean_match_jax(run):
    """max (the padded copy -inf) and mean (over the 7 real copies) of one
    class and of two classes through one inverse warp, against JAX's: 1e-5."""
    padded = run["padded"]
    cfg, ref = padded["cfgs"]["gram"], padded["ref"]
    args = (padded["angles"], padded["shifts"], cfg)
    for got, want in zip(max_mean_superresolution(padded["masks"][0], *args),
                         ref["max_mean"]):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    for got, want in zip(multiclass_max_mean_superresolution(padded["masks"], *args),
                         ref["classes"]):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ---- (c) two gloo ranks against the JAX mesh programs -------------------------

def _assert_masks(got, want, class_id):
    assert set(np.unique(got)) <= {0.0, float(class_id)}
    agree = float((got == want).mean())
    assert agree >= MASK_AGREE, agree


@pytest.mark.parametrize("shape", ["1x2", "2x1"])
def test_sharded_asr_batch_matches_jax(run, shape):
    """make_asr_batch_fn on the ranks: (1, 2), one image, the 7 copies
    padded to 8 (4 a rank, the padded copy weighted 0), both ranks serving
    it; (2, 1), two images, one a rank. Masks of aug, max, mean and standard
    against JAX's (2, 1) mesh program on the same images (its first for the
    (1, 2) case), the aug target within 5e-3, the max and mean targets 1e-5."""
    want = run["refs"]["2x1"]
    outs = run["outs"]
    if shape == "1x2":
        got = {k.split("/", 1)[1]: v for k, v in outs[0].items() if k.startswith("1x2/")}
        for key, value in got.items():   # the aug ranks' SR results are equal
            if key != "standard":   # the identity copy's on aug index 0 only
                assert np.array_equal(outs[1][f"1x2/{key}"], value), key
    else:
        got = {k.split("/", 1)[1]: np.concatenate([outs[0][k], outs[1][k]])
               for k in outs[0] if k.startswith("2x1/")}
    n = 1 if shape == "1x2" else 2
    want = {key: value[:n] for key, value in want.items()}
    assert float((got["standard"] > 0).mean()) > 0.05
    for key in SR_TYPES + ("standard",):
        assert got[key].shape == (n, SIZE, SIZE, 1)
        _assert_masks(got[key], want[key], run["class_id"])
    err = np.abs(got["aug_target"] - want["aug_target"])
    assert err.max() <= TARGET_ATOL, err.max()
    for key in ("max_target", "mean_target"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5)


def test_run_asr_main_on_two_ranks_matches_jax(run):
    """run_asr.main --batch 2 with WORLD_SIZE 2: a (2, 1) mesh, 3 images in
    2 steps (the second ragged: rank 1 serves a repeat of the last image and
    writes nothing for it); every image's PNGs against JAX's (2, 1) program
    on the same decoded images (img2 is a copy of img1); the summary
    (every rank's) counts the run."""
    for out in run["outs"]:
        assert int(out["main/n_images"]) == 3 and int(out["main/steps"]) == 2
        assert out["main/mesh"].tolist() == [2, 1]
    want = run["refs"]["2x1"]
    for i, j in enumerate((0, 1, 1)):
        for key in SR_TYPES + ("standard",):
            _assert_masks(run["pngs"][f"img{i}_{key}"], want[key][j], run["class_id"])


def test_sharded_train_step_matches_jax(run):
    """One step on 2 ranks (2 of the 4 samples each, BatchNorm synchronised,
    the gradient all-reduced) against JAX's make_sharded_train_step on a
    (1, 2) mesh: the loss 1e-5 relative, the parameters, moving statistics
    and sgd's momentum trace (the gradient) as test_torch_train.py holds
    one card's step."""
    out = run["outs"][0]
    want_params, want_trace, want_loss = run["refs"]["train"]
    got_params, got_trace = {}, {}
    for key, value in out.items():
        if key.startswith("train/params/") or key.startswith("train/trace/"):
            _, kind, layer, name = key.split("/")
            (got_params if kind == "params" else got_trace).setdefault(layer, {})[name] = value
    assert float(out["train/loss"]) == pytest.approx(want_loss, rel=1e-5)
    _assert_step_close(got_params, got_trace, want_params, want_trace)
    for key, value in out.items():   # the ranks agree
        if key.startswith("train/"):
            assert np.array_equal(run["outs"][1][key], value), key
