"""Port parity: the gather warp (``ops/warp.py``) and what it unlocks in the
solver: the staged operator (shear f32, shear bf16, gather), its stencil,
the gather inverse warp of max/mean SR and every solver on the staged or
gather operator.

The same numpy inputs go through the JAX package and the PyTorch port (plain
versions on the CPU): 64-px planes, 3 copies, features at 16 px, angles to
0.15 (the CLI's default angle_max, which also sizes the JAX shear's static
taps). The JAX references are four jitted programs, each computed once for
the module (the warps, the operators, the stencils, the solves), compiled at
FAST_COMPILE (results may differ from the default compile's in the last
float32 bits). The run_asr and SR_single_class flags run in
tests/test_torch_pipeline.py and tests/test_torch_eval_cli.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_augmented_superresolution_tpu.ops import warp as jw
from deeplabv3plus_augmented_superresolution_tpu.pipeline import (
    make_augmented_copies as j_make_copies,
)
from deeplabv3plus_augmented_superresolution_tpu.sr import (
    OptimizerConfig as JOptimizerConfig,
    SRConfig as JSRConfig,
    augmented_superresolution as j_asr,
    forward_operator as j_forward_operator,
    max_superresolution as j_max_sr,
    mean_superresolution as j_mean_sr,
    precompute_gram_stencil as j_precompute_gram_stencil,
)
from deeplabv3plus_augmented_superresolution_tpu.sr.solver import (
    _dropout_weights as j_dropout_weights,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.ops import warp
from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
    make_augmented_copies,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
    OptimizerConfig,
    SRConfig,
    forward_operator,
    max_superresolution,
    mean_superresolution,
    multiclass_max_mean_superresolution,
    precompute_gram_stencil,
    solve_with_draws,
    stencil_cache_key,
)
from test_torch_shear import BF16_ULP_AT_1, compile_side_by_side, run_fast

torch.set_num_threads(1)

H = 64
N = 3
FEATURE = (16, 16)
SERVING = dict(learning_rate=1e-3, amsgrad=True, lr_scheduler=True, decay_steps=60,
               decay_rate=0.3)
BASE = dict(num_aug=N, feature_size=FEATURE, output_size=(H, H), angle_max=0.15,
            num_iter=8)
OPERATORS = {"shear-f32": dict(operator_impl="staged"),
             "shear-bf16": dict(operator_impl="staged", solve_dtype="bfloat16"),
             "gather": dict(warp_impl="gather")}


def _configs(**kw):
    return (JSRConfig(**BASE, optimizer=JOptimizerConfig(**SERVING), **kw),
            SRConfig(**BASE, optimizer=OptimizerConfig(**SERVING), **kw))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _tta(seed=4, angle_max=0.15, shift_max=8.0):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-angle_max, angle_max, N).astype(np.float32)
    shifts = rng.uniform(-shift_max, shift_max, (N, 2)).astype(np.float32)
    angles[0], shifts[0] = 0.0, 0.0
    return angles, shifts


def _smooth(k, seed):
    """(k, H, H) smooth planes in [0, 1] (bilinear upsamples of 8 x 8 noise)."""
    low = np.random.default_rng(seed).uniform(0, 1, (k, 8, 8)).astype(np.float32)
    return np.stack([np.kron(p, np.ones((8, 8), np.float32)) for p in low])


@pytest.fixture(scope="module")
def warp_refs():
    """The warp-level JAX references, one jitted program: the transforms;
    rotate, translate and the two-pass warp of a (3, 64, 64, 3) batch and of
    its bf16 rounding, bilinear and nearest; the two-pass warp's vjp for an
    f32 and a bf16 image; rotate_translate_fused and affine_warp of one
    image with fill 0.5 and another output size; make_augmented_copies with
    the gather warp of a bf16 image; max and mean SR through the gather
    inverse warp."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (N, H, H, 3)).astype(np.float32)
    cot = rng.standard_normal((N, H, H, 3)).astype(np.float32)
    masks = rng.uniform(0, 1, (2, N) + FEATURE + (1,)).astype(np.float32)
    angles, shifts = _tta(2)
    jcfg = _configs(warp_impl="gather")[0]

    def refs(x32, c, m, a, s):
        x16 = x32.astype(jnp.bfloat16)
        out = {"transforms": [jw.rotation_transform(a, 48, 64),
                              jw.rotation_transform(0.3, 64, 64),
                              jw.translation_transform(s),
                              jw.translation_transform([2.5, -1.0])]}
        out["transforms"].append(jw.compose_transforms(out["transforms"][0],
                                                       out["transforms"][2]))
        for mode in ("bilinear", "nearest"):
            for name, x in (("f32", x32), ("bf16", x16)):
                rot = jw.rotate(x, a, mode)
                out[f"{mode}-{name}"] = [r.astype(jnp.float32) for r in (
                    rot, jw.translate(x, s, mode), jw.translate(rot, s, mode))]

        def two_pass(z):
            return jw.translate(jw.rotate(z, a), s)

        out["vjp"] = [jax.vjp(two_pass, x)[1](c)[0].astype(jnp.float32)
                      for x in (x32, x16)]
        t = jw.rotation_transform(0.2, H, H)[0]
        out["affine"] = [t, jw.rotate_translate_fused(x32, a, s),
                         jw.affine_warp(x32[0], t, "bilinear", 0.5, (40, 70)),
                         jw.affine_warp(x32[0], t, "nearest", 0.5, (40, 70))]
        out["copies"] = j_make_copies(x16[0], a, s, N, warp_impl="gather")
        out["max_mean"] = [j_max_sr(m[0], a, s, jcfg)[0], j_mean_sr(m[0], a, s, jcfg)[0]]
        return out

    ref = run_fast(jax.jit(refs), *(jnp.asarray(v) for v in (img, cot, masks, angles,
                                                              shifts)))
    return img, cot, masks, angles, shifts, jax.tree.map(np.asarray, ref)


def test_transforms_match_jax(warp_refs):
    """rotation_transform (vector and scalar angles, a non-square image),
    translation_transform (a batch and one shift) and compose_transforms
    equal JAX's to 1e-6 relative + 2e-6: cos and sin may differ by an f32
    ulp, which the offsets carry times the image size."""
    _, _, _, angles, shifts, ref = warp_refs
    ours = [warp.rotation_transform(torch.from_numpy(angles), 48, 64),
            warp.rotation_transform(0.3, 64, 64),
            warp.translation_transform(torch.from_numpy(shifts)),
            warp.translation_transform([2.5, -1.0])]
    ours.append(warp.compose_transforms(ours[0], ours[2]))
    for got, want in zip(ours, ref["transforms"]):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_two_pass_warp_matches_jax(warp_refs, mode):
    """rotate, translate and rotate-then-translate, of an f32 image and of its
    bf16 rounding. Bilinear returns f32 for both (the f32 weights promote the
    bf16 reads, as in JAX): 2e-5, where sample points differ by the
    transforms' f32 ulps (a few 1e-6 px at 64 px). Nearest keeps the input's
    dtype and reads input values: equal except where such an ulp moves a
    sample point across a rounding boundary, which these inputs never do
    (held exactly)."""
    img, _, _, angles, shifts, ref = warp_refs
    ta, ts = _t(angles, shifts)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = torch.from_numpy(img).to(dtype)
        rot = warp.rotate(x, ta, mode)
        ours = (rot, warp.translate(x, ts, mode), warp.translate(rot, ts, mode))
        want = torch.float32 if mode == "bilinear" else dtype
        for got, r in zip(ours, ref[f"{mode}-{name}"]):
            assert got.dtype == want and tuple(got.shape) == (N, H, H, 3)
            if mode == "nearest":
                np.testing.assert_array_equal(got.float().numpy(), r)
            else:
                np.testing.assert_allclose(got.numpy(), r, atol=2e-5)


def test_fused_warp_and_affine_options_match_jax(warp_refs):
    """rotate_translate_fused (one resample of the composed transform), and
    affine_warp of one (H, W, C) image with one transform, fill 0.5 and
    another output size, bilinear and nearest: 2e-5 as the two-pass warp."""
    img, _, _, angles, shifts, ref = warp_refs
    t, *want = ref["affine"]
    x, ta, ts, tt = _t(img, angles, shifts, t)
    ours = (warp.rotate_translate_fused(x, ta, ts),
            warp.affine_warp(x[0], tt, "bilinear", 0.5, (40, 70)),
            warp.affine_warp(x[0], tt, "nearest", 0.5, (40, 70)))
    assert ours[1].shape == (40, 70, 3) and float(ours[1].min()) <= 0.5
    for got, r in zip(ours, want):
        np.testing.assert_allclose(got.numpy(), r, atol=2e-5)
    with pytest.raises(ValueError, match="interpolation"):
        warp.rotate(x, ta, "bicubic")


def test_gather_warp_gradient_matches_jax_vjp(warp_refs):
    """The two-pass warp's gradient (the scatter-add of the taps' weighted
    cotangents) against jax.vjp, for an f32 image (2e-5 of the gradient's
    scale: float32 sums of up to 16 terms per pixel in another order) and
    for a bf16 image (JAX scatter-adds in bf16, the port accumulates in f32
    and rounds once: within 2 bf16 ulps of the gradient's scale)."""
    img, cot, _, angles, shifts, ref = warp_refs
    ta, ts, tc = _t(angles, shifts, cot)
    for dtype, want, tol in ((torch.float32, ref["vjp"][0], 2e-5),
                             (torch.bfloat16, ref["vjp"][1], 2 * BF16_ULP_AT_1)):
        x = torch.from_numpy(img).to(dtype).requires_grad_(True)
        (got,) = torch.autograd.grad(warp.translate(warp.rotate(x, ta), ts), x, tc)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=tol * np.abs(want).max())


def test_gather_copies_match_jax(warp_refs):
    """make_augmented_copies with warp_impl="gather" (the reference's
    translate(rotate(...)) of the broadcast image): a bf16 image gives f32
    copies, 2e-5 from JAX's; a batch of two images equals each image's copies
    bit for bit; copy 0 is the image."""
    img, _, _, angles, shifts, ref = warp_refs
    x, ta, ts = _t(img[:2], angles, shifts)
    x16 = x.to(torch.bfloat16)
    ours = make_augmented_copies(x16[0], ta, ts, N, warp_impl="gather")
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (N, H, H, 3)
    np.testing.assert_allclose(ours.numpy(), ref["copies"], atol=2e-5)
    np.testing.assert_allclose(ours[0].numpy(), x16[0].float().numpy(), atol=1e-6)
    both = make_augmented_copies(x16, ta, ts, N, warp_impl="gather")
    assert tuple(both.shape) == (N, 2, H, H, 3)
    for i in range(2):
        torch.testing.assert_close(both[:, i],
                                   make_augmented_copies(x16[i], ta, ts, N, warp_impl="gather"),
                                   rtol=0, atol=0)


def test_max_mean_through_the_gather_inverse_warp_match_jax(warp_refs):
    """max and mean SR with warp_impl="gather" (upsample, translate(-shifts),
    rotate(-angles)) against JAX's: 2e-5 as the warp; two classes through
    one inverse warp equal each class alone bit for bit. With the last copy
    padding (num_valid) max and mean are those of the other copies, and the
    operator applies every copy."""
    _, _, masks, angles, shifts, ref = warp_refs
    _, cfg = _configs(warp_impl="gather")
    tm, ta, ts = _t(masks, angles, shifts)
    mx, mean = max_superresolution(tm[0], ta, ts, cfg)[0], \
        mean_superresolution(tm[0], ta, ts, cfg)[0]
    for got, r in zip((mx, mean), ref["max_mean"]):
        assert tuple(got.shape) == (H, H, 1)
        np.testing.assert_allclose(got.numpy(), r, atol=2e-5)
    both_max, both_mean = multiclass_max_mean_superresolution(tm, ta, ts, cfg)
    torch.testing.assert_close(both_max[0], mx, rtol=0, atol=0)
    torch.testing.assert_close(both_mean[0], mean, rtol=0, atol=0)
    second = max_superresolution(tm[1], ta, ts, cfg)[0]
    torch.testing.assert_close(both_max[1], second, rtol=0, atol=0)
    padded = dataclasses.replace(cfg, num_valid=N - 1)
    real = dataclasses.replace(cfg, num_aug=N - 1)
    for fn in (max_superresolution, mean_superresolution):
        torch.testing.assert_close(fn(tm[0], ta, ts, padded)[0],
                                   fn(tm[0, :N - 1], ta[:N - 1], ts[:N - 1], real)[0],
                                   rtol=0, atol=1e-6)
    plane = torch.rand((1, H, H))
    torch.testing.assert_close(forward_operator(plane, ta, ts, FEATURE, padded),
                               forward_operator(plane, ta, ts, FEATURE, cfg), rtol=0, atol=0)


@pytest.fixture(scope="module")
def operator_refs():
    """JAX forward_operator for each staged operator, on one plane each of
    three (the reference's vmap over classes), and forward_operator(...,
    cfg=None); one jitted program. (Their adjoints are held through the
    stencils and the solvers below.)"""
    planes = _smooth(3, 11)
    angles, shifts = _tta(12)
    jcfgs = {name: _configs(**kw)[0] for name, kw in OPERATORS.items()}

    def refs(x, a, s):
        out = {name: jax.vmap(lambda z, cfg=cfg: j_forward_operator(
            z[None, ..., None], a, s, FEATURE, cfg))(x) for name, cfg in jcfgs.items()}
        out["default"] = j_forward_operator(x[0][None, ..., None], a, s, FEATURE)
        return out

    ref = run_fast(jax.jit(refs), *(jnp.asarray(v) for v in (planes, angles, shifts)))
    return planes, angles, shifts, {name: np.asarray(r) for name, r in ref.items()}


# The staged operator: f32 shear and gather within 2e-5 of JAX (f32 passes,
# the resize matmul, the warps' f32 trig); the bf16 shear: JAX blends each
# pass in bf16, the port in f32 with one rounding per pass, so every pass
# may differ by a bf16 ulp: three of them on values in [0, 1].
FORWARD_TOL = {"shear-f32": 2e-5, "shear-bf16": 3 * BF16_ULP_AT_1, "gather": 2e-5}


@pytest.mark.parametrize("name", list(OPERATORS))
def test_staged_operator_matches_jax(operator_refs, name):
    """forward_operator on one (1, H, W, 1) plane and on K = 3 (K, H, W)
    planes (one application: (N, h, w, K)) against the JAX operator per
    plane; the K planes' adjoint through autograd equals each plane's alone;
    cfg=None is the gather operator (JAX's default)."""
    planes, angles, shifts, ref = operator_refs
    _, cfg = _configs(**OPERATORS[name])
    ta, ts = _t(angles, shifts)
    tol = FORWARD_TOL[name]
    one = forward_operator(torch.from_numpy(planes[0])[None, ..., None], ta, ts,
                           FEATURE, cfg)
    assert one.dtype == torch.float32 and tuple(one.shape) == (N,) + FEATURE + (1,)
    np.testing.assert_allclose(one.numpy(), ref[name][0], atol=tol)
    x = torch.from_numpy(planes).requires_grad_(True)
    stack = forward_operator(x, ta, ts, FEATURE, cfg)
    assert tuple(stack.shape) == (N,) + FEATURE + (3,)
    np.testing.assert_allclose(stack.detach().permute(3, 0, 1, 2).numpy(),
                               ref[name][..., 0], atol=tol)
    cot = torch.rand(stack.shape, generator=torch.Generator().manual_seed(13))
    (adj,) = torch.autograd.grad(stack, x, cot)
    for k in range(3):
        xk = x[k:k + 1].detach().requires_grad_(True)
        (alone,) = torch.autograd.grad(forward_operator(xk, ta, ts, FEATURE, cfg), xk,
                                       cot[..., k:k + 1])
        torch.testing.assert_close(adj[k:k + 1], alone, rtol=0, atol=0)
    if name == "gather":
        default = forward_operator(torch.from_numpy(planes[0])[None, ..., None], ta, ts,
                                   FEATURE)
        torch.testing.assert_close(default, one, rtol=0, atol=0)
        np.testing.assert_allclose(default.numpy(), ref["default"], atol=tol)


def _masks(k, seed):
    """(k, N, h, w, 1) LR observations of k rectangles through the port's
    fused operator, with noise so that the copies disagree as model masks do."""
    angles, shifts = _tta(17)
    gt = np.zeros((k, H, H), np.float32)
    for i in range(k):
        gt[i, 12 + 4 * i:44 + 2 * i, 10 + 4 * i:50 - 2 * i] = 1.0
    lr = forward_operator(*_t(gt, angles, shifts), FEATURE, _configs()[1])
    noise = np.random.default_rng(seed).uniform(-0.1, 0.1, (k, N) + FEATURE + (1,))
    return (lr.permute(3, 0, 1, 2)[..., None].numpy() + noise).astype(np.float32)


# (solver config, classes, JAX stencil handed to both sides, bounds (max,
# mean, loss rtol)). Adam's normalized steps can take either sign where the
# gradient cancels: max 5e-3, mean 1e-4 and the last loss to 1e-4 relative,
# as tests/test_torch_solvers.py; CG has no normalized steps, but its IRLS
# weights 0.5 / max(|D x|, 1e-3) magnify where |D x| nears 1e-3 the f32
# differences of b (the gather adjoint's scatter-add sums in another order
# than JAX's): 1e-4 max, 1e-5 mean, the objective 1e-5 relative. The bf16
# operator's passes differ by bf16 ulps (FORWARD_TOL), which its 8 steps
# carry into the target: 3 ulps.
SOLVES = {
    "gram-staged-3-classes": (dict(operator_impl="staged", solver_impl="gram"), 3,
                              "shear-f32", (5e-3, 1e-4, 1e-4)),
    "cg-gather": (dict(warp_impl="gather", solver_impl="cg", cg_outer=2, cg_inner=4), 1,
                  "gather", (1e-4, 1e-5, 1e-5)),
    "direct-gather-minibatch-dropout": (
        dict(warp_impl="gather", solver_impl="direct", sgd_copies=2, copy_dropout=0.34),
        1, None, (5e-3, 1e-4, 1e-4)),
    "direct-staged-bf16-2-classes": (
        dict(operator_impl="staged", solve_dtype="bfloat16", solver_impl="direct"), 2,
        None, (3 * BF16_ULP_AT_1, 3 * BF16_ULP_AT_1 / 4, 3 * BF16_ULP_AT_1)),
}


@pytest.fixture(scope="module")
def solver_refs():
    """JAX's own precompute_gram_stencil (35 aliased probes) on the staged
    shear and the gather operator, then, in a second jitted program
    (compiled beside the first), each of
    SOLVES through JAX's augmented_superresolution (classes by vmap; gram
    and CG on those stencils; the minibatch solve with key 1, whose dropout
    weights and copy order it returns too)."""
    angles, shifts = _tta(17)
    masks = {name: _masks(k, 18) for name, (_, k, _, _) in SOLVES.items()}
    stencil_cfgs = {name: _configs(**OPERATORS[name])[0] for name in ("shear-f32", "gather")}

    def solves(m, stencils, a, s):
        out = {}
        for name, (kw, _, stencil, _) in SOLVES.items():
            jcfg = _configs(**kw)[0]
            key = jax.random.key(1) if jcfg.sgd_copies else None
            coeffs = None if stencil is None else stencils[stencil]
            out[name] = jax.vmap(lambda one: j_asr(one, a, s, jcfg, key, coeffs))(m[name])
            if key is not None:
                out[name] += (j_dropout_weights(key, jcfg),
                              jax.random.permutation(jax.random.fold_in(key, 997), N))
        return out

    a, s = jnp.asarray(angles), jnp.asarray(shifts)
    m = {k: jnp.asarray(v) for k, v in masks.items()}
    stencil_fn = jax.jit(lambda a, s: {name: j_precompute_gram_stencil(a, s, cfg)
                                       for name, cfg in stencil_cfgs.items()})
    solves_fn = jax.jit(solves)
    stencil_prog, solves_prog = compile_side_by_side(
        stencil_fn.lower(a, s), solves_fn.lower(m, jax.eval_shape(stencil_fn, a, s), a, s))
    stencils = stencil_prog(a, s)
    ref = solves_prog(m, stencils, a, s)
    ref["stencils"] = stencils
    return angles, shifts, masks, jax.tree.map(np.asarray, ref)


@pytest.mark.parametrize("name", ["shear-f32", "gather"])
def test_staged_stencil_matches_jax(solver_refs, name):
    """precompute_gram_stencil (35 aliased probes) through the staged
    operator against JAX's own precompute_gram_stencil on the same config:
    1e-5 of the coefficient scale (tests/test_gram.py holds the staged
    stencil at 1e-5). The stencil's cache keys tell the operators apart."""
    angles, shifts, _, ref = solver_refs
    _, cfg = _configs(**OPERATORS[name])
    want = ref["stencils"][name]
    ours = precompute_gram_stencil(*_t(angles, shifts), cfg).numpy()
    assert ours.shape == want.shape == (7, 9, H, H)
    np.testing.assert_allclose(ours, want, atol=1e-5 * np.abs(want).max())
    fused = _configs()[1]
    assert stencil_cache_key(angles, shifts, cfg) != stencil_cache_key(angles, shifts, fused)


@pytest.mark.parametrize("name", list(SOLVES))
def test_solvers_match_jax(solver_refs, name):
    """augmented_superresolution on the staged or gather operator: gram on 3
    classes at once and IRLS-CG, each on JAX's stencil (the extraction is
    held in test_staged_stencil_matches_jax); the direct solver on
    minibatches of 2 of the 3 copies with one copy dropped (JAX's draws from
    key 1, handed to solve_with_draws); the direct solver with the bf16
    operator on 2 classes."""
    angles, shifts, masks, ref = solver_refs
    kw, k, stencil, (max_err, mean_err, loss_rtol) = SOLVES[name]
    _, cfg = _configs(**kw)
    ref_x, ref_loss, *draws = ref[name]
    draws = [torch.from_numpy(np.array(d)) for d in draws] or [None, None]
    coeffs = None if stencil is None else _t(ref["stencils"][stencil])[0]
    x, loss = solve_with_draws(*_t(masks[name], angles, shifts), cfg, *draws,
                               gram_coeffs=coeffs)
    assert tuple(x.shape) == (k, H, H, 1) and tuple(loss.shape) == (k,)
    err = np.abs(x.numpy() - ref_x)
    assert err.max() <= max_err and err.mean() <= mean_err, (err.max(), err.mean())
    np.testing.assert_allclose(loss.numpy(), ref_loss, rtol=loss_rtol)
