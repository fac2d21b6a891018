"""The SR inverse solve on the precomputed Gram stencil.

Port of the JAX package's ``sr/solver.py`` for the serving path
(``solver_impl="gram"``): the forward operator A (per-copy warp + bilinear
downsample), the Gram stencil of G = sum_i A_i^T A_i, b = A^T y through
autograd, and the optimizer loop on

  lambda_df (x^T G x - 2 b^T x + |y|^2) + lambda_tv TV(x) + lambda_L2 |x|^2
  (+ lambda_L1 |x|_1, or BTV in place of TV).

Three solvers, as the reference's ``solver_impl``: "gram" (the optimizer
on the stencil), "cg" (IRLS with preconditioned conjugate gradients on the
same normal equations) and "direct" (the optimizer on the objective with
the operator applied in every step, through autograd and the shear
kernels), the last also with copy minibatching (``sgd_copies``). Copy
dropout weights the copies 0/1 on every path. Each loop is a Python loop of
eager steps (the reference's lax.scan); a leading class axis runs K solves
in the same steps (the reference's vmap). max/mean SR reduce the
inverse-warped copies. Aug-axis padding (``num_valid``) raises until
``parallel/`` is ported.

Random draws (the dropout mask, the minibatch order) come from a
``torch.Generator``, whose stream differs from jax.random's, so the tests
hand both packages the same draws through ``solve_with_draws``.
"""

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..ops.fused_operator import fused_warp_downsample
from ..ops.gradients import (abs_, bilateral_tv, image_gradients,
                              image_gradients_transpose, total_variation)
from ..ops.gram import (RADIUS_X, RADIUS_Y, apply_gram, extract_gram_stencil,
                        extract_gram_stencil_aliased, stencil_weights)
from ..ops.resize import resize, resize_hw
from ..ops.shear_warp import inverse_shifts, paeth_planes
from .optimizer import OptimizerConfig, make_optimizer

SOLVERS = ("gram", "cg", "direct")
# Seed of the minibatch order when the solve is given no generator (the
# reference folds 997 into its default key, so its order is fixed too).
MINIBATCH_SEED = 997
NOT_PORTED_GATHER = "ROADMAP Queue 1: 'ops/warp.py'"
NOT_PORTED_PADDING = "ROADMAP Queue 1: 'parallel/'"


@dataclasses.dataclass(frozen=True)
class SRConfig:
    """Same fields and defaults as the reference's SRConfig."""
    lambda_df: float = 1.0
    lambda_tv: float = 0.3
    lambda_L2: float = 0.7
    lambda_L1: float = 0.0
    num_iter: int = 300
    num_aug: int = 100
    feature_size: Tuple[int, int] = (128, 128)
    output_size: Tuple[int, int] = (512, 512)
    use_BTV: bool = False
    copy_dropout: float = 0.0
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    warp_impl: str = "shear"
    angle_max: float = 0.35
    operator_impl: str = "fused"
    solve_dtype: str = "float32"
    solver_impl: str = "direct"
    sgd_copies: int = 0
    gram_probing: str = "aliased"
    cg_outer: int = 6
    cg_inner: int = 15
    cg_eps: float = 1e-3
    num_valid: int = 0

    @property
    def n_valid(self) -> int:
        return self.num_valid or self.num_aug


def _stage(timer, name: str):
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


def forward_operator(target: torch.Tensor, angles: torch.Tensor,
                     shifts: torch.Tensor, feature_size,
                     cfg: Optional[SRConfig] = None) -> torch.Tensor:
    """A(x): per-copy warp of the HR estimate + bilinear downsample.

    target: (1, H, W, 1), or K planes (K, H, W); returns (N, h, w, K)."""
    if cfg is None or cfg.warp_impl != "shear":
        raise NotImplementedError(f"the gather warp is not ported yet ({NOT_PORTED_GATHER})")
    if cfg.num_valid and cfg.num_valid != cfg.num_aug:
        raise NotImplementedError(f"aug-axis padding is not ported yet ({NOT_PORTED_PADDING})")
    if cfg.operator_impl != "fused":
        raise NotImplementedError(f"operator_impl={cfg.operator_impl!r} is not ported "
                                  f"yet ({NOT_PORTED_GATHER}); use 'fused'")
    return fused_warp_downsample(target, angles, shifts, tuple(feature_size),
                                 cfg.angle_max)


def _normal_op(fwd: Callable[[torch.Tensor], torch.Tensor]):
    """x -> A^T A x through autograd (the vjp of fwd with cotangent fwd(x))."""
    def normal_op(x: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            z = x.detach().requires_grad_(True)
            out = fwd(z)
            (g,) = torch.autograd.grad(out, z, grad_outputs=out.detach())
        return g
    return normal_op


def _extract(cfg: SRConfig):
    return (extract_gram_stencil_aliased if cfg.gram_probing == "aliased"
            else extract_gram_stencil)


def precompute_gram_stencil(angles: torch.Tensor, shifts: torch.Tensor,
                            cfg: SRConfig) -> torch.Tensor:
    """Stencil coefficients (Sy, Sx, H, W) of G for a FIXED augmentation set,
    reusable by every solve that shares (angles, shifts, cfg)."""
    def fwd(z):
        return forward_operator(z, angles, shifts, cfg.feature_size, cfg)

    return _extract(cfg)(_normal_op(fwd), tuple(cfg.output_size),
                         RADIUS_Y, RADIUS_X, device=angles.device)


def _copy_axis_last(lr_masks: torch.Tensor) -> torch.Tensor:
    """(K, N, h, w, 1) mask stacks -> (N, h, w, K), the operator's layout."""
    return lr_masks[..., 0].permute(1, 2, 3, 0)


def _weigh(x: torch.Tensor, copy_weights: Optional[torch.Tensor]) -> torch.Tensor:
    """x (N, ...) with copy i scaled by copy_weights[i]."""
    if copy_weights is None:
        return x
    return x * copy_weights.reshape((-1,) + (1,) * (x.dim() - 1))


def sr_loss(target: torch.Tensor, lr_masks: torch.Tensor, angles: torch.Tensor,
            shifts: torch.Tensor, cfg: SRConfig,
            copy_weights: Optional[torch.Tensor] = None,
            df_scale: float = 1.0) -> torch.Tensor:
    """Data fidelity + lambda_tv TV (or BTV) + lambda_L2 |x|^2 (+ lambda_L1 |x|),
    sums as in the reference; df_scale rescales the data term of a copy
    minibatch so that its gradient stays unbiased.

    target (1, H, W, 1) with lr_masks (N, h, w, 1) gives the scalar loss;
    target (K, H, W, 1) with lr_masks (K, N, h, w, 1) gives the (K,) losses
    of K classes, whose planes ride one operator application."""
    single = lr_masks.dim() == 4
    if single:
        lr_masks = lr_masks[None]
    lr_est = forward_operator(target[..., 0], angles, shifts, cfg.feature_size, cfg)
    sq = _weigh(torch.square(lr_est - _copy_axis_last(lr_masks)), copy_weights)
    df = sq.sum(dim=(0, 1, 2)) * df_scale
    loss = cfg.lambda_df * df + _reg_values(target, cfg)
    return loss[0] if single else loss


def dropout_weights(generator: Optional[torch.Generator],
                    cfg: SRConfig) -> Optional[torch.Tensor]:
    """0/1 copy weights with int(n_valid * copy_dropout) zeros in an order
    drawn from generator (CPU float32), or None when nothing is dropped: no
    generator (the reference's ``dropout_key=None``) or no whole copy to drop."""
    n_valid = cfg.n_valid
    n_drop = int(n_valid * cfg.copy_dropout)
    if n_drop == 0 or generator is None:
        return None
    base = torch.cat([torch.zeros(n_drop), torch.ones(n_valid - n_drop)])
    return base[torch.randperm(n_valid, generator=generator)]


def minibatch_permutation(generator: Optional[torch.Generator],
                          n_valid: int) -> torch.Tensor:
    """The one upfront order of the copies that the minibatch windows walk;
    fixed (seeded MINIBATCH_SEED) when no generator is given."""
    if generator is None:
        generator = torch.Generator().manual_seed(MINIBATCH_SEED)
    return torch.randperm(n_valid, generator=generator)


def _gram_system(target, lr_masks, angles, shifts, cfg: SRConfig, gram_coeffs,
                 copy_weights=None):
    """(coeffs, b, y_const) of the normal equations G x = b for K classes at
    once: target (K, H, W, 1), lr_masks (K, N, h, w, 1); b (K, H, W, 1) and
    y_const (K,). The K planes ride one operator application: one forward and
    one autograd backward, whatever K is. Copy weights fold in exactly: a 0/1
    weight w_i scales A_i, so G = sum w_i A_i^T A_i and b = sum w_i A_i^T y_i;
    a precomputed stencil cannot carry a dropout mask and raises."""
    def fwd(z):
        # (K, H, W) planes -> (N, h, w, K)
        return _weigh(forward_operator(z[..., 0], angles, shifts, cfg.feature_size,
                                       cfg), copy_weights)

    if gram_coeffs is None:
        coeffs = _extract(cfg)(_normal_op(fwd), tuple(cfg.output_size),
                               RADIUS_Y, RADIUS_X, device=target.device)
    else:
        if int(cfg.n_valid * cfg.copy_dropout) > 0:
            raise ValueError("precomputed gram_coeffs cannot be combined with "
                             "copy_dropout (the mask changes per solve)")
        coeffs = gram_coeffs
    if copy_weights is not None:
        lr_masks = _weigh(lr_masks.transpose(0, 1), copy_weights).transpose(0, 1)
    with torch.enable_grad():
        z = torch.zeros_like(target, requires_grad=True)
        (b,) = torch.autograd.grad(fwd(z), z, grad_outputs=_copy_axis_last(lr_masks))
    y_const = _per_class(torch.square(lr_masks))
    return coeffs, b, y_const


def _per_class(x: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the leading class axis."""
    return x.sum(dim=tuple(range(1, x.dim())))


def _reg_grad(z: torch.Tensor, cfg: SRConfig) -> torch.Tensor:
    """Gradient of the regularizers (TV or BTV, L2, L1). The classes do not
    couple, so the gradient of their sum is each class's own gradient."""
    with torch.enable_grad():
        z = z.detach().requires_grad_(True)
        tv = bilateral_tv(z) if cfg.use_BTV else total_variation(z)
        loss = cfg.lambda_tv * tv + cfg.lambda_L2 * torch.sum(torch.square(z))
        if cfg.lambda_L1 > 0.0:
            loss = loss + cfg.lambda_L1 * torch.sum(abs_(z))
        (grad,) = torch.autograd.grad(loss, z)
    return grad


def _reg_values(z: torch.Tensor, cfg: SRConfig) -> torch.Tensor:
    """(K,) values of the regularizers, one per class."""
    tv_fn = bilateral_tv if cfg.use_BTV else total_variation
    tv = torch.stack([tv_fn(z[k:k + 1]) for k in range(z.shape[0])])
    loss = cfg.lambda_tv * tv + cfg.lambda_L2 * _per_class(torch.square(z))
    if cfg.lambda_L1 > 0.0:
        loss = loss + cfg.lambda_L1 * _per_class(abs_(z))
    return loss


def _gram_solve(target, lr_masks, angles, shifts, cfg: SRConfig,
                gram_coeffs=None, timer=None, copy_weights=None):
    """Optimizer loop with the data-term gradient 2 (G x - b) from the
    stencil: the same objective and gradients as the direct solver.

    K classes at once, as the reference's vmap over classes: target
    (K, H, W, 1) and lr_masks (K, N, h, w, 1) share one stencil; each element
    keeps its own optimizer state. Returns ((K, H, W, 1), (K,) final losses)."""
    with _stage(timer, "b"):
        coeffs, b, y_const = _gram_system(target, lr_masks, angles, shifts, cfg,
                                          gram_coeffs, copy_weights)
    with _stage(timer, "solve_steps"):
        weights = stencil_weights(coeffs)
        opt = make_optimizer(cfg.optimizer, target)
        tgt = target
        loss = None
        for it in range(cfg.num_iter):
            gx = apply_gram(tgt, coeffs, weights=weights)
            if it == cfg.num_iter - 1:  # the reference reports the last step's loss
                df_val = _per_class(tgt * gx) - 2.0 * _per_class(tgt * b) + y_const
                loss = cfg.lambda_df * df_val + _reg_values(tgt, cfg)
            grads = cfg.lambda_df * (2.0 * (gx - b)) + _reg_grad(tgt, cfg)
            tgt = opt.step(tgt, grads)
    return tgt, loss


def _cg_solve(target, lr_masks, angles, shifts, cfg: SRConfig, gram_coeffs=None,
              timer=None, copy_weights=None):
    """Second-order solve on the Gram system: lagged-diffusivity IRLS for the
    non-smooth TV (and L1) terms, Jacobi-preconditioned CG for each quadratic
    subproblem

        (lambda_df G + lambda_tv D^T W D + lambda_L2 I + lambda_L1 W_l) x
            = lambda_df b,

    cg_outer reweightings (w = 0.5 / max(|D x|, cg_eps) at the current x) of
    cg_inner CG steps each, warm-started; one stencil apply per step. K
    classes at once: every inner product (r.z, p.Ap, alpha, beta) is per
    class, so the classes do not couple. Returns ((K, H, W, 1), (K,) true
    objectives, not the smoothed ones). BTV has no IRLS form here."""
    if cfg.use_BTV:
        raise ValueError("solver_impl='cg' does not support use_BTV; "
                         "use solver_impl='gram'")
    with _stage(timer, "b"):
        coeffs, b, y_const = _gram_system(target, lr_masks, angles, shifts, cfg,
                                          gram_coeffs, copy_weights)
    with _stage(timer, "solve_steps"):
        weights = stencil_weights(coeffs)
        rhs = cfg.lambda_df * b
        eps = cfg.cg_eps  # masks live in [0, 1]
        l1 = cfg.lambda_L1 > 0.0

        def per_class_dot(u, v):
            return _per_class(u * v)[:, None, None, None]

        def matvec(p, wy, wx, wl):
            dy, dx = image_gradients(p)
            out = (cfg.lambda_df * apply_gram(p, coeffs, weights=weights)
                   + cfg.lambda_tv * image_gradients_transpose(wy * dy, wx * dx)
                   + cfg.lambda_L2 * p)
            return out + cfg.lambda_L1 * wl * p if l1 else out

        x = target
        for _ in range(cfg.cg_outer):
            dy, dx = image_gradients(x)
            wy = 0.5 / torch.clamp_min(dy.abs(), eps)
            wx = 0.5 / torch.clamp_min(dx.abs(), eps)
            wl = 0.5 / torch.clamp_min(x.abs(), eps) if l1 else None
            # Jacobi preconditioner: the diagonal of the system.
            diag_tv = (wy + torch.nn.functional.pad(wy[:, :-1], (0, 0, 0, 0, 1, 0))
                       + wx + torch.nn.functional.pad(wx[:, :, :-1], (0, 0, 1, 0)))
            diag = (cfg.lambda_df * coeffs[RADIUS_Y, RADIUS_X][None, :, :, None]
                    + cfg.lambda_tv * diag_tv + cfg.lambda_L2)
            if l1:
                diag = diag + cfg.lambda_L1 * wl
            inv_diag = 1.0 / diag
            r = rhs - matvec(x, wy, wx, wl)
            z = inv_diag * r
            p = z
            rz = per_class_dot(r, z)
            for _ in range(cfg.cg_inner):
                ap = matvec(p, wy, wx, wl)
                alpha = rz / torch.clamp_min(per_class_dot(p, ap), 1e-30)
                x = x + alpha * p
                r = r - alpha * ap
                z = inv_diag * r
                rz_new = per_class_dot(r, z)
                beta = rz_new / torch.clamp_min(rz, 1e-30)
                p = z + beta * p
                rz = rz_new
        df_val = (_per_class(x * apply_gram(x, coeffs, weights=weights))
                  - 2.0 * _per_class(x * b) + y_const)
        loss = cfg.lambda_df * df_val + _reg_values(x, cfg)
    return x, loss


def _direct_solve(target, lr_masks, angles, shifts, cfg: SRConfig, timer=None,
                  copy_weights=None, perm=None):
    """Optimizer loop on sr_loss itself: every step applies the operator (the
    copies' warps and downsamples, through the shear kernels) and
    differentiates the objective by autograd, the K class planes riding one
    application. With perm (a copy minibatch), the copies are put in that
    order once, its head of sgd_copies appended, and step i reads the
    contiguous window starting at (i * sgd_copies) % n_valid, its data term
    scaled by n_valid / sgd_copies. Returns ((K, H, W, 1), (K,) losses of the
    last step)."""
    n_valid = cfg.n_valid
    window, scale = n_valid, 1.0
    if perm is not None:
        window, scale = cfg.sgd_copies, n_valid / cfg.sgd_copies
        perm = perm.to(lr_masks.device)

        def ordered(t, dim=0):
            t = t.index_select(dim, perm)
            return torch.cat([t, t.narrow(dim, 0, window)], dim)

        lr_masks, angles, shifts = ordered(lr_masks, 1), ordered(angles), ordered(shifts)
        if copy_weights is not None:
            copy_weights = ordered(copy_weights)
    with _stage(timer, "solve_steps"):
        opt = make_optimizer(cfg.optimizer, target)
        tgt = target
        loss = None
        for it in range(cfg.num_iter):
            cut = slice((it * window) % n_valid, (it * window) % n_valid + window)
            cw = copy_weights[cut] if copy_weights is not None else None
            with torch.enable_grad():
                z = tgt.detach().requires_grad_(True)
                losses = sr_loss(z, lr_masks[:, cut], angles[cut], shifts[cut], cfg,
                                 cw, scale)
                (grads,) = torch.autograd.grad(losses.sum(), z)
            loss = losses.detach()  # the reference reports the last step's
            tgt = opt.step(tgt, grads)
    return tgt, loss


@torch.no_grad()
def solve_with_draws(lr_masks: torch.Tensor, angles: torch.Tensor,
                     shifts: torch.Tensor, cfg: SRConfig,
                     copy_weights: Optional[torch.Tensor] = None,
                     perm: Optional[torch.Tensor] = None,
                     gram_coeffs: Optional[torch.Tensor] = None,
                     timer=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``augmented_superresolution`` with its random draws given as tensors:
    copy_weights (num_aug,) 0/1, or None for every copy; perm (n_valid,),
    the minibatch order, used when sgd_copies minibatches (drawn from
    MINIBATCH_SEED when None)."""
    if cfg.solver_impl not in SOLVERS:
        raise ValueError(f"solver_impl must be one of {SOLVERS}, got "
                         f"{cfg.solver_impl!r}")
    classes = lr_masks.dim() == 5
    if not classes:
        lr_masks = lr_masks[None]
    if copy_weights is not None:
        copy_weights = copy_weights.to(device=lr_masks.device, dtype=torch.float32)
    target = resize(lr_masks[:, 0], cfg.output_size, method="bilinear")
    minibatch = 0 < cfg.sgd_copies < cfg.n_valid
    if cfg.solver_impl == "gram" and not minibatch:
        out, loss = _gram_solve(target, lr_masks, angles, shifts, cfg, gram_coeffs,
                                timer, copy_weights)
    elif cfg.solver_impl == "cg" and not minibatch:
        out, loss = _cg_solve(target, lr_masks, angles, shifts, cfg, gram_coeffs,
                              timer, copy_weights)
    else:
        if gram_coeffs is not None:
            raise ValueError("gram_coeffs requires solver_impl='gram'/'cg' "
                             "without copy minibatching")
        if minibatch and perm is None:
            perm = minibatch_permutation(None, cfg.n_valid)
        out, loss = _direct_solve(target, lr_masks, angles, shifts, cfg, timer,
                                  copy_weights, perm if minibatch else None)
    return (out, loss) if classes else (out[0], loss[0])


@torch.no_grad()
def augmented_superresolution(lr_masks: torch.Tensor, angles: torch.Tensor,
                              shifts: torch.Tensor, cfg: SRConfig,
                              gram_coeffs: Optional[torch.Tensor] = None,
                              timer=None,
                              dropout_generator: Optional[torch.Generator] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve argmin_x of the SR objective with cfg.solver_impl: "gram" and
    "direct" take cfg.num_iter optimizer steps, "cg" cfg.cg_outer x
    cfg.cg_inner CG steps; 0 < sgd_copies < num_aug runs the direct solver on
    copy minibatches whatever solver_impl says, as the reference does.

    lr_masks: (num_aug, h, w, 1) normalized LR masks; returns ((H, W, 1) HR
    estimate, final loss). With a leading class axis, (K, num_aug, h, w, 1),
    the K solves run together and return ((K, H, W, 1), (K,) losses): the
    reference's jax.vmap of this function over classes. Initialization is the
    bilinear upsample of the first (identity) copy. gram_coeffs: a stencil
    from precompute_gram_stencil for the SAME (angles, shifts, cfg), for
    "gram" and "cg"; extracted here when absent. timer: optional object with
    a ``stage(name)`` context manager, given the stages "b" (gram and cg) and
    "solve_steps". dropout_generator: draws the copy-dropout mask
    (cfg.copy_dropout) and then the minibatch order; without it no copy is
    dropped (the reference's ``dropout_key=None``) and the order is fixed.
    """
    copy_weights = dropout_weights(dropout_generator, cfg)
    perm = None
    if 0 < cfg.sgd_copies < cfg.n_valid:
        perm = minibatch_permutation(dropout_generator, cfg.n_valid)
    return solve_with_draws(lr_masks, angles, shifts, cfg, copy_weights, perm,
                            gram_coeffs, timer)


def _inverse_warp(lr_masks: torch.Tensor, angles, shifts, cfg: SRConfig) -> torch.Tensor:
    """Shared body of max/mean SR: upsample every copy of every class, then
    undo translation and rotation. lr_masks (K, N, h, w, 1) -> a dense
    (N, K, H, W) stack: the K planes of copy n share its inverse warp, so the
    three kernel launches of one warp serve every class."""
    if cfg.warp_impl != "shear":
        raise NotImplementedError(f"the gather warp is not ported yet ({NOT_PORTED_GATHER})")
    if cfg.n_valid != cfg.num_aug:  # padded copies would need masking out
        raise NotImplementedError(f"aug-axis padding is not ported yet ({NOT_PORTED_PADDING})")
    up = resize_hw(lr_masks[..., 0], cfg.output_size, "bilinear")   # (K, N, H, W)
    inv_angles, inv_shifts = inverse_shifts(angles, shifts)
    return paeth_planes(up.transpose(0, 1), inv_angles, inv_shifts)


@torch.no_grad()
def max_superresolution(lr_masks, angles, shifts, cfg: SRConfig):
    """(H, W, 1) pixelwise max over the inverse-warped copies, None."""
    up = _inverse_warp(lr_masks[None], angles, shifts, cfg)
    return up.amax(dim=0)[0, ..., None], None


@torch.no_grad()
def mean_superresolution(lr_masks, angles, shifts, cfg: SRConfig):
    """(H, W, 1) pixelwise mean over the inverse-warped copies, None."""
    up = _inverse_warp(lr_masks[None], angles, shifts, cfg)
    return up.mean(dim=0)[0, ..., None], None


@torch.no_grad()
def max_mean_superresolution(lr_masks, angles, shifts, cfg: SRConfig):
    """(max SR, mean SR), each (H, W, 1), from ONE shared inverse warp."""
    mx, mean = multiclass_max_mean_superresolution(lr_masks[None], angles, shifts, cfg)
    return mx[0], mean[0]


@torch.no_grad()
def multiclass_max_mean_superresolution(lr_masks, angles, shifts, cfg: SRConfig):
    """(K, num_aug, h, w, 1) per-class stacks -> ((K, H, W, 1) max SR,
    (K, H, W, 1) mean SR) from one inverse warp of all K classes."""
    up = _inverse_warp(lr_masks, angles, shifts, cfg)
    return up.amax(dim=0)[..., None], up.mean(dim=0)[..., None]


SR_FUNCTIONS = {
    "aug": augmented_superresolution,
    "max": max_superresolution,
    "mean": mean_superresolution,
}
