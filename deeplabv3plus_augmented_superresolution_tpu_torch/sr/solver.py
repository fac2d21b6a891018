"""The SR inverse solve on the precomputed Gram stencil.

Port of the JAX package's ``sr/solver.py`` for the serving path
(``solver_impl="gram"``): the forward operator A (per-copy warp + bilinear
downsample), the Gram stencil of G = sum_i A_i^T A_i, b = A^T y through
autograd, and the optimizer loop on

  lambda_df (x^T G x - 2 b^T x + |y|^2) + lambda_tv TV(x) + lambda_L2 |x|^2
  (+ lambda_L1 |x|_1, or BTV in place of TV).

The loop is a Python loop of eager steps (the reference's lax.scan); a
leading class axis runs K solves in the same steps (the reference's vmap).
max/mean SR reduce the inverse-warped copies. The direct and CG solvers,
copy minibatching, copy dropout and aug-axis padding raise until they are
ported.
"""

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..ops.fused_operator import fused_warp_downsample
from ..ops.gradients import abs_, bilateral_tv, total_variation
from ..ops.gram import (RADIUS_X, RADIUS_Y, apply_gram, extract_gram_stencil,
                        extract_gram_stencil_aliased, stencil_weights)
from ..ops.resize import resize, resize_hw
from ..ops.shear_warp import inverse_shifts, paeth_planes
from .optimizer import Adam, OptimizerConfig

NOT_PORTED_SOLVERS = ("ROADMAP Queue 1: 'the direct and CG solvers, minibatching "
                      "and dropout'")
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


def _gram_system(target, lr_masks, angles, shifts, cfg: SRConfig, gram_coeffs):
    """(coeffs, b, y_const) of the normal equations G x = b for K classes at
    once: target (K, H, W, 1), lr_masks (K, N, h, w, 1); b (K, H, W, 1) and
    y_const (K,). The K planes ride one operator application: one forward and
    one autograd backward, whatever K is."""
    def fwd(z):
        # (K, H, W) planes -> (N, h, w, K)
        return forward_operator(z[..., 0], angles, shifts, cfg.feature_size, cfg)

    if gram_coeffs is None:
        coeffs = _extract(cfg)(_normal_op(fwd), tuple(cfg.output_size),
                               RADIUS_Y, RADIUS_X, device=target.device)
    else:
        coeffs = gram_coeffs
    with torch.enable_grad():
        z = torch.zeros_like(target, requires_grad=True)
        (b,) = torch.autograd.grad(fwd(z), z,
                                   grad_outputs=lr_masks[..., 0].permute(1, 2, 3, 0))
    y_const = torch.sum(torch.square(lr_masks), dim=(1, 2, 3, 4))
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
                gram_coeffs=None, timer=None):
    """Optimizer loop with the data-term gradient 2 (G x - b) from the
    stencil: the same objective and gradients as the direct solver.

    K classes at once, as the reference's vmap over classes: target
    (K, H, W, 1) and lr_masks (K, N, h, w, 1) share one stencil; each element
    keeps its own AMSGrad state. Returns ((K, H, W, 1), (K,) final losses)."""
    with _stage(timer, "b"):
        coeffs, b, y_const = _gram_system(target, lr_masks, angles, shifts, cfg,
                                          gram_coeffs)
    with _stage(timer, "solve_steps"):
        weights = stencil_weights(coeffs)
        opt = Adam(cfg.optimizer, target)
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


@torch.no_grad()
def augmented_superresolution(lr_masks: torch.Tensor, angles: torch.Tensor,
                              shifts: torch.Tensor, cfg: SRConfig,
                              gram_coeffs: Optional[torch.Tensor] = None,
                              timer=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve argmin_x of the SR objective by cfg.num_iter optimizer steps.

    lr_masks: (num_aug, h, w, 1) normalized LR masks; returns ((H, W, 1) HR
    estimate, final loss). With a leading class axis, (K, num_aug, h, w, 1),
    the K solves run together and return ((K, H, W, 1), (K,) losses): the
    reference's jax.vmap of this function over classes. Initialization is the
    bilinear upsample of the first (identity) copy. gram_coeffs: a stencil
    from precompute_gram_stencil for the SAME (angles, shifts, cfg);
    extracted here when absent. timer: optional object with a
    ``stage(name)`` context manager, given the stages "b" and "solve_steps".
    """
    if cfg.solver_impl != "gram":
        raise NotImplementedError(f"solver_impl={cfg.solver_impl!r} is not ported "
                                  f"yet ({NOT_PORTED_SOLVERS}); use 'gram'")
    if 0 < cfg.sgd_copies < cfg.n_valid or cfg.copy_dropout > 0.0:
        raise NotImplementedError("copy minibatching and copy dropout are not "
                                  f"ported yet ({NOT_PORTED_SOLVERS})")
    classes = lr_masks.dim() == 5
    if not classes:
        lr_masks = lr_masks[None]
    target = resize(lr_masks[:, 0], cfg.output_size, method="bilinear")
    out, loss = _gram_solve(target, lr_masks, angles, shifts, cfg, gram_coeffs, timer)
    return (out, loss) if classes else (out[0], loss[0])


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
