"""Precomputed Gram operator for the SR data-fidelity term.

Port of the JAX package's ``ops/gram.py``. G = sum_i A_i^T A_i couples only
HR pixels that share an LR sample of some copy, so it is a spatially-varying
stencil with small static support: c[dy + Ry, dx + Rx][u] = G[u, u - delta].
It is extracted once by probing the normal operator with comb images and
applied as a (2Ry+1) x (2Rx+1)-tap stencil.

Aliased extraction (the default) probes at x period Rx+1 instead of 2Rx+1
and disentangles the aliased offset pairs exactly through G's symmetry: 35
probes instead of 63 at the default radii. See the reference module for the
derivation; the arithmetic here is the same.
"""

from typing import Callable, Tuple

import torch

RADIUS_Y = 3
RADIUS_X = 4

NormalOp = Callable[[torch.Tensor], torch.Tensor]


def _comb(h: int, w: int, period_y: int, period_x: int, py: int, px: int,
          device) -> torch.Tensor:
    yy = torch.arange(h, device=device)
    xx = torch.arange(w, device=device)
    comb = ((yy[:, None] % period_y) == py) & ((xx[None, :] % period_x) == px)
    return comb.to(torch.float32)[None, :, :, None]


def _probe_responses(normal_op: NormalOp, h: int, w: int, period_y: int,
                     period_x: int, device) -> torch.Tensor:
    """(period_y, period_x, H, W) responses of the normal operator to combs."""
    rows = []
    for py in range(period_y):
        rows.append(torch.stack([
            normal_op(_comb(h, w, period_y, period_x, py, px, device))[0, :, :, 0]
            for px in range(period_x)]))
    return torch.stack(rows)


def _select_phase(resp: torch.Tensor, offsets_y: torch.Tensor,
                  offsets_x: torch.Tensor) -> torch.Tensor:
    """out[i, j, y, x] = resp[(y - offsets_y[i]) % Py, (x - offsets_x[j]) % Px, y, x]:
    the response of the probe whose comb point sits at offset (i, j) from u."""
    py, px, h, w = resp.shape
    yy = torch.arange(h, device=resp.device)
    xx = torch.arange(w, device=resp.device)
    vy = (yy[None, :] - offsets_y[:, None]) % py                   # (I, H)
    vx = (xx[None, :] - offsets_x[:, None]) % px                   # (J, W)
    return resp[vy[:, None, :, None], vx[None, :, None, :],
                yy[None, None, :, None], xx[None, None, None, :]]


def extract_gram_stencil(normal_op: NormalOp, output_size: Tuple[int, int],
                         radius_y: int = RADIUS_Y, radius_x: int = RADIUS_X,
                         *, device) -> torch.Tensor:
    """Coefficient maps c (Sy, Sx, H, W) with c[dy+Ry, dx+Rx][u] = G[u, u-delta].

    normal_op: x (1, H, W, 1) -> (G x) (1, H, W, 1). One probe per offset
    ((2Ry+1) * (2Rx+1) probes)."""
    h, w = output_size
    sy, sx = 2 * radius_y + 1, 2 * radius_x + 1
    resp = _probe_responses(normal_op, h, w, sy, sx, device)
    dy = torch.arange(-radius_y, radius_y + 1, device=device)
    dx = torch.arange(-radius_x, radius_x + 1, device=device)
    return _select_phase(resp, dy, dx)


def _shift2d(m: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = m[y + dy, x + dx], zero fill (static dy/dx)."""
    h, w = m.shape
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    padded = torch.nn.functional.pad(m, (px1, px0, py1, py0))
    return padded[py1 + dy:py1 + dy + h, px1 + dx:px1 + dx + w]


def _reverse_strided_cumsum(t: torch.Tensor, stride: int) -> torch.Tensor:
    """c[y, x] = sum_{k>=0} t[y, x + stride*k] (the closed form of the
    recurrence c[x] = t[x] + c[x + stride])."""
    h, w = t.shape
    wp = -(-w // stride) * stride
    t5 = torch.nn.functional.pad(t, (0, wp - w)).reshape(h, wp // stride, stride)
    c5 = torch.flip(torch.cumsum(torch.flip(t5, (1,)), dim=1), (1,))
    return c5.reshape(h, wp)[:, :w]


def extract_gram_stencil_aliased(normal_op: NormalOp,
                                 output_size: Tuple[int, int],
                                 radius_y: int = RADIUS_Y,
                                 radius_x: int = RADIUS_X,
                                 *, device) -> torch.Tensor:
    """Same coefficients as extract_gram_stencil from (2Ry+1)*(Rx+1) probes.

    Probing at x period P = Rx+1 puts offsets dx and dx-P into one response,
    S[dy, a] = c_(dy, a) + c_(dy, a-P) for a in [1, Rx]. G's symmetry turns
    each pair into the recurrence c_(dy, a)[y, x] = T[y, x] + c_(dy, a)[y, x+P]
    with T[y, x] = S[dy, a][y, x] - S[-dy, P-a][y - dy, x + P - a], solved by
    a reverse stride-P cumulative sum; then c_(dy, a-P) = S[dy, a] - c_(dy, a).
    """
    h, w = output_size
    sy = 2 * radius_y + 1
    px = radius_x + 1
    resp = _probe_responses(normal_op, h, w, sy, px, device)
    dy_off = torch.arange(-radius_y, radius_y + 1, device=device)
    a_off = torch.arange(px, device=device)
    s_maps = _select_phase(resp, dy_off, a_off)                    # (Sy, Px, H, W)

    sx = 2 * radius_x + 1
    coeffs = [[None] * sx for _ in range(sy)]
    for iy in range(sy):
        dy = iy - radius_y
        coeffs[iy][radius_x] = s_maps[iy, 0]                       # dx = 0, direct
        for a in range(1, px):
            t = s_maps[iy, a] - _shift2d(s_maps[sy - 1 - iy, px - a], -dy, px - a)
            c_pos = _reverse_strided_cumsum(t, px)                 # dx = a
            coeffs[iy][radius_x + a] = c_pos
            coeffs[iy][radius_x + a - px] = s_maps[iy, a] - c_pos
    return torch.stack([torch.stack(row) for row in coeffs])       # (Sy, Sx, H, W)


def stencil_weights(coeffs: torch.Tensor) -> torch.Tensor:
    """The stencil in the (H, W, Sy, Sx) window order ``apply_gram`` reads:
    window (a, b) of the padded image is x[u - delta] with
    delta = (Ry - a, Rx - b), so coefficients are flipped on both stencil axes."""
    return coeffs.flip(0, 1).permute(2, 3, 0, 1).contiguous()


def apply_gram(x: torch.Tensor, coeffs: torch.Tensor,
               radius_y: int = RADIUS_Y, radius_x: int = RADIUS_X,
               weights: torch.Tensor = None) -> torch.Tensor:
    """(G x) for x (K, H, W, 1), K = 1 or one plane per class: sum over delta
    of c_delta[u] * x[u - delta], the one stencil applied to every plane.

    weights: ``stencil_weights(coeffs)``, for callers that apply one stencil
    many times (computed here when absent)."""
    if weights is None:
        weights = stencil_weights(coeffs)
    img = x[..., 0]
    padded = torch.nn.functional.pad(img, (radius_x, radius_x, radius_y, radius_y))
    windows = padded.unfold(1, 2 * radius_y + 1, 1).unfold(2, 2 * radius_x + 1, 1)
    return (windows * weights).sum(dim=(-2, -1))[..., None]
