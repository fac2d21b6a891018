"""Whether what the timed ``serve`` wrote is correct.

After the window, a sample of the served images (drawn from the seed) is
run through the plain reference (``reference/``): the same scene, the same
weights dict, the TTA set drawn again by ``tta.py``, float32 with TF32 off.
Every mask ``serve`` wrote for those images (each SR type's and the
standard mask, per class, and the label maps) is read back from its PNG and
held against the reference's decision, pixel by pixel, where that decision
is certain.

A decision is uncertain where a sound program may take it either way:

  * in a copy, an LR pixel whose class logit lies within a band (a share of
    the image's logit range) of the best other class: ``margin_band`` in
    the identity copy, where only the network's rounding may flip it, and
    ``copy_margin_band`` in the warped copies, whose input the program's
    shear warp also interpolates otherwise than the exact warp. The
    reference solves each plane twice, with every such pixel off ("lo") and
    on ("hi"); an SR pixel is certain only where both give the same
    decision;
  * an SR estimate that does not clear, by ``estimate_band``, every
    threshold (th_factor x the plane's peak) between the two solves' (aug:
    in the masks' units, 0 to 1; max and mean: as a share of the peak): the
    program's shear warp and Gram stencil approximate the reference's exact
    operator. A
    label-map pixel is certain where the winner's score (estimate over the
    class's peak) stays above every other's, estimates and peaks moved by up
    to ``estimate_band``; a class whose peak is within it of 0 (absent from
    the copies: its plane is the regularizer's round-off) can score anything;
  * an SR or label-map pixel within ``border_band`` pixels of the frame:
    the program's three shear passes zero-fill what an intermediate pass
    moves out of the frame, which the exact warp keeps (the mean of the
    copies there differs by up to a quarter of its peak);
  * a standard-mask pixel (or standard label) whose upsampled logits lie
    within ``margin_band`` of a tie.

The bands are ``BANDS``. Three numbers are compared, each with its limit in
the workload file (``check.limits``): ``violation_pct``, the largest share
of a plane's pixels that are certain and decided otherwise;
``flip_margin``, the largest logit margin (a share of the image's logit
range) at which a standard-mask pixel or standard label is decided
otherwise than the reference decides it: the depth of the network's error
where it shows; and ``solve_miss_pct``, the share of the solve's moved
pixels that the program's aug masks leave where the solve started. 300
AMSGrad steps move an estimate by less than ``estimate_band``, so the
first number cannot see the solve; a moved pixel is one (off the rim) that
the reference's solve takes across the threshold from the side on which
its start (the upsampled identity copy, thresholded alike) lies, in both
the "lo" and the "hi" solve. It is pooled over the sample's aug planes (0
where nothing moved). ``uncertain_pct`` (reported, not compared) is the
largest share of a plane left uncertain.
"""

import contextlib
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from .reference import asr as ref_asr
from .reference import deeplab as ref_net
from .tta import tta_set

BANDS = {"margin_band": 0.01, "copy_margin_band": 0.1, "estimate_band": 0.1,
         "border_band": 16}


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN convolutions, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def plane_files(name: str, class_ids: Sequence[int], sr_types: Sequence[str],
                label_map: bool) -> Dict[str, str]:
    """Plane key -> the file ``serve`` writes for it."""
    keys = sorted(set(sr_types) | {"standard"})
    if len(class_ids) == 1:
        files = {f"{k}_c{class_ids[0]}": f"{name}_{k}.png" for k in keys}
    else:
        files = {f"{k}_c{c}": f"{name}_{k}_c{c}.png" for k in keys for c in class_ids}
    if label_map:
        files["labelmap"] = f"{name}_labelmap.png"
        files["labelmap_standard"] = f"{name}_labelmap_standard.png"
    return files


def class_margins(logits: torch.Tensor, class_ids: Sequence[int]) -> torch.Tensor:
    """(..., classes) logits -> (K, ...) margins: each class's logit minus
    the best other class's, over the logits' range."""
    span = torch.clamp_min(logits.amax() - logits.amin(), 1e-30)
    top2 = logits.topk(2, dim=-1).values
    out = []
    for c in class_ids:
        lc = logits[..., c]
        other = torch.where(lc >= top2[..., 0], top2[..., 1], top2[..., 0])
        out.append((lc - other) / span)
    return torch.stack(out)


def normalize(on: torch.Tensor, class_ids: Sequence[int]) -> torch.Tensor:
    """(K, N, h, w) bool masks -> the program's normalised stacks: each class
    {0, class id}, min-max over its stack (a constant stack gives 0)."""
    ids = torch.as_tensor(class_ids, dtype=torch.float32, device=on.device)
    m = on.float() * ids[:, None, None, None]
    lo = m.amin(dim=(1, 2, 3), keepdim=True)
    hi = m.amax(dim=(1, 2, 3), keepdim=True)
    return (m - lo) / torch.where(hi > lo, hi - lo, torch.ones_like(hi))


@torch.no_grad()
def image_states(scenes: List[np.ndarray], weights, cfg: dict, class_ids, device,
                 precision: str = "float32", block: int = 20) -> List[dict]:
    """Per scene, what the reference network gives: the copies' class
    margins (K, N, h, w) and the identity copy's upsampled logits
    (classes, H, W)."""
    asr = cfg["asr"]
    angles, shifts = (t.to(device) for t in tta_set(asr["tta_seed"], asr["num_aug"],
                                                    asr["angle_max"], asr["shift_max"]))
    states = []
    with exact_float32():
        for scene in scenes:
            image = torch.as_tensor(scene, device=device).permute(2, 0, 1)
            copies = ref_asr.warp(image[None].expand(asr["num_aug"], *image.shape),
                                  angles, shifts)
            logits = ref_net.logits(weights, copies.permute(0, 2, 3, 1), cfg, precision,
                                    block)
            del copies
            states.append({"margins": class_margins(logits, class_ids),
                           "up": ref_asr.resize(logits[0].permute(2, 0, 1),
                                                cfg["input_size"])})
            del logits
    return states


def _targets(masks: List[torch.Tensor], cfg: dict, sr_types) -> List[Dict[str, torch.Tensor]]:
    """(K, N, h, w) normalised stacks -> per stack {sr type: (K, H, W)}, the
    aug solves of every stack run side by side."""
    asr = cfg["asr"]
    size = tuple(cfg["input_size"])
    angles, shifts = (t.to(masks[0].device) for t in tta_set(
        asr["tta_seed"], asr["num_aug"], asr["angle_max"], asr["shift_max"]))
    out: List[Dict[str, torch.Tensor]] = [{} for _ in masks]
    with exact_float32():
        if "aug" in sr_types:
            stacked = torch.cat(masks)
            # A class absent from every copy leaves the solve the
            # regularizer's round-off (at most the steps' summed learning
            # rate, under estimate_band): its plane is uncertain either way,
            # so it is not solved.
            present = stacked.flatten(1).amax(dim=1) > 0
            solved = torch.zeros((stacked.shape[0],) + size, device=stacked.device)
            if bool(present.any()):
                solved[present] = ref_asr.aug_solve(stacked[present], angles, shifts, asr,
                                                    size)
            for t, m, part in zip(out, masks, solved.split([m.shape[0] for m in masks])):
                t["aug"] = part
                t["start"] = ref_asr.resize(m[:, 0], size)
        if "max" in sr_types or "mean" in sr_types:
            for t, m in zip(out, masks):
                t["max"], t["mean"] = ref_asr.max_mean(m, angles, shifts, size)
    return out


def decisions(state: dict, targets: Dict[str, torch.Tensor], class_ids, sr_types,
              th: float, label_map: bool) -> Dict[str, torch.Tensor]:
    """One network's planes, decided plainly (the control's)."""
    out = {}
    for kind in sr_types:
        for k, c in enumerate(class_ids):
            out[f"{kind}_c{c}"] = ref_asr.threshold(targets[kind], th)[k]
    labels = state["up"].argmax(dim=0)
    for c in class_ids:
        out[f"standard_c{c}"] = labels == c
    if label_map:
        out["labelmap"] = ref_asr.label_map(targets["aug"], class_ids, th)
        out["labelmap_standard"] = labels
    return out


def _side(target: torch.Tensor, th: float) -> torch.Tensor:
    """(K, H, W) -> above th x each plane's peak."""
    return target > target.amax(dim=(-2, -1), keepdim=True) * th


def envelope_planes(state: dict, lo: Dict[str, torch.Tensor], hi: Dict[str, torch.Tensor],
                    class_ids, sr_types, th: float, label_map: bool) -> Dict[str, dict]:
    """Per plane {"want": the reference's decision, "certain": where it is};
    aug planes also {"moved": the solve's moved pixels, "moved_to": the
    side it takes them to}."""
    tau, delta = BANDS["estimate_band"], BANDS["margin_band"]
    h, w = state["up"].shape[-2:]
    rim = BANDS["border_band"]
    inner = torch.zeros((h, w), dtype=torch.bool, device=state["up"].device)
    inner[rim:h - rim, rim:w - rim] = True
    out = {}
    for kind in sr_types:
        # The value and the threshold (th_factor x the peak) both move
        # monotonically between the two solves: a pixel is certain where
        # its value clears every threshold in reach by the band.
        t_lo, t_hi = lo[kind], hi[kind]
        peaks = (t_lo.amax(dim=(-2, -1), keepdim=True), t_hi.amax(dim=(-2, -1), keepdim=True))
        limit_lo, limit_hi = torch.minimum(*peaks) * th, torch.maximum(*peaks) * th
        # aug carries the solve's round-off on absent classes: its band is
        # in mask units; max and mean scale with their masks.
        width = tau if kind == "aug" else tau * torch.maximum(*peaks)
        above = torch.minimum(t_lo, t_hi) - limit_hi > width
        below = torch.maximum(t_lo, t_hi) - limit_lo < -width
        certain = (above | below) & inner
        for k, c in enumerate(class_ids):
            out[f"{kind}_c{c}"] = {"want": above[k], "certain": certain[k]}
        if kind == "aug":
            start, solved = _side(lo["start"], th), _side(lo["aug"], th)
            moved = ((start == _side(hi["start"], th)) & (solved == _side(hi["aug"], th))
                     & (solved != start) & inner)
            for k, c in enumerate(class_ids):
                out[f"aug_c{c}"].update(moved=moved[k], moved_to=solved[k])
    up = state["up"]
    std = class_margins(up.permute(1, 2, 0), class_ids)
    for k, c in enumerate(class_ids):
        out[f"standard_c{c}"] = {"want": std[k] > 0, "certain": std[k].abs() >= delta,
                                 "margin": std[k].abs()}
    if label_map:
        want = ref_asr.label_map(lo["aug"], class_ids, th)
        low, high = _score_bounds(lo["aug"], hi["aug"], tau, th)
        winner = torch.where(want > 0, _index_of(want, class_ids), len(class_ids))
        w_low = torch.gather(low, 0, winner[None])[0]
        others = high.scatter(0, winner[None], -torch.inf).amax(dim=0)
        certain = ((ref_asr.label_map(hi["aug"], class_ids, th) == want) & (w_low > others)
                   & inner)
        out["labelmap"] = {"want": want, "certain": certain}
        span = torch.clamp_min(up.amax() - up.amin(), 1e-30)
        top2 = up.topk(2, dim=0).values
        out["labelmap_standard"] = {"want": up.argmax(dim=0),
                                    "certain": (top2[0] - top2[1]) / span >= delta,
                                    "logits": up / span}
    return out


def _index_of(labels: torch.Tensor, class_ids) -> torch.Tensor:
    """Class ids -> their index in class_ids."""
    table = torch.zeros(int(max(class_ids)) + 1, dtype=torch.long, device=labels.device)
    table[torch.as_tensor(class_ids, device=labels.device)] = torch.arange(
        len(class_ids), device=labels.device)
    return table[labels.long()]


def _score_bounds(t_lo: torch.Tensor, t_hi: torch.Tensor, tau: float, th: float):
    """Bounds of the label-map scores (each class's estimate over its peak;
    the background's th_factor last) that estimates within tau of either
    solve's can take. A class whose peak is within tau of 0 is unbounded."""
    lows, highs = [], []
    for t in (t_lo, t_hi):
        peak = t.amax(dim=(-2, -1), keepdim=True)
        lows.append((t - tau) / (peak + tau))
        highs.append(torch.where(peak > tau, (t + tau) / (peak - tau).clamp_min(1e-12),
                                 torch.full_like(t, torch.inf)))
    low, high = torch.minimum(*lows), torch.maximum(*highs)
    bg = torch.full_like(low[:1], th)
    return torch.cat([low, bg]), torch.cat([high, bg])


def reference_planes(states: List[dict], cfg: dict, class_ids, sr_types, label_map: bool
                     ) -> List[Dict[str, dict]]:
    """The certain decisions of every sampled image (``envelope_planes``)."""
    delta = torch.full((states[0]["margins"].shape[1], 1, 1), BANDS["copy_margin_band"],
                       device=states[0]["margins"].device)
    delta[0] = BANDS["margin_band"]
    lo_masks = [normalize(s["margins"] > delta, class_ids) for s in states]
    hi_masks = [normalize(s["margins"] > -delta, class_ids) for s in states]
    targets = _targets(lo_masks + hi_masks, cfg, sr_types)
    n = len(states)
    return [envelope_planes(s, targets[i], targets[n + i], class_ids, sr_types,
                            cfg["asr"]["th_factor"], label_map)
            for i, s in enumerate(states)]


def control_decisions(states: List[dict], cfg: dict, class_ids, sr_types,
                      label_map: bool) -> List[Dict[str, torch.Tensor]]:
    """The planes a network of these states decides (the control's)."""
    masks = [normalize(s["margins"] > 0, class_ids) for s in states]
    targets = _targets(masks, cfg, sr_types)
    return [decisions(s, t, class_ids, sr_types, cfg["asr"]["th_factor"], label_map)
            for s, t in zip(states, targets)]


def compare(got: Dict[str, object], ref: Dict[str, dict], device) -> Dict[str, dict]:
    """Per plane: {"violation_pct", "uncertain_pct"}; for the standard
    planes "flip_margin": the largest logit margin (a share of the logit
    range) of a pixel decided otherwise than the reference; for the aug
    planes the counts "solve_moved" and "solve_missed" (moved pixels left
    where the solve started). got: plane key -> the decided (H, W) mask or
    labels; a missing plane is wholly wrong."""
    out = {}
    for key, r in ref.items():
        uncertain = float((~r["certain"]).float().mean()) * 100.0
        if key not in got:
            out[key] = {"violation_pct": 100.0, "uncertain_pct": uncertain}
            if "margin" in r or "logits" in r:
                out[key]["flip_margin"] = 1.0
            if "moved" in r:
                moved = int(r["moved"].sum())
                out[key].update(solve_moved=moved, solve_missed=moved)
            continue
        g = torch.as_tensor(np.array(got[key]), device=device)
        if key.startswith("labelmap"):
            differ = g.long() != r["want"].long()
        else:
            differ = (g > 0) != r["want"]
        out[key] = {"violation_pct": float((differ & r["certain"]).float().mean()) * 100.0,
                    "uncertain_pct": uncertain}
        if "moved" in r:
            missed = ((g > 0) != r["moved_to"]) & r["moved"]
            out[key].update(solve_moved=int(r["moved"].sum()), solve_missed=int(missed.sum()))
        if "margin" in r:
            depth = r["margin"]
        elif "logits" in r:
            labels = g.long().clamp(0, r["logits"].shape[0] - 1)
            depth = (r["logits"].amax(dim=0)
                     - torch.gather(r["logits"], 0, labels[None])[0])
        else:
            continue
        out[key]["flip_margin"] = float(depth[differ].max()) if bool(differ.any()) else 0.0
    return out


def reference(scenes: List[np.ndarray], weights, cfg: dict, class_ids, wl: dict, device
              ) -> List[Dict[str, dict]]:
    """The reference's certain decisions for each scene (``reference_planes``)."""
    states = image_states(scenes, weights, cfg, class_ids, device)
    return reference_planes(states, cfg, class_ids, wl["sr_types"], wl["label_map"])


def control(scenes: List[np.ndarray], weights, cfg: dict, class_ids, wl: dict, device
            ) -> List[Dict[str, np.ndarray]]:
    """What the control decides for each scene: the reference with its
    network in float8 (e4m3), put in the program's place."""
    states = image_states(scenes, weights, cfg, class_ids, device, precision="fp8")
    return [{k: v.cpu().numpy() for k, v in c.items()}
            for c in control_decisions(states, cfg, class_ids, wl["sr_types"],
                                       wl["label_map"])]


def served(out_dir: str, names: Sequence[str], class_ids, wl: dict
           ) -> List[Dict[str, np.ndarray]]:
    """What ``serve`` wrote under out_dir for the images ``names``."""
    return [read_masks(out_dir, plane_files(n, class_ids, wl["sr_types"], wl["label_map"]))
            for n in names]


def judge(got: List[Dict[str, object]], refs: List[Dict[str, dict]], device) -> dict:
    """{"numbers": the numbers compared, "by_kind": the worst per kind}."""
    planes = [compare(g, r, device) for g, r in zip(got, refs)]
    return {"numbers": summarize(planes), "by_kind": by_kind(planes)}


def is_correct(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (each number has one)."""
    return all(value <= limits[k] for k, value in numbers.items())


def read_masks(out_dir: str, files: Dict[str, str]) -> Dict[str, np.ndarray]:
    """The PNGs ``serve`` wrote, as (H, W) arrays of class ids."""
    from PIL import Image

    got = {}
    for key, fname in files.items():
        path = os.path.join(out_dir, fname)
        if os.path.exists(path):
            with Image.open(path) as img:
                got[key] = np.array(img)
    return got


def summarize(per_plane: List[Dict[str, dict]]) -> Dict[str, float]:
    """The numbers compared: the worst plane of the sample, and the moved
    pixels missed over all of them. The max planes are read (``by_kind``)
    but not compared: each of their pixels follows the one most extreme of
    100 copies, which the program takes on a shear-warped input and the
    reference on an exactly warped one."""
    planes = [p for image in per_plane for k, p in image.items()
              if not k.startswith("max_")]
    moved = sum(p.get("solve_moved", 0) for p in planes)
    missed = sum(p.get("solve_missed", 0) for p in planes)
    return {"violation_pct": max(p["violation_pct"] for p in planes),
            "flip_margin": max(p.get("flip_margin", 0.0) for p in planes),
            "solve_miss_pct": 100.0 * missed / moved if moved else 0.0}


def by_kind(per_plane: List[Dict[str, dict]]) -> Dict[str, Dict[str, float]]:
    """Per output kind (aug, max, mean, standard, the label maps) the worst
    violation and uncertain shares, and the moved and missed pixels summed."""
    out: Dict[str, Dict[str, float]] = {}
    for image in per_plane:
        for key, p in image.items():
            d = out.setdefault(key.split("_c")[0], {})
            for name, value in p.items():
                d[name] = (d.get(name, 0) + value if name.startswith("solve_")
                           else max(d.get(name, 0.0), value))
    return out


def sample_images(scenes: List[np.ndarray], count: int, seed: int, weights, cfg: dict,
                  class_ids, device, min_share: float = 0.005) -> List[int]:
    """Indexes of ``count`` served images drawn from the seed: in an order
    drawn from it, first those on which the reference network (float32, the
    identity copy) puts a served class on ``min_share`` of the pixels or
    more, then the rest, so that the check has a mask to judge."""
    rng = np.random.default_rng([int(seed), 0xC4EC])
    order = rng.permutation(len(scenes)).tolist()
    ids = torch.as_tensor(class_ids, device=device)
    shown = []
    with exact_float32():
        for i in order:
            if len(shown) == count:
                break
            labels = ref_net.logits(weights, torch.as_tensor(scenes[i], device=device)[None],
                                    cfg).argmax(-1)
            if float(torch.isin(labels, ids).float().mean()) >= min_share:
                shown.append(i)
    return sorted((shown + [i for i in order if i not in shown])[:count])
