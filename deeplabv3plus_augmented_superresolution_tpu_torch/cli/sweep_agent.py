"""Offline hyper-parameter search over the sweep YAML space (port of the
JAX repository's ``cli/sweep_agent.py``).

The reference drives its sweeps with a wandb Bayes agent (reference
sweep_script.py:51-78, configs/sweep_configs/sweep.yaml:4-7), which needs
the network. This agent runs the same workflow locally: it parses the same
wandb-schema YAML, proposes configurations (random search, or a TPE-style
Bayes strategy that samples from a kernel-density model of the
top-quantile trials), evaluates each through ``sweep_script.run_config``
in-process (one Gram stencil cache kept across the trials) and appends
every trial to the sweep CSV.

  python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.sweep_agent \\
      --config configs/sweep_configs/sweep.yaml --trials 30 [--method bayes|random] \\
      [--num_samples 20] ...

Extra flags (sweep_script's) override the YAML's fixed parameters.
"""

import argparse
import copy
import math
import os
import random
import time
from typing import List, Optional

from . import sweep_script
from .SR_single_class import StencilCache


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", type=str, required=True,
                        help="wandb-schema sweep YAML (configs/sweep_configs/*)")
    parser.add_argument("--trials", type=int, default=20)
    parser.add_argument("--method", type=str, default=None, choices=["random", "bayes"],
                        help="override the YAML's method (bayes = TPE-style)")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--startup_trials", type=int, default=8,
                        help="random trials before the Bayes model kicks in")
    parser.add_argument("--top_quantile", type=float, default=0.3)
    parser.add_argument("--candidates", type=int, default=32,
                        help="candidate draws scored per Bayes proposal")
    parser.add_argument("--explore_every", type=int, default=4,
                        help="every Nth trial is a pure random draw even in "
                             "bayes mode (0 disables)")
    parser.add_argument("--output_csv", type=str, default=None)
    return parser


KNOWN_METRICS = ("standard_iou_single", "standard_iou_multiple", "aug_iou_single",
                 "aug_iou_multiple", "max_iou", "mean_iou", "runtime_s")


def _snap_to_q(x, lo, hi, q):
    """Quantize x onto the {lo + k*q} grid (wandb q_uniform semantics),
    clamped to [lo, hi]; integral grids come back as ints (e.g. the
    reference's decay_steps q=20 grid must feed an int schedule knob)."""
    val = lo + round((x - lo) / q) * q
    val = min(max(val, lo), hi)
    if float(q).is_integer() and float(lo).is_integer():
        return int(round(val))
    return round(val, 10)


class Space:
    """The wandb sweep parameter schema: value / values / uniform /
    q_uniform / log_uniform_values distributions (the reference's own sweep
    YAMLs use q_uniform for the lambda and decay grids,
    reference configs/sweep_configs/sweep.yaml:19-33, sweep_all.yaml:23-45)."""

    def __init__(self, params: dict):
        self.fixed = {}
        self.searched = {}
        for name, spec in params.items():
            if "value" in spec:
                self.fixed[name] = spec["value"]
            elif "values" in spec:
                self.searched[name] = ("choice", list(spec["values"]))
            else:
                dist = spec.get("distribution", "uniform")
                lo, hi = float(spec["min"]), float(spec["max"])
                if dist in ("log_uniform_values", "log_uniform"):
                    self.searched[name] = ("log", (lo, hi))
                elif dist in ("q_uniform", "q_log_uniform"):
                    q = float(spec.get("q", 1.0))
                    self.searched[name] = ("q", (lo, hi, q))
                else:
                    self.searched[name] = ("uniform", (lo, hi))

    def sample(self, rng: random.Random) -> dict:
        out = {}
        for name, (kind, arg) in self.searched.items():
            if kind == "choice":
                out[name] = rng.choice(arg)
            elif kind == "log":
                lo, hi = arg
                out[name] = math.exp(rng.uniform(math.log(lo), math.log(hi)))
            elif kind == "q":
                lo, hi, q = arg
                out[name] = _snap_to_q(rng.uniform(lo, hi), lo, hi, q)
            else:
                out[name] = rng.uniform(*arg)
        return out


class TPE:
    """Tree-structured-Parzen-style proposer: model the top quantile of
    trials ("good") and the rest ("bad") with per-parameter kernel densities
    / category counts, then pick the candidate maximizing p_good/p_bad."""

    def __init__(self, space: Space, rng: random.Random, top_quantile: float,
                 candidates: int):
        self.space = space
        self.rng = rng
        self.top_quantile = top_quantile
        self.candidates = candidates

    def _density(self, kind, arg, anchors, x):
        if kind == "choice":
            counts = {v: 1.0 for v in arg}  # add-one smoothing
            for a in anchors:
                counts[a] = counts.get(a, 1.0) + 1.0
            total = sum(counts.values())
            return counts.get(x, 1.0) / total
        if kind == "q":  # continuous KDE on the underlying interval
            kind, arg = "uniform", arg[:2]
        lo, hi = arg
        if kind == "log":
            lo, hi = math.log(lo), math.log(hi)
            x = math.log(x)
            anchors = [math.log(a) for a in anchors]
        width = (hi - lo) / max(math.sqrt(len(anchors)), 1.0)
        width = max(width, 1e-9)
        dens = sum(math.exp(-0.5 * ((x - a) / width) ** 2) for a in anchors)
        return dens / (len(anchors) * width) + 1e-12

    def propose(self, history):
        ranked = sorted(history, key=lambda t: -t[1])
        n_good = max(1, int(len(ranked) * self.top_quantile))
        good = [t[0] for t in ranked[:n_good]]
        bad = [t[0] for t in ranked[n_good:]] or good
        # Quantized spaces (the reference's q_uniform grids) make exact
        # repeat proposals likely once the model concentrates — e.g. a best
        # point on the grid boundary snaps every clamped jitter back onto
        # itself. A repeated trial is a wasted solve pass, so evaluated
        # configurations are excluded from the candidate pool (and if every
        # candidate is a repeat, the proposal falls back to a fresh random
        # draw — exploration instead of a duplicate).
        seen = {tuple(sorted(t[0].items())) for t in history}

        best_cand, best_score = None, -math.inf
        for _ in range(self.candidates):
            cand = {}
            score = 0.0
            for name, (kind, arg) in self.space.searched.items():
                # sample from the "good" model
                anchor = self.rng.choice(good)[name]
                if kind == "choice":
                    val = anchor if self.rng.random() < 0.8 else \
                        self.rng.choice(arg)
                else:
                    lo, hi = arg[0], arg[1]
                    span = (math.log(hi) - math.log(lo)) if kind == "log" \
                        else (hi - lo)
                    jitter = self.rng.gauss(0.0, span /
                                            max(math.sqrt(len(good)), 2.0))
                    if kind == "log":
                        val = math.exp(min(max(math.log(anchor) + jitter,
                                               math.log(lo)), math.log(hi)))
                    else:
                        val = min(max(anchor + jitter, lo), hi)
                    if kind == "q":
                        val = _snap_to_q(val, lo, hi, arg[2])
                cand[name] = val
                pg = self._density(kind, arg, [g[name] for g in good], val)
                pb = self._density(kind, arg, [b[name] for b in bad], val)
                score += math.log(pg / pb)
            if tuple(sorted(cand.items())) in seen:
                continue
            if score > best_score:
                best_cand, best_score = cand, score
        return best_cand if best_cand is not None else \
            self.space.sample(self.rng)


def main(argv: Optional[List[str]] = None):
    """Run the trials; returns (best params, signed best value, its metrics)."""
    import yaml

    args, extra = build_parser().parse_known_args(argv)
    with open(args.config) as f:
        sweep = yaml.safe_load(f)
    space = Space(sweep.get("parameters", {}))
    method = args.method or sweep.get("method", "random")
    metric = sweep.get("metric", {}).get("name", "aug_iou_single")
    goal = sweep.get("metric", {}).get("goal", "maximize")
    sign = 1.0 if goal == "maximize" else -1.0
    # Fail fast on a metric the evaluator never produces, before a trial runs.
    if metric not in KNOWN_METRICS:
        raise SystemExit(f"Unknown sweep metric {metric!r}; choose one of {KNOWN_METRICS}")

    rng = random.Random(args.seed)
    tpe = TPE(space, rng, args.top_quantile, args.candidates)
    history = []
    out_csv = args.output_csv or os.path.join(
        os.getcwd(), "experiments_data",
        f"agent_{os.path.splitext(os.path.basename(args.config))[0]}.csv")
    base_args = sweep_script.build_parser().parse_args(extra)
    # YAML-fixed values apply unless the flag was given on the command line.
    explicit = {a.split("=")[0].lstrip("-").replace("-", "_")
                for a in extra if a.startswith("--")}
    for key, value in space.fixed.items():
        if hasattr(base_args, key) and key not in explicit:
            setattr(base_args, key, value)

    print(f"sweep space: {sorted(space.searched)} | fixed: {sorted(space.fixed)} | "
          f"method {method} | metric {metric}")
    stencils = StencilCache()
    best = None
    for trial in range(args.trials):
        # Every Nth trial is a fresh random draw even once the Bayes model has
        # taken over, so that the sweep keeps covering the space.
        explore = args.explore_every and (trial + 1) % args.explore_every == 0
        if method == "bayes" and len(history) >= args.startup_trials and not explore:
            params = tpe.propose(history)
        else:
            params = space.sample(rng)
        trial_args = copy.deepcopy(base_args)
        trial_args.output_csv = out_csv
        for key, value in params.items():
            if hasattr(trial_args, key):
                setattr(trial_args, key, value)
        start = time.time()
        metrics = sweep_script.run_config(trial_args, stencils)
        value = metrics[metric]
        history.append((params, sign * value))
        if best is None or sign * value > best[1]:
            best = (params, sign * value, metrics)
        print(f"trial {trial + 1}/{args.trials}: {metric}={value:.4f} "
              f"({time.time() - start:.1f}s) {params}")
    print(f"\nbest {metric}={sign * best[1]:.4f} with {best[0]}")
    print(f"all trials appended to {out_csv}")
    return best


if __name__ == "__main__":
    main()
