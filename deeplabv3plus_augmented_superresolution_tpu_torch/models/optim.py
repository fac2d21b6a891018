"""The training optimizers with optax semantics, over flat f32 buffers.

Counterpart of ``make_optimizer`` in the JAX repository's ``cli/train.py``:
``adam``, ``adamw`` (decoupled decay over every leaf, moving statistics
included), ``sgd`` with Nesterov momentum, optionally behind
``clip_by_global_norm``, with the learning-rate schedules ``constant``,
``cosine`` (``optax.warmup_cosine_decay_schedule`` from 0 to 0,
``decay_steps = max(steps, warmup + 1)``) and ``exponential`` (not
staircase). Each update is optax's arithmetic, written out: the schedule is
read at its count before the increment, adam's bias corrections at the
count after it.

The parameters, gradients and moments are single flat tensors in the
reference's tree order (``models/train.MasterParams``), so an update is a
dozen elementwise launches whatever the number of layers. Counts live on the
device as int32 scalars and the schedule is computed there: nothing waits on
the host, and a skipped step (``skip_nonfinite``) can keep them with a
device-side select.

``OptState.leaves`` lists the state in optax's tree-flatten order (each
state's fields in order, e.g. adam's ``count``, ``mu``, ``nu``; a moment as
one leaf per parameter, dict keys sorted; a schedule adds its
``ScaleByScheduleState.count``; sgd's ``trace`` has no count;
``clip_by_global_norm`` and ``add_decayed_weights`` add no leaf), which is
how ``utils/checkpoint.py`` writes it.
"""

import math
from typing import Dict, List, Tuple

import torch

OPTIMIZERS = ("adam", "adamw", "sgd")
SCHEDULES = ("constant", "cosine", "exponential")
# optax.adam / adamw defaults.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Schedule:
    """The learning rate as a function of the schedule's count (optax's
    ``warmup_cosine_decay_schedule`` / ``exponential_decay``, or a constant,
    which keeps no count)."""

    def __init__(self, kind: str, lr: float, steps: int = 0, warmup_steps: int = 0,
                 decay_steps: int = 0, decay_rate: float = 1.0):
        if kind not in SCHEDULES:
            raise ValueError(kind)
        self.kind, self.lr = kind, float(lr)
        self.warmup = int(warmup_steps)
        self.cosine_steps = max(int(steps), self.warmup + 1) - self.warmup
        self.decay_steps, self.decay_rate = int(decay_steps), float(decay_rate)

    @property
    def counted(self) -> bool:
        return self.kind != "constant"

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        """f32 learning rate at ``count`` (an int32 tensor)."""
        c = count.to(torch.float32)
        if self.kind == "exponential":
            if self.decay_steps <= 0 or self.decay_rate == 0:
                return torch.full_like(c, self.lr)
            return self.lr * torch.pow(torch.full_like(c, self.decay_rate),
                                       c / self.decay_steps)
        if self.kind == "cosine":
            # join_schedules([linear 0 -> lr over warmup, cosine lr -> 0], [warmup])
            if self.warmup > 0:
                frac = 1.0 - c.clamp(0, self.warmup) / self.warmup
                warm = (0.0 - self.lr) * frac + self.lr
            else:
                warm = torch.zeros_like(c)
            t = (c - self.warmup).clamp_max(float(self.cosine_steps))
            cosine = self.lr * (0.5 * (1.0 + torch.cos(math.pi * t / self.cosine_steps)))
            return torch.where(c < self.warmup, warm, cosine)
        return torch.full_like(c, self.lr)


class OptState:
    """The optimizer's tensors: ``count`` (adam), the flat moments
    (``mu``/``nu``, or sgd's ``trace``), ``schedule_count`` (a counted
    schedule). ``slots`` names them in optax's order."""

    def __init__(self, slots: Tuple[str, ...], tensors: Dict[str, torch.Tensor]):
        self.slots = slots
        self.tensors = tensors

    def leaves(self, master) -> List[Tuple[str, torch.Tensor]]:
        """(weight name or "", tensor) per optax leaf, in optax's order: a
        scalar count as ("", count), a moment as one view per parameter in
        the port's layout, named by its weight (for the layout change)."""
        out = []
        for slot in self.slots:
            t = self.tensors[slot]
            if t.dim() == 0:
                out.append(("", t))
            else:
                out.extend((name, view) for (_, name), view in
                           zip(master.keys, master.leaves(t)))
        return out

    def assign(self, new: "OptState", keep=None) -> None:
        """Take ``new``'s values, or, where the 0-d bool tensor ``keep`` is
        False, keep the current ones (a device-side select)."""
        for slot in self.slots:
            t = self.tensors[slot]
            if keep is None:
                t.copy_(new.tensors[slot])
            else:
                torch.where(keep, new.tensors[slot], t, out=t)


class TrainOptimizer:
    """One of optax's adam / adamw / sgd (Nesterov), optionally behind
    clip_by_global_norm, over flat f32 buffers. ``update`` is functional:
    (grad, state, params) -> (new params, new state)."""

    def __init__(self, name: str, schedule: Schedule, weight_decay: float = 1e-4,
                 momentum: float = 0.9, grad_clip: float = 0.0):
        if name not in OPTIMIZERS:
            raise ValueError(name)
        self.name, self.schedule = name, schedule
        self.weight_decay, self.momentum = float(weight_decay), float(momentum)
        self.grad_clip = float(grad_clip)

    def init(self, master) -> OptState:
        flat = master.flat
        zero = torch.zeros((), dtype=torch.int32, device=flat.device)
        tensors = {}
        if self.name == "sgd":
            tensors["trace"] = torch.zeros_like(flat)
        else:
            tensors["count"] = zero.clone()
            tensors["mu"] = torch.zeros_like(flat)
            tensors["nu"] = torch.zeros_like(flat)
        if self.schedule.counted:
            tensors["schedule_count"] = zero.clone()
        return OptState(tuple(tensors), tensors)

    def update(self, grad: torch.Tensor, state: OptState, params: torch.Tensor
               ) -> Tuple[torch.Tensor, OptState]:
        s = state.tensors
        new: Dict[str, torch.Tensor] = {}
        g = grad
        if self.grad_clip > 0:
            g_norm = torch.linalg.vector_norm(g)
            g = torch.where(g_norm < self.grad_clip, g, g / g_norm * self.grad_clip)
        if self.name == "sgd":
            m = self.momentum
            new["trace"] = g + m * s["trace"]
            u = g + m * new["trace"]
        else:
            b1, b2 = ADAM_B1, ADAM_B2
            new["count"] = s["count"] + 1
            new["mu"] = torch.add(g * (1 - b1), s["mu"], alpha=b1)
            new["nu"] = torch.add(g * g * (1 - b2), s["nu"], alpha=b2)
            k = new["count"].to(torch.float32)
            mu_hat = new["mu"] / (1 - torch.pow(torch.full_like(k, b1), k))
            nu_hat = new["nu"] / (1 - torch.pow(torch.full_like(k, b2), k))
            u = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
            if self.name == "adamw":
                u = u + self.weight_decay * params
        if self.schedule.counted:
            lr = self.schedule(s["schedule_count"])
            new["schedule_count"] = s["schedule_count"] + 1
            u = u * -lr
        else:
            u = u * -self.schedule.lr
        return params + u, OptState(state.slots, new)


def make_optimizer(args) -> TrainOptimizer:
    """The reference CLI's ``make_optimizer``: from ``--optimizer``,
    ``--lr``, ``--lr_schedule``, ``--warmup_steps``, ``--steps``,
    ``--decay_steps``, ``--decay_rate``, ``--weight_decay``, ``--momentum``
    and ``--grad_clip`` (any object with those attributes)."""
    if args.lr_schedule not in SCHEDULES:
        raise ValueError(args.lr_schedule)
    schedule = Schedule(args.lr_schedule, args.lr, steps=args.steps,
                        warmup_steps=args.warmup_steps,
                        decay_steps=args.decay_steps, decay_rate=args.decay_rate)
    return TrainOptimizer(args.optimizer, schedule, weight_decay=args.weight_decay,
                          momentum=args.momentum, grad_clip=args.grad_clip)
