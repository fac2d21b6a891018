"""Adam / AMSGrad with optax semantics, written out for the SR solve.

Port of the JAX package's ``sr/optimizer.py`` for the names the serving
path uses. The update is optax's, not ``torch.optim``'s: AMSGrad keeps the
running max of the BIAS-CORRECTED second moment (optax.scale_by_amsgrad),
where ``torch.optim.Adam(amsgrad=True)`` keeps the max of the raw moment
(ROADMAP F1). The learning-rate schedule is optax's non-staircase
``exponential_decay``: lr(k) = lr0 * rate^(k / decay_steps), k counting
updates from 0.

Scalars (bias corrections, the learning rate) are computed on the host in
float32, as optax computes them, so the update loop never waits on the
device.
"""

import dataclasses

import numpy as np
import torch

NOT_PORTED = ("optimizer {!r} is not ported yet; the port supports 'adam' "
              "(with or without amsgrad)")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adam"
    learning_rate: float = 1e-3
    epsilon: float = 1e-7
    beta_1: float = 0.9
    beta_2: float = 0.999
    amsgrad: bool = False
    initial_accumulator_value: float = 0.1
    momentum: float = 0.0
    nesterov: bool = False
    lr_scheduler: bool = False
    decay_steps: float = 60
    decay_rate: float = 0.3


def learning_rate(cfg: OptimizerConfig, count: int) -> np.float32:
    """The step size of update number ``count`` (0-based)."""
    lr0 = np.float32(cfg.learning_rate)
    steps = int(cfg.decay_steps)
    if not cfg.lr_scheduler or steps <= 0 or cfg.decay_rate == 0 or count <= 0:
        return lr0
    p = np.float32(count) / np.float32(steps)
    return lr0 * np.power(np.float32(cfg.decay_rate), p)


class Adam:
    """optax.adam / optax.amsgrad for one parameter tensor.

    The moments live on the parameter's device; ``step`` returns the updated
    parameter (params + updates, as optax.apply_updates)."""

    def __init__(self, cfg: OptimizerConfig, param: torch.Tensor):
        if cfg.name != "adam":
            raise NotImplementedError(NOT_PORTED.format(cfg.name))
        self.cfg = cfg
        self.count = 0
        self.mu = torch.zeros_like(param)
        self.nu = torch.zeros_like(param)
        self.nu_max = torch.zeros_like(param) if cfg.amsgrad else None

    def step(self, param: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b1, b2 = cfg.beta_1, cfg.beta_2
        lr = learning_rate(cfg, self.count)
        self.count += 1
        self.mu = (1 - b1) * grad + b1 * self.mu
        self.nu = (1 - b2) * (grad * grad) + b2 * self.nu
        bc1 = np.float32(1) - np.power(np.float32(b1), np.float32(self.count))
        bc2 = np.float32(1) - np.power(np.float32(b2), np.float32(self.count))
        mu_hat = self.mu / float(bc1)
        nu_hat = self.nu / float(bc2)
        if self.nu_max is not None:
            self.nu_max = torch.maximum(self.nu_max, nu_hat)
            nu_hat = self.nu_max
        updates = mu_hat / (torch.sqrt(nu_hat) + cfg.epsilon)
        return param + float(-lr) * updates
