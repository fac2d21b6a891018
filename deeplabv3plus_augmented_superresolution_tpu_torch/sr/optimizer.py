"""The SR solve's optimizers with optax semantics, written out by hand.

Port of the JAX package's ``sr/optimizer.py``: ``make_optimizer`` maps the
reference's names (adam with or without amsgrad, adamax, adagrad, adadelta,
sgd with optional momentum and nesterov) to one update rule each, with the
optional learning-rate schedule. The updates are optax's, not
``torch.optim``'s: AMSGrad keeps the running max of the BIAS-CORRECTED second
moment (optax.scale_by_amsgrad), where ``torch.optim.Adam(amsgrad=True)``
keeps the max of the raw moment (ROADMAP F1); adadelta uses optax's defaults
(rho 0.9, eps 1e-6), as the reference's ``optax.adadelta(learning_rate=lr)``
does. The learning-rate schedule is optax's non-staircase
``exponential_decay``: lr(k) = lr0 * rate^(k / decay_steps), k counting
updates from 0.

Scalars (bias corrections, the learning rate) are computed on the host in
float32, as optax computes them, so the update loop never waits on the
device. Every optimizer keeps its state on the parameter's device and
``step(param, grad)`` returns the updated parameter (params + updates, as
optax.apply_updates).
"""

import dataclasses

import numpy as np
import torch

OPTIMIZERS = ("adam", "adamax", "adagrad", "adadelta", "sgd")

# optax.adadelta's defaults, which the reference leaves in place.
ADADELTA_RHO = 0.9
ADADELTA_EPS = 1e-6


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


def make_schedule(cfg: OptimizerConfig):
    """The reference's learning rate: the constant cfg.learning_rate, or with
    cfg.lr_scheduler the schedule count -> ``learning_rate(cfg, count)``
    (optax's non-staircase exponential_decay)."""
    if not cfg.lr_scheduler:
        return cfg.learning_rate
    return lambda count: learning_rate(cfg, int(count))


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1) - np.power(np.float32(decay), np.float32(count)))


class _Optimizer:
    """Shared bookkeeping: the update count and the scheduled step."""

    name = ""

    def __init__(self, cfg: OptimizerConfig, param: torch.Tensor):
        if cfg.name != self.name:
            raise ValueError(f"{type(self).__name__} takes name {self.name!r}, "
                             f"got {cfg.name!r}; use make_optimizer")
        self.cfg = cfg
        self.count = 0

    def step(self, param: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        lr = learning_rate(self.cfg, self.count)
        self.count += 1
        return param + float(-lr) * self._direction(grad)

    def _direction(self, grad: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class Adam(_Optimizer):
    """optax.adam / optax.amsgrad."""

    name = "adam"

    def __init__(self, cfg: OptimizerConfig, param: torch.Tensor):
        super().__init__(cfg, param)
        self.mu = torch.zeros_like(param)
        self.nu = torch.zeros_like(param)
        self.nu_max = torch.zeros_like(param) if cfg.amsgrad else None

    def _direction(self, grad):
        cfg = self.cfg
        b1, b2 = cfg.beta_1, cfg.beta_2
        self.mu = (1 - b1) * grad + b1 * self.mu
        self.nu = (1 - b2) * (grad * grad) + b2 * self.nu
        mu_hat = self.mu / _bias_correction(b1, self.count)
        nu_hat = self.nu / _bias_correction(b2, self.count)
        if self.nu_max is not None:
            self.nu_max = torch.maximum(self.nu_max, nu_hat)
            nu_hat = self.nu_max
        return mu_hat / (torch.sqrt(nu_hat) + cfg.epsilon)


class Adamax(_Optimizer):
    """optax.adamax: the infinity-norm moment max(|g| + eps, b2 nu), no bias
    correction on it."""

    name = "adamax"

    def __init__(self, cfg: OptimizerConfig, param: torch.Tensor):
        super().__init__(cfg, param)
        self.mu = torch.zeros_like(param)
        self.nu = torch.zeros_like(param)

    def _direction(self, grad):
        cfg = self.cfg
        self.mu = (1 - cfg.beta_1) * grad + cfg.beta_1 * self.mu
        self.nu = torch.maximum(grad.abs() + cfg.epsilon, cfg.beta_2 * self.nu)
        return (self.mu / _bias_correction(cfg.beta_1, self.count)) / self.nu


class Adagrad(_Optimizer):
    """optax.adagrad: g / sqrt(sum of squares + eps), the sum started at
    initial_accumulator_value."""

    name = "adagrad"

    def __init__(self, cfg: OptimizerConfig, param: torch.Tensor):
        super().__init__(cfg, param)
        self.sum_of_squares = torch.full_like(param, cfg.initial_accumulator_value)

    def _direction(self, grad):
        self.sum_of_squares = grad * grad + self.sum_of_squares
        sos = self.sum_of_squares
        inv = torch.where(sos > 0, torch.rsqrt(sos + self.cfg.epsilon),
                          torch.zeros_like(sos))
        return inv * grad


class Adadelta(_Optimizer):
    """optax.adadelta with its default rho and eps."""

    name = "adadelta"

    def __init__(self, cfg: OptimizerConfig, param: torch.Tensor):
        super().__init__(cfg, param)
        self.e_g = torch.zeros_like(param)
        self.e_x = torch.zeros_like(param)

    def _direction(self, grad):
        rho, eps = ADADELTA_RHO, ADADELTA_EPS
        self.e_g = (1 - rho) * (grad * grad) + rho * self.e_g
        delta = torch.sqrt(self.e_x + eps) / torch.sqrt(self.e_g + eps) * grad
        self.e_x = (1 - rho) * (delta * delta) + rho * self.e_x
        return delta


class SGD(_Optimizer):
    """optax.sgd: plain, or with a momentum trace (g + m trace), nesterov
    taking g + m * the new trace."""

    name = "sgd"

    def __init__(self, cfg: OptimizerConfig, param: torch.Tensor):
        super().__init__(cfg, param)
        self.trace = torch.zeros_like(param) if cfg.momentum else None

    def _direction(self, grad):
        if self.trace is None:
            return grad
        m = self.cfg.momentum
        self.trace = grad + m * self.trace
        return grad + m * self.trace if self.cfg.nesterov else self.trace


_BY_NAME = {cls.name: cls for cls in (Adam, Adamax, Adagrad, Adadelta, SGD)}


def make_optimizer(cfg: OptimizerConfig, param: torch.Tensor) -> _Optimizer:
    """The optimizer that cfg.name selects, its state shaped like param."""
    if cfg.name not in _BY_NAME:
        raise ValueError(f"Unknown optimizer {cfg.name!r}; choose from {OPTIMIZERS}")
    return _BY_NAME[cfg.name](cfg, param)
