"""The network's weights, drawn from the run's seed on the card.

Every weight the configuration's forward reads (``reference.deeplab.
parameter_specs``): kernels from the Keras default (Glorot uniform), biases
0, BatchNorm gamma 1, beta 0, mean 0, variance 1. All the Glorot draws
come from one ``torch.rand`` on a generator of the card, cut into the
kernels, so the draw is a single call whatever the depth. The dict is
float32; the program casts what it stores to its compute dtype.
"""

import math
from typing import Dict

import torch

from .reference.deeplab import parameter_specs


def _limit(layer_name: str, shape) -> float:
    """sqrt(6 / (fan_in + fan_out)) of a kernel laid out (out, in, k, k), with
    Keras's fans of its (k, k, in, out) layout."""
    out_ch, in_ch, kh, kw = shape
    return math.sqrt(6.0 / (kh * kw * in_ch + kh * kw * out_ch))


def make_weights(cfg: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    specs = parameter_specs(cfg)
    glorot = [s for s in specs if s[3] == "glorot"]
    total = sum(math.prod(shape) for _, _, shape, _ in glorot)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    weights: Dict[str, Dict[str, torch.Tensor]] = {}
    offset = 0
    for layer, name, shape, init in specs:
        if init == "glorot":
            n = math.prod(shape)
            limit = _limit(layer, shape)
            tensor = (draw[offset:offset + n].view(shape) * 2.0 - 1.0) * limit
            offset += n
        elif init == "zeros":
            tensor = torch.zeros(shape, device=device)
        else:
            tensor = torch.ones(shape, device=device)
        weights.setdefault(layer, {})[name] = tensor
    return weights
