"""Keras-named layers of DeepLabV3+ as ``nn.Module``s (NCHW inside).

Port of the JAX package's ``models/layers.py``. Each leaf layer carries the
Keras layer name of the bonlime checkpoint (``keras_name``) and lists its
weights in the reference's layout and order (``specs``), so
``models/weights.py`` can draw the reference's random init and map Keras
checkpoints by name.

Numerics follow the reference: a convolution runs in the compute dtype and
returns that dtype; BatchNorm is inference-only, folded to an f32
scale/shift applied in f32, then cast back (precision-sensitive under bf16).
"""

from typing import Dict, Iterator, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

# (layer name, weight name, shape in the reference's layout, init)
Spec = Tuple[str, str, Tuple[int, ...], str]
Padding = Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]


def manual_same_padding(kernel_size: int, rate: int) -> Tuple[int, int]:
    """The reference's explicit ZeroPadding2D for strided convs: a symmetric
    (beg, end) split of the effective kernel's total padding."""
    effective = kernel_size + (kernel_size - 1) * (rate - 1)
    pad_total = effective - 1
    pad_beg = pad_total // 2
    return pad_beg, pad_total - pad_beg


def _tf_same(size: int, effective: int, stride: int) -> Tuple[int, int]:
    """TF 'SAME' padding of one axis: extra padding goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + effective - size, 0)
    return total // 2, total - total // 2


class KerasLayer(nn.Module):
    """A layer whose weights live under one Keras layer name."""

    keras_name: str

    def specs(self) -> Iterator[Spec]:
        raise NotImplementedError

    def load(self, entry: Dict[str, torch.Tensor]) -> None:
        raise NotImplementedError


class _ConvBase(KerasLayer):
    def __init__(self, name: str, kernel_size: int, stride: int, rate: int,
                 padding: Padding, groups: int):
        super().__init__()
        self.keras_name = name
        self.kernel_size = kernel_size
        self.stride = stride
        self.rate = rate
        self.padding = padding
        self.groups = groups

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            eff = self.kernel_size + (self.kernel_size - 1) * (self.rate - 1)
            pads = (_tf_same(x.shape[-2], eff, self.stride),
                    _tf_same(x.shape[-1], eff, self.stride))
        else:
            pads = self.padding
        (top, bottom), (left, right) = pads
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, None, self.stride, (top, left),
                            self.rate, self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, None, self.stride, 0, self.rate,
                        self.groups)


class Conv2d(_ConvBase):
    """Dense conv; weight OIHW in the compute dtype, optional f32 bias."""

    def __init__(self, name: str, in_ch: int, filters: int, kernel_size: int = 1,
                 stride: int = 1, rate: int = 1, padding: Padding = "SAME",
                 use_bias: bool = False, *, dtype: torch.dtype, device=None):
        super().__init__(name, kernel_size, stride, rate, padding, groups=1)
        self.in_ch, self.filters, self.use_bias = in_ch, filters, use_bias
        self.register_buffer("weight", torch.zeros(
            filters, in_ch, kernel_size, kernel_size, dtype=dtype, device=device))
        if use_bias:
            self.register_buffer("bias", torch.zeros(filters, device=device))

    def specs(self) -> Iterator[Spec]:
        k = self.kernel_size
        yield self.keras_name, "kernel", (k, k, self.in_ch, self.filters), "glorot"
        if self.use_bias:
            yield self.keras_name, "bias", (self.filters,), "zeros"

    def load(self, entry: Dict[str, torch.Tensor]) -> None:
        self.weight.copy_(entry["kernel"])
        if self.use_bias:
            self.bias.copy_(entry["bias"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv(x)
        if self.use_bias:
            y = (y.float() + self.bias[:, None, None]).to(x.dtype)
        return y


class DepthwiseConv2d(_ConvBase):
    """Depthwise conv; weight (C, 1, k, k) in the compute dtype."""

    def __init__(self, name: str, channels: int, kernel_size: int = 3,
                 stride: int = 1, rate: int = 1, padding: Padding = "SAME", *,
                 dtype: torch.dtype, device=None):
        super().__init__(name, kernel_size, stride, rate, padding, groups=channels)
        self.channels = channels
        self.register_buffer("weight", torch.zeros(
            channels, 1, kernel_size, kernel_size, dtype=dtype, device=device))

    def specs(self) -> Iterator[Spec]:
        k = self.kernel_size
        yield self.keras_name, "depthwise_kernel", (k, k, 1, self.channels), "glorot"

    def load(self, entry: Dict[str, torch.Tensor]) -> None:
        self.weight.copy_(entry["depthwise_kernel"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x)


class BatchNorm(KerasLayer):
    """Inference BatchNorm folded to an f32 scale and shift."""

    def __init__(self, name: str, channels: int, epsilon: float = 1e-3, *,
                 device=None):
        super().__init__()
        self.keras_name = name
        self.channels = channels
        self.epsilon = epsilon
        self.register_buffer("scale", torch.ones(channels, 1, 1, device=device))
        self.register_buffer("shift", torch.zeros(channels, 1, 1, device=device))

    def specs(self) -> Iterator[Spec]:
        c = (self.channels,)
        yield self.keras_name, "gamma", c, "ones"
        yield self.keras_name, "beta", c, "zeros"
        yield self.keras_name, "moving_mean", c, "zeros"
        yield self.keras_name, "moving_variance", c, "ones"

    def load(self, entry: Dict[str, torch.Tensor]) -> None:
        gamma, beta = entry["gamma"].float(), entry["beta"].float()
        mean, var = entry["moving_mean"].float(), entry["moving_variance"].float()
        scale = gamma / torch.sqrt(var + self.epsilon)
        self.scale.copy_(scale[:, None, None])
        self.shift.copy_((beta - mean * scale)[:, None, None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.addcmul(self.shift, x.float(), self.scale).to(x.dtype)


class SepConvBN(nn.Module):
    """Depthwise-separable conv with BN: optional pre-ReLU (when
    depth_activation is False), manual symmetric padding for stride > 1,
    ReLU between depthwise and pointwise otherwise."""

    def __init__(self, prefix: str, in_ch: int, filters: int, stride: int = 1,
                 kernel_size: int = 3, rate: int = 1,
                 depth_activation: bool = False, epsilon: float = 1e-3, *,
                 dtype: torch.dtype, device=None):
        super().__init__()
        if stride == 1:
            padding: Padding = "SAME"
        else:
            pb, pe = manual_same_padding(kernel_size, rate)
            padding = ((pb, pe), (pb, pe))
        self.depth_activation = depth_activation
        self.depthwise = DepthwiseConv2d(prefix + "_depthwise", in_ch, kernel_size,
                                         stride, rate, padding, dtype=dtype,
                                         device=device)
        self.depthwise_bn = BatchNorm(prefix + "_depthwise_BN", in_ch, epsilon,
                                      device=device)
        self.pointwise = Conv2d(prefix + "_pointwise", in_ch, filters, 1,
                                dtype=dtype, device=device)
        self.pointwise_bn = BatchNorm(prefix + "_pointwise_BN", filters, epsilon,
                                      device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.depth_activation:
            x = F.relu(x)
        x = self.depthwise_bn(self.depthwise(x))
        if self.depth_activation:
            x = F.relu(x)
        x = self.pointwise_bn(self.pointwise(x))
        if self.depth_activation:
            x = F.relu(x)
        return x


def conv2d_same(name: str, in_ch: int, filters: int, stride: int = 1,
                kernel_size: int = 3, rate: int = 1, *, dtype: torch.dtype,
                device=None) -> Conv2d:
    """Conv with the reference's symmetric 'same' padding for stride > 1."""
    if stride == 1:
        padding: Padding = "SAME"
    else:
        pb, pe = manual_same_padding(kernel_size, rate)
        padding = ((pb, pe), (pb, pe))
    return Conv2d(name, in_ch, filters, kernel_size, stride, rate, padding,
                  dtype=dtype, device=device)


def global_average_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H, W in f32, kept as (N, C, 1, 1) in the input dtype."""
    return x.float().mean(dim=(-2, -1), keepdim=True).to(x.dtype)
