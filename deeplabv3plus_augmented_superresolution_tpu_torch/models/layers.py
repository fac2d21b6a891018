"""Keras-named layers of DeepLabV3+ as ``nn.Module``s (NCHW inside).

Port of the JAX package's ``models/layers.py``. Each leaf layer carries the
Keras layer name of the bonlime checkpoint (``keras_name``) and lists its
weights in the reference's layout and order (``specs``), so
``models/weights.py`` can draw the reference's random init and map Keras
checkpoints by name.

Numerics follow the reference: a convolution runs in the compute dtype and
returns that dtype; BatchNorm is folded to an f32 scale/shift applied in f32,
then cast back (precision-sensitive under bf16).

Two modes share this one module tree. Serving (``store=None``, the default)
reads the weights loaded into the modules' buffers: bf16 OIHW kernels, BN
folded. Training passes a ``BatchStatStore`` down the forward: each layer
reads its weights from the store's dict of f32 master tensors (Keras-named,
the port's layout) and casts them to the compute dtype inside the autograd
graph, as the reference's ``kernel.astype(x.dtype)``; BatchNorm normalises
with the batch's statistics and records them (the reference's
``ParamStore(bn_mode="batch")``).
"""

from typing import Dict, Iterator, Optional, Tuple, Union

import torch
import torch.distributed as dist
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
    """TF 'SAME' padding of one axis: extra padding goes after (a stride-2
    3x3 conv on an even size pads (0, 1), where a symmetric padding=1 would
    shift every output by one pixel)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + effective - size, 0)
    return total // 2, total - total // 2


class BatchStatStore:
    """Training mode of the forward: ``params`` maps Keras layer name ->
    weight name -> f32 master tensor (port layout); BatchNorm records each
    layer's batch (mean, biased variance), f32, in ``bn_batch_stats``.

    remat=True runs each segment (a block of the backbone, ASPP, the
    decoder; ``segment``) under ``torch.utils.checkpoint``: its activations
    are recomputed in the backward pass instead of kept. The recomputation
    records its statistics into a store of its own that is thrown away, so
    each layer's statistics are recorded once, from the forward pass.

    sync_group: a torch.distributed process group whose ranks each hold an
    equal slice of the batch; BatchNorm then takes the statistics of the
    whole batch (synchronised BatchNorm), through differentiable
    all-reduces. None: this process's batch alone."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]], remat: bool = False,
                 sync_group=None):
        self.params = params
        self.remat = remat
        self.sync_group = sync_group
        self.bn_batch_stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}


def segment(module: nn.Module, store: Optional[BatchStatStore], *args):
    """``module(*args, store)``; with a remat store, as one checkpointed
    segment (its statistics merged into ``store`` from the forward pass)."""
    if store is None or not store.remat:
        return module(*args, store)
    from torch.utils.checkpoint import checkpoint

    def run(*inputs):
        own = BatchStatStore(store.params, sync_group=store.sync_group)
        return module(*inputs, own), own.bn_batch_stats

    out, stats = checkpoint(run, *args, use_reentrant=False)
    store.bn_batch_stats.update(stats)
    return out


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

    def _conv(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            eff = self.kernel_size + (self.kernel_size - 1) * (self.rate - 1)
            pads = (_tf_same(x.shape[-2], eff, self.stride),
                    _tf_same(x.shape[-1], eff, self.stride))
        else:
            pads = self.padding
        (top, bottom), (left, right) = pads
        if top == bottom and left == right:
            return F.conv2d(x, weight, None, self.stride, (top, left),
                            self.rate, self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, weight, None, self.stride, 0, self.rate, self.groups)


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

    def forward(self, x: torch.Tensor,
                store: Optional[BatchStatStore] = None) -> torch.Tensor:
        if store is None:
            weight, bias = self.weight, getattr(self, "bias", None)
        else:
            entry = store.params[self.keras_name]
            weight, bias = entry["kernel"].to(x.dtype), entry.get("bias")
        y = self._conv(x, weight)
        if self.use_bias:
            y = (y.float() + bias[:, None, None]).to(x.dtype)
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

    def forward(self, x: torch.Tensor,
                store: Optional[BatchStatStore] = None) -> torch.Tensor:
        if store is None:
            return self._conv(x, self.weight)
        return self._conv(x, store.params[self.keras_name]["depthwise_kernel"]
                          .to(x.dtype))


class BatchNorm(KerasLayer):
    """Inference BatchNorm folded to an f32 scale and shift; with a store,
    batch-statistics BatchNorm (training)."""

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

    def forward(self, x: torch.Tensor,
                store: Optional[BatchStatStore] = None) -> torch.Tensor:
        if store is None:
            return torch.addcmul(self.shift, x.float(), self.scale).to(x.dtype)
        return self._batch_stat_forward(x, store)

    def _batch_stat_forward(self, x: torch.Tensor, store: BatchStatStore) -> torch.Tensor:
        """The reference's batch mode: the batch's mean and biased variance
        over (N, H, W) in f32 whatever the compute dtype, scale =
        gamma / sqrt(var + eps) and shift = beta - mean * scale applied in
        f32, cast back to the input dtype; (mean, var) recorded. The same
        operations in the same order (a product, then a sum), not cuDNN's
        batch norm nor a fused multiply-add: the gradient at init is
        sensitive to rounding (ReLU inputs within rounding of 0 flip), and
        the reference's own arithmetic keeps the port closest to it
        (tests/test_torch_train.py). With the store's sync_group, the
        statistics of the batch that the group's ranks share
        (``_synced_var_mean``)."""
        entry = store.params[self.keras_name]
        xf = x.float()
        if store.sync_group is None:
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        else:
            var, mean = _synced_var_mean(xf, store.sync_group)
        store.bn_batch_stats[self.keras_name] = (mean.detach(), var.detach())
        scale = entry["gamma"] / torch.sqrt(var + self.epsilon)
        shift = entry["beta"] - mean * scale
        return (xf * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    """The sum of x over the ranks of group; its cotangent is summed over
    them too, as each rank's loss is one term of the sum the ranks minimise."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _synced_var_mean(xf: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """(biased variance, mean) per channel over (N, H, W) of the batch of
    which every rank of group holds an equal (N, C, H, W) slice: the mean
    from the all-reduced sum, then the variance from the all-reduced sum of
    squared deviations from it, two passes as the reference's jnp.var
    (sum and sum of squares in one pass would lose the variance of a
    channel whose mean is large to cancellation). The all-reduces are
    differentiable: each rank's backward takes the cotangents of every
    rank's loss through the statistics."""
    n = xf.numel() // xf.shape[1] * dist.get_world_size(group)
    mean = _AllReduceSum.apply(xf.sum(dim=(0, 2, 3)), group) / n
    dev = xf - mean[:, None, None]
    var = _AllReduceSum.apply((dev * dev).sum(dim=(0, 2, 3)), group) / n
    return var, mean


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

    def forward(self, x: torch.Tensor,
                store: Optional[BatchStatStore] = None) -> torch.Tensor:
        if not self.depth_activation:
            x = relu(x)
        x = self.depthwise_bn(self.depthwise(x, store), store)
        if self.depth_activation:
            x = relu(x)
        x = self.pointwise_bn(self.pointwise(x, store), store)
        if self.depth_activation:
            x = relu(x)
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


# 0-d CPU constants: binary ops take them beside a tensor on any device.
_ZERO, _SIX = torch.tensor(0.0), torch.tensor(6.0)


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0), with the reference's derivative at 0: jax's maximum gives
    1/2 at a tie (torch.relu 0), and ties are common in training, where a
    dead channel normalises to exactly beta = 0 at init. ``torch.maximum``
    splits a tie the same way."""
    return torch.maximum(x, _ZERO)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, 6). Under autograd, with the reference's derivative (jax's
    clip: 1/2 at 0 and at 6; torch.clamp: 1)."""
    if x.requires_grad:
        return torch.minimum(torch.maximum(x, _ZERO), _SIX)
    return torch.clamp(x, 0, 6)


def make_divisible(value: float, divisor: int, min_value: Optional[int] = None) -> int:
    """MobileNetV2's channel rounding: the nearest multiple of divisor, not
    below min_value (default divisor) nor below 90% of value."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(value + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * value:
        new_v += divisor
    return new_v
