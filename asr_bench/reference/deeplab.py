"""Plain PyTorch DeepLabV3+ forward (Xception or MobileNetV2), float32.

The benchmark's reference for the network: written from the published
architecture (Chen et al., arXiv:1802.02611; Sandler et al.,
arXiv:1801.04381) as the bonlime ``keras-deeplab-v3-plus`` ``model.py``
lays it out, with every width read from the configuration file. It imports
nothing of the program. Inference BatchNorm, TF "SAME" padding (extra pad
after) on unit-stride and MobileNetV2 convolutions, the symmetric explicit
padding of Xception's strided separable convolutions and shortcuts, TF2
half-pixel bilinear resizes, NCHW inside and NHWC logits out.

Weights are a dict: Keras layer name -> weight name -> tensor, kernels
(out, in, k, k), depthwise kernels (channels, 1, k, k). ``parameter_specs``
lists what a configuration needs; the benchmark draws those tensors from
its seed and hands the same dict to the program and to this forward.

``precision="fp8"`` rounds every convolution's input and kernel to
float8 e4m3 (one scale per tensor, from its largest magnitude) and
accumulates in float32: the control of the correctness check.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Spec = Tuple[str, str, Tuple[int, ...], str]
FP8_MAX = 448.0


class Params:
    """The weights a forward reads. Without a dict it records what the
    forward asks for (``parameter_specs``) and hands out meta tensors."""

    def __init__(self, weights: Optional[Dict[str, Dict[str, torch.Tensor]]] = None):
        self.weights = weights
        self.specs: List[Spec] = []

    def get(self, layer: str, name: str, shape: Sequence[int], init: str) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if self.weights is None:
            self.specs.append((layer, name, shape, init))
            return torch.empty(shape, device="meta")
        tensor = self.weights[layer][name]
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{layer}/{name}: shape {tuple(tensor.shape)}, want {shape}")
        return tensor


class Net:
    """One forward's state: the weights, the precision of the convolutions
    and an optional FLOP counter (a one-element list summed into)."""

    def __init__(self, params: Params, precision: str = "float32",
                 flops: Optional[List[int]] = None):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision must be float32 or fp8, got {precision!r}")
        self.p = params
        self.precision = precision
        self.flops = flops

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "float32" or x.device.type == "meta":
            return x
        scale = torch.clamp_min(x.abs().amax(), 1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    def conv(self, x, layer: str, in_ch: int, out_ch: int, k: int = 1, stride: int = 1,
             rate: int = 1, pad="SAME", depthwise: bool = False, bias: bool = False):
        if depthwise:
            w = self.p.get(layer, "depthwise_kernel", (in_ch, 1, k, k), "glorot")
        else:
            w = self.p.get(layer, "kernel", (out_ch, in_ch, k, k), "glorot")
        b = self.p.get(layer, "bias", (out_ch,), "zeros") if bias else None
        eff = k + (k - 1) * (rate - 1)
        if pad == "SAME":
            (top, bottom), (left, right) = (tf_same(x.shape[-2], eff, stride),
                                            tf_same(x.shape[-1], eff, stride))
        else:
            (top, bottom), (left, right) = pad
        x = F.pad(x, (left, right, top, bottom))
        groups = in_ch if depthwise else 1
        y = F.conv2d(self._q(x), self._q(w), None, stride, 0, rate, groups)
        if self.flops is not None:
            self.flops[0] += 2 * y.numel() * (in_ch // groups) * k * k
        return y if b is None else y + b[:, None, None]

    def bn(self, x, layer: str, ch: int, eps: float):
        gamma = self.p.get(layer, "gamma", (ch,), "ones")
        beta = self.p.get(layer, "beta", (ch,), "zeros")
        mean = self.p.get(layer, "moving_mean", (ch,), "zeros")
        var = self.p.get(layer, "moving_variance", (ch,), "ones")
        scale = gamma / torch.sqrt(var + eps)
        return x * scale[:, None, None] + (beta - mean * scale)[:, None, None]

    def resize(self, x, size):
        """TF2 half-pixel bilinear resize of the last two axes, as two
        matrix products (counted as such)."""
        out_h, out_w = int(size[0]), int(size[1])
        in_h, in_w = x.shape[-2:]
        if (in_h, in_w) == (out_h, out_w):
            return x
        mh = resize_matrix(out_h, in_h, x.device)
        mw = resize_matrix(out_w, in_w, x.device)
        if self.flops is not None:
            planes = x.numel() // (in_h * in_w)
            self.flops[0] += 2 * planes * (out_h * in_h * in_w + out_h * in_w * out_w)
        return torch.matmul(torch.matmul(mh, x), mw.t())

    def sepconv(self, x, prefix: str, in_ch: int, filters: int, stride: int = 1,
                rate: int = 1, depth_activation: bool = False, eps: float = 1e-3):
        pad = "SAME" if stride == 1 else symmetric_pad(3, rate)
        if not depth_activation:
            x = relu(x)
        x = self.bn(self.conv(x, prefix + "_depthwise", in_ch, in_ch, 3, stride, rate, pad,
                              depthwise=True), prefix + "_depthwise_BN", in_ch, eps)
        if depth_activation:
            x = relu(x)
        x = self.bn(self.conv(x, prefix + "_pointwise", in_ch, filters),
                    prefix + "_pointwise_BN", filters, eps)
        return relu(x) if depth_activation else x


def tf_same(size: int, effective: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + effective - size, 0)
    return total // 2, total - total // 2


def symmetric_pad(k: int, rate: int):
    total = k + (k - 1) * (rate - 1) - 1
    return ((total // 2, total - total // 2),) * 2


def relu(x):
    return torch.clamp_min(x, 0.0)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def make_divisible(value: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(value + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * value else new_v


_MATRICES: Dict[tuple, torch.Tensor] = {}


def resize_matrix(out_size: int, in_size: int, device) -> torch.Tensor:
    """(out, in) TF2 bilinear matrix: src = max((dst + 0.5) in/out - 0.5, 0),
    a lerp of floor and floor + 1 (clamped to the last pixel)."""
    key = (out_size, in_size, str(device))
    if key not in _MATRICES:
        dst = np.arange(out_size, dtype=np.float64)
        src = np.maximum((dst + 0.5) * (in_size / out_size) - 0.5, 0.0)
        lo = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
        hi = np.minimum(lo + 1, in_size - 1)
        mat = np.zeros((out_size, in_size))
        np.add.at(mat, (np.arange(out_size), lo), 1.0 - (src - lo))
        np.add.at(mat, (np.arange(out_size), hi), src - lo)
        _MATRICES[key] = torch.tensor(mat, dtype=torch.float32, device=device)
    return _MATRICES[key]


def _rates(cfg: dict):
    """(entry block 3 stride, middle rate, exit rates, ASPP rates) of Xception."""
    if cfg["output_stride"] == 8:
        return 1, 2, (2, 4), (12, 24, 36)
    return 2, 1, (1, 2), tuple(cfg["aspp"]["rates"])


def _xception_block(net: Net, x, prefix: str, in_ch: int, filters, skip_type,
                    stride: int, rate: int = 1, depth_activation: bool = False):
    chans = [in_ch] + list(filters)
    residual, skip = x, None
    for i in range(3):
        residual = net.sepconv(residual, f"{prefix}_separable_conv{i + 1}", chans[i],
                               chans[i + 1], stride if i == 2 else 1, rate,
                               depth_activation)
        if i == 1:
            skip = residual
    if skip_type == "conv":
        pad = "SAME" if stride == 1 else symmetric_pad(1, 1)
        short = net.bn(net.conv(x, prefix + "_shortcut", in_ch, filters[-1], 1, stride,
                                pad=pad), prefix + "_shortcut_BN", filters[-1], 1e-3)
        return residual + short, skip
    if skip_type == "sum":
        return residual + x, skip
    return residual, skip


def _xception(net: Net, x, cfg: dict):
    xc = cfg["xception"]
    entry_stride, middle_rate, exit_rates, _ = _rates(cfg)
    c1, c2 = xc["entry_conv"]
    x = relu(net.bn(net.conv(x, "entry_flow_conv1_1", 3, c1, 3, 2),
                    "entry_flow_conv1_1_BN", c1, 1e-3))
    x = relu(net.bn(net.conv(x, "entry_flow_conv1_2", c1, c2, 3),
                    "entry_flow_conv1_2_BN", c2, 1e-3))
    ch, skip = c2, None
    strides = (2, 2, entry_stride)
    for i, filters in enumerate(xc["entry_blocks"]):
        x, s = _xception_block(net, x, f"entry_flow_block{i + 1}", ch, filters, "conv",
                               strides[i])
        if i == 1:
            skip = s
        ch = filters[-1]
    for i in range(xc["middle_units"]):
        x, _ = _xception_block(net, x, f"middle_flow_unit_{i + 1}", ch,
                               [xc["middle_filters"]] * 3, "sum", 1, middle_rate)
        ch = xc["middle_filters"]
    x, _ = _xception_block(net, x, "exit_flow_block1", ch, xc["exit_block1"], "conv", 1,
                           exit_rates[0])
    x, _ = _xception_block(net, x, "exit_flow_block2", xc["exit_block1"][-1],
                           xc["exit_block2"], None, 1, exit_rates[1],
                           depth_activation=True)
    return x, xc["exit_block2"][-1], skip, xc["entry_blocks"][1][-1]


def _mobilenet(net: Net, x, cfg: dict):
    mc = cfg["mobilenetv2"]
    alpha = mc["alpha"]
    first = make_divisible(mc["first_filters"] * alpha)
    x = relu6(net.bn(net.conv(x, "Conv", 3, first, 3, 2), "Conv_BN", first, 1e-3))
    x = relu6(net.bn(net.conv(x, "expanded_conv_depthwise", first, first, 3, depthwise=True),
                     "expanded_conv_depthwise_BN", first, 1e-3))
    ch = make_divisible(int(mc["expanded_conv_filters"] * alpha))
    x = net.bn(net.conv(x, "expanded_conv_project", first, ch),
               "expanded_conv_project_BN", ch, 1e-3)
    for block_id, (filters, stride, rate, skip) in enumerate(mc["blocks"], start=1):
        prefix = f"expanded_conv_{block_id}_"
        hidden = mc["expansion"] * ch
        out = make_divisible(int(filters * alpha))
        y = relu6(net.bn(net.conv(x, prefix + "expand", ch, hidden), prefix + "expand_BN",
                         hidden, 1e-3))
        y = relu6(net.bn(net.conv(y, prefix + "depthwise", hidden, hidden, 3, stride, rate,
                                  depthwise=True), prefix + "depthwise_BN", hidden, 1e-3))
        y = net.bn(net.conv(y, prefix + "project", hidden, out), prefix + "project_BN",
                   out, 1e-3)
        x = x + y if skip else y
        ch = out
    return x, ch


def _aspp(net: Net, x, in_ch: int, cfg: dict):
    f = cfg["aspp"]["filters"]
    rates = _rates(cfg)[3] if cfg["backbone"] == "xception" else ()
    pool = x.mean(dim=(-2, -1), keepdim=True)
    pool = relu(net.bn(net.conv(pool, "image_pooling", in_ch, f), "image_pooling_BN", f,
                       1e-5))
    pool = pool.expand(-1, -1, *x.shape[-2:])  # bilinear from 1 x 1 is a broadcast
    b0 = relu(net.bn(net.conv(x, "aspp0", in_ch, f), "aspp0_BN", f, 1e-5))
    branches = [pool, b0] + [net.sepconv(x, f"aspp{i}", in_ch, f, 1, rate, True)
                             for i, rate in enumerate(rates, start=1)]
    out = net.conv(torch.cat(branches, dim=1), "concat_projection", f * len(branches), f)
    return relu(net.bn(out, "concat_projection_BN", f, 1e-5))


def forward_nchw(net: Net, image: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, 3, H, W) float32 -> (B, classes, h, w) logits."""
    if cfg["backbone"] == "xception":
        x, ch, skip, skip_ch = _xception(net, image, cfg)
        x = _aspp(net, x, ch, cfg)
        dec = cfg["decoder"]
        x = net.resize(x, skip.shape[-2:])
        proj = relu(net.bn(net.conv(skip, "feature_projection0", skip_ch,
                                    dec["skip_projection"]),
                           "feature_projection0_BN", dec["skip_projection"], 1e-5))
        x = torch.cat([x, proj], dim=1)
        x = net.sepconv(x, "decoder_conv0", cfg["aspp"]["filters"] + dec["skip_projection"],
                        dec["filters"], depth_activation=True, eps=1e-5)
        x = net.sepconv(x, "decoder_conv1", dec["filters"], dec["filters"],
                        depth_activation=True, eps=1e-5)
        head_in = dec["filters"]
    else:
        x, ch = _mobilenet(net, image, cfg)
        x = _aspp(net, x, ch, cfg)
        head_in = cfg["aspp"]["filters"]
    return net.conv(x, "logits_semantic", head_in, cfg["classes"], bias=True)


def parameter_specs(cfg: dict) -> List[Spec]:
    """(layer, weight, shape, init) of every weight the configuration's
    forward reads, init one of glorot, zeros, ones."""
    params = Params()
    h, w = cfg["input_size"]
    forward_nchw(Net(params), torch.empty((1, 3, h, w), device="meta"), cfg)
    return params.specs


def forward_flops(cfg: dict, batch: int) -> int:
    """Multiply-adds x 2 of every convolution and resize product of the
    forward of ``batch`` images, from the layer shapes alone."""
    flops = [0]
    h, w = cfg["input_size"]
    forward_nchw(Net(Params(), flops=flops), torch.empty((batch, 3, h, w), device="meta"),
                 cfg)
    return flops[0]


@torch.no_grad()
def logits(weights, images: torch.Tensor, cfg: dict, precision: str = "float32",
           block: int = 16) -> torch.Tensor:
    """(N, H, W, 3) float32 images -> (N, h, w, classes) float32 logits, in
    blocks of ``block`` images so that the activations fit."""
    net = Net(Params(weights), precision)
    outs = [forward_nchw(net, images[i:i + block].permute(0, 3, 1, 2), cfg)
            for i in range(0, images.shape[0], block)]
    return torch.cat(outs).permute(0, 2, 3, 1)
