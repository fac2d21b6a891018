"""DeepLabV3+ with the Xception backbone as an ``nn.Module``.

Port of the JAX package's ``models/deeplab.py``: the Xception backbone at
OS 16 or 8 (entry / middle / exit flows), ASPP with the image-pooling branch,
the standard decoder and the class head. Modules are registered in the order
the reference's forward creates its parameters, which ``models/weights.py``
relies on to reproduce the reference's random init.

The public forward takes and returns NHWC like the reference,
(B, H, W, 3) -> (B, h, w, classes) float32 logits; inside, the network runs
NCHW (a permuted NHWC tensor, i.e. channels-last memory).
"""

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_hw
from .layers import (BatchNorm, Conv2d, KerasLayer, SepConvBN, Spec, conv2d_same,
                     global_average_pool)

NOT_PORTED_MOBILENET = ("the MobileNetV2 backbone is not ported yet "
                        "(ROADMAP Queue 1: 'MobileNet and the decoder variants')")
NOT_PORTED_DECODERS = ("the only_DCNN / only_ASPP decoder variants are not ported "
                       "yet (ROADMAP Queue 1: 'MobileNet and the decoder variants')")


@dataclasses.dataclass(frozen=True)
class DeepLabConfig:
    input_shape: Tuple[int, int, int] = (512, 512, 3)
    classes: int = 21
    os: int = 16
    backbone: str = "xception"  # "xception" | "mobilenet"
    alpha: float = 1.0          # mobilenet width multiplier
    weights: Optional[str] = "pascal_voc"
    last_activation: Optional[str] = None  # None | "softmax" | "sigmoid"
    reshape_outputs: bool = False
    final_upsample: bool = True
    final_class_prediction: bool = True
    only_dcnn_output: bool = False
    only_aspp_output: bool = False
    first_upsample_size: Tuple[int, int] = (128, 128)
    compute_dtype: str = "float32"  # "float32" | "bfloat16"

    def __post_init__(self):
        if self.backbone not in ("xception", "mobilenet"):
            raise ValueError("Backbone must be either xception or mobilenet")
        if self.last_activation not in (None, "softmax", "sigmoid"):
            raise ValueError("last_activation must be None, softmax or sigmoid")
        if self.weights not in (None, "pascal_voc"):
            raise ValueError("weights must be None or 'pascal_voc'")
        if self.only_dcnn_output and self.only_aspp_output:
            raise ValueError("only_dcnn_output and only_aspp_output are exclusive")
        if self.backbone == "mobilenet":
            object.__setattr__(self, "os", 8)

    @property
    def xception_rates(self):
        """(entry_block3_stride, middle_block_rate, exit_block_rates, atrous_rates)."""
        if self.os == 8:
            return 1, 2, (2, 4), (12, 24, 36)
        return 2, 1, (1, 2), (6, 12, 18)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def head_layer_name(cfg: DeepLabConfig) -> str:
    """'logits_semantic' only when the pretrained head is loadable by name."""
    if cfg.classes == 21 and cfg.weights == "pascal_voc":
        return "logits_semantic"
    return "custom_logits_semantic"


class XceptionBlock(nn.Module):
    """3 SepConv_BN + conv / sum / no shortcut."""

    def __init__(self, prefix: str, in_ch: int, filters, skip_type: Optional[str],
                 last_stride: int, rate: int = 1, depth_activation: bool = False,
                 *, dtype, device=None):
        super().__init__()
        chans = [in_ch] + list(filters)
        self.convs = nn.ModuleList([
            SepConvBN(f"{prefix}_separable_conv{i + 1}", chans[i], chans[i + 1],
                      stride=last_stride if i == 2 else 1, rate=rate,
                      depth_activation=depth_activation, dtype=dtype, device=device)
            for i in range(3)])
        self.skip_type = skip_type
        if skip_type == "conv":
            self.shortcut = conv2d_same(prefix + "_shortcut", in_ch, filters[-1],
                                        stride=last_stride, kernel_size=1,
                                        dtype=dtype, device=device)
            self.shortcut_bn = BatchNorm(prefix + "_shortcut_BN", filters[-1],
                                         device=device)

    def forward(self, x: torch.Tensor):
        """Returns (output, the second separable conv's output)."""
        residual = x
        skip = None
        for i, conv in enumerate(self.convs):
            residual = conv(residual)
            if i == 1:
                skip = residual
        if self.skip_type == "conv":
            return residual + self.shortcut_bn(self.shortcut(x)), skip
        if self.skip_type == "sum":
            return residual + x, skip
        return residual, skip


class XceptionBackbone(nn.Module):
    def __init__(self, cfg: DeepLabConfig, *, device=None):
        super().__init__()
        dt = cfg.dtype
        entry_stride, middle_rate, exit_rates, _ = cfg.xception_rates
        kw = dict(dtype=dt, device=device)
        self.conv1_1 = Conv2d("entry_flow_conv1_1", cfg.input_shape[2], 32, 3,
                              stride=2, **kw)
        self.bn1_1 = BatchNorm("entry_flow_conv1_1_BN", 32, device=device)
        self.conv1_2 = Conv2d("entry_flow_conv1_2", 32, 64, 3, **kw)
        self.bn1_2 = BatchNorm("entry_flow_conv1_2_BN", 64, device=device)
        self.block1 = XceptionBlock("entry_flow_block1", 64, [128, 128, 128],
                                    "conv", 2, **kw)
        self.block2 = XceptionBlock("entry_flow_block2", 128, [256, 256, 256],
                                    "conv", 2, **kw)
        self.block3 = XceptionBlock("entry_flow_block3", 256, [728, 728, 728],
                                    "conv", entry_stride, **kw)
        self.middle = nn.ModuleList([
            XceptionBlock(f"middle_flow_unit_{i + 1}", 728, [728, 728, 728], "sum",
                          1, rate=middle_rate, **kw) for i in range(16)])
        self.exit1 = XceptionBlock("exit_flow_block1", 728, [728, 1024, 1024],
                                   "conv", 1, rate=exit_rates[0], **kw)
        self.exit2 = XceptionBlock("exit_flow_block2", 1024, [1536, 1536, 2048],
                                   None, 1, rate=exit_rates[1],
                                   depth_activation=True, **kw)

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn1_1(self.conv1_1(x)))
        x = F.relu(self.bn1_2(self.conv1_2(x)))
        x, _ = self.block1(x)
        x, skip = self.block2(x)
        x, _ = self.block3(x)
        for block in self.middle:
            x, _ = block(x)
        x, _ = self.exit1(x)
        x, _ = self.exit2(x)
        return x, skip


class ASPP(nn.Module):
    def __init__(self, cfg: DeepLabConfig, in_ch: int, *, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.pool_conv = Conv2d("image_pooling", in_ch, 256, 1, **kw)
        self.pool_bn = BatchNorm("image_pooling_BN", 256, 1e-5, device=device)
        self.aspp0 = Conv2d("aspp0", in_ch, 256, 1, **kw)
        self.aspp0_bn = BatchNorm("aspp0_BN", 256, 1e-5, device=device)
        self.atrous = nn.ModuleList([
            SepConvBN(f"aspp{i}", in_ch, 256, rate=rate, depth_activation=True, **kw)
            for i, rate in enumerate(cfg.xception_rates[3], start=1)])
        self.projection = Conv2d("concat_projection", 256 * (2 + len(self.atrous)),
                                 256, 1, **kw)
        self.projection_bn = BatchNorm("concat_projection_BN", 256, 1e-5,
                                       device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pool = F.relu(self.pool_bn(self.pool_conv(global_average_pool(x))))
        pool = resize_hw(pool, x.shape[-2:], "bilinear").to(x.dtype)
        b0 = F.relu(self.aspp0_bn(self.aspp0(x)))
        branches = [pool, b0] + [conv(x) for conv in self.atrous]
        out = self.projection(torch.cat(branches, dim=1))
        return F.relu(self.projection_bn(out))


class Decoder(nn.Module):
    def __init__(self, cfg: DeepLabConfig, in_ch: int, skip_ch: int, *, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.projection = Conv2d("feature_projection0", skip_ch, 48, 1, **kw)
        self.projection_bn = BatchNorm("feature_projection0_BN", 48, 1e-5,
                                       device=device)
        self.conv0 = SepConvBN("decoder_conv0", in_ch + 48, 256,
                               depth_activation=True, epsilon=1e-5, **kw)
        self.conv1 = SepConvBN("decoder_conv1", 256, 256, depth_activation=True,
                               epsilon=1e-5, **kw)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = resize_hw(x, skip.shape[-2:], "bilinear").to(skip.dtype)
        dec_skip = F.relu(self.projection_bn(self.projection(skip)))
        return self.conv1(self.conv0(torch.cat([x, dec_skip], dim=1)))


class DeepLab(nn.Module):
    """DeepLabV3+ (Xception). ``forward``: (B, H, W, 3) -> (B, h, w, classes)
    float32 logits, h = H / 4 without the final upsample."""

    def __init__(self, cfg: DeepLabConfig, *, device=None):
        super().__init__()
        if cfg.backbone != "xception":
            raise NotImplementedError(NOT_PORTED_MOBILENET)
        if cfg.only_dcnn_output or cfg.only_aspp_output:
            raise NotImplementedError(NOT_PORTED_DECODERS)
        self.cfg = cfg
        self.backbone = XceptionBackbone(cfg, device=device)
        self.aspp = ASPP(cfg, 2048, device=device)
        self.decoder = Decoder(cfg, 256, 256, device=device)
        self.head = None
        if cfg.final_class_prediction:
            self.head = Conv2d(head_layer_name(cfg), 256, cfg.classes, 1,
                               use_bias=True, dtype=cfg.dtype, device=device)

    def keras_layers(self) -> Iterator[KerasLayer]:
        """Leaf layers in the order the reference creates their parameters."""
        for module in self.modules():
            if isinstance(module, KerasLayer):
                yield module

    def specs(self) -> Iterator[Spec]:
        for layer in self.keras_layers():
            yield from layer.specs()

    @torch.no_grad()
    def load_params(self, params: Dict[str, Dict[str, torch.Tensor]]) -> "DeepLab":
        """Load port-layout tensors keyed like the reference's param dict
        (``weights.params_from_jax``). Every layer must be present."""
        for layer in self.keras_layers():
            if layer.keras_name not in params:
                raise KeyError(f"Missing parameters for layer {layer.keras_name}")
            layer.load(params[layer.keras_name])
        return self

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = image.to(cfg.dtype).permute(0, 3, 1, 2)
        encoder_out, skip = self.backbone(x)
        out = self.decoder(self.aspp(encoder_out), skip)
        if self.head is not None:
            out = self.head(out)
        out = out.float()
        if cfg.final_upsample:
            out = resize_hw(out, cfg.input_shape[:2], "bilinear")
        out = out.permute(0, 2, 3, 1)
        if cfg.reshape_outputs:
            out = out.reshape(out.shape[0], -1, cfg.classes)
        if cfg.last_activation == "softmax":
            out = torch.softmax(out, dim=-1)
        elif cfg.last_activation == "sigmoid":
            out = torch.sigmoid(out)
        return out
