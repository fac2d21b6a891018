"""DeepLabV3+ with the Xception or MobileNetV2 backbone as an ``nn.Module``.

Port of the JAX package's ``models/deeplab.py``: the Xception backbone at
OS 16 or 8 (entry / middle / exit flows) or MobileNetV2 (OS forced to 8),
ASPP with the image-pooling branch (only it and ``aspp0`` for MobileNetV2),
the standard decoder or its only_DCNN / only_ASPP variants (Xception; none
for MobileNetV2) and the class head. Modules are registered in the order
the reference's forward creates its parameters, which ``models/weights.py``
relies on to reproduce the reference's random init.

The public forward takes and returns NHWC like the reference,
(B, H, W, 3) -> (B, h, w, classes) float32 logits; inside, the network runs
NCHW (a permuted NHWC tensor, i.e. channels-last memory). ``forward_train``
runs the same modules in training mode (``layers.BatchStatStore``): weights
from a dict of f32 master tensors, batch-statistics BatchNorm.
"""

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_hw
from .layers import (BatchNorm, BatchStatStore, Conv2d, DepthwiseConv2d, KerasLayer,
                     SepConvBN, Spec, conv2d_same, global_average_pool, make_divisible,
                     relu, relu6, segment)

Store = Optional[BatchStatStore]
BNStats = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


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

    def forward(self, x: torch.Tensor, store: Store = None):
        """Returns (output, the second separable conv's output)."""
        residual = x
        skip = None
        for i, conv in enumerate(self.convs):
            residual = conv(residual, store)
            if i == 1:
                skip = residual
        if self.skip_type == "conv":
            return residual + self.shortcut_bn(self.shortcut(x, store), store), skip
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

    def forward(self, x: torch.Tensor, store: Store = None):
        x = relu(self.bn1_1(self.conv1_1(x, store), store))
        x = relu(self.bn1_2(self.conv1_2(x, store), store))
        x, _ = segment(self.block1, store, x)
        x, skip = segment(self.block2, store, x)
        x, _ = segment(self.block3, store, x)
        for block in self.middle:
            x, _ = segment(block, store, x)
        x, _ = segment(self.exit1, store, x)
        x, _ = segment(self.exit2, store, x)
        return x, skip


class InvertedResBlock(nn.Module):
    """MobileNetV2's expand (1x1) -> depthwise 3x3 -> project (1x1) block,
    BN eps 1e-3, ReLU6, with an optional identity shortcut."""

    def __init__(self, block_id: int, in_ch: int, filters: int, stride: int,
                 rate: int, skip: bool, alpha: float, expansion: int = 6, *,
                 dtype, device=None):
        super().__init__()
        prefix = f"expanded_conv_{block_id}_"
        hidden = expansion * in_ch
        self.out_ch = make_divisible(int(filters * alpha), 8)
        self.skip = skip
        kw = dict(dtype=dtype, device=device)
        self.expand = Conv2d(prefix + "expand", in_ch, hidden, 1, **kw)
        self.expand_bn = BatchNorm(prefix + "expand_BN", hidden, device=device)
        self.depthwise = DepthwiseConv2d(prefix + "depthwise", hidden, 3, stride, rate,
                                         "SAME", **kw)
        self.depthwise_bn = BatchNorm(prefix + "depthwise_BN", hidden, device=device)
        self.project = Conv2d(prefix + "project", hidden, self.out_ch, 1, **kw)
        self.project_bn = BatchNorm(prefix + "project_BN", self.out_ch, device=device)

    def forward(self, x: torch.Tensor, store: Store = None) -> torch.Tensor:
        y = relu6(self.expand_bn(self.expand(x, store), store))
        y = relu6(self.depthwise_bn(self.depthwise(y, store), store))
        y = self.project_bn(self.project(y, store), store)
        return x + y if self.skip else y


# (filters, stride, rate, skip) of blocks 1-16, reference model.py:339-379.
MOBILENET_BLOCKS = (
    (24, 2, 1, False), (24, 1, 1, True),
    (32, 2, 1, False), (32, 1, 1, True), (32, 1, 1, True),
    (64, 1, 1, False), (64, 1, 2, True), (64, 1, 2, True), (64, 1, 2, True),
    (96, 1, 2, False), (96, 1, 2, True), (96, 1, 2, True),
    (160, 1, 2, False), (160, 1, 4, True), (160, 1, 4, True),
    (320, 1, 4, False),
)


class MobileNetBackbone(nn.Module):
    """MobileNetV2 at output stride 8 (atrous rates after the third stride)."""

    def __init__(self, cfg: DeepLabConfig, *, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        first = make_divisible(32 * cfg.alpha, 8)
        in_ch = cfg.input_shape[2]
        # TF "SAME" padding on stride 2: (0, 1) on an even input.
        self.conv = Conv2d("Conv" if in_ch == 3 else "Conv_", in_ch, first, 3,
                           stride=2, **kw)
        self.conv_bn = BatchNorm("Conv_BN", first, device=device)
        self.depthwise = DepthwiseConv2d("expanded_conv_depthwise", first, 3, **kw)
        self.depthwise_bn = BatchNorm("expanded_conv_depthwise_BN", first, device=device)
        ch = make_divisible(int(16 * cfg.alpha), 8)
        self.project = Conv2d("expanded_conv_project", first, ch, 1, **kw)
        self.project_bn = BatchNorm("expanded_conv_project_BN", ch, device=device)
        blocks = []
        for block_id, (filters, stride, rate, skip) in enumerate(MOBILENET_BLOCKS, start=1):
            blocks.append(InvertedResBlock(block_id, ch, filters, stride, rate, skip,
                                           cfg.alpha, **kw))
            ch = blocks[-1].out_ch
        self.blocks = nn.ModuleList(blocks)
        self.out_ch = ch

    def forward(self, x: torch.Tensor, store: Store = None) -> torch.Tensor:
        x = relu6(self.conv_bn(self.conv(x, store), store))
        x = relu6(self.depthwise_bn(self.depthwise(x, store), store))
        x = self.project_bn(self.project(x, store), store)
        for block in self.blocks:
            x = segment(block, store, x)
        return x


class ASPP(nn.Module):
    def __init__(self, cfg: DeepLabConfig, in_ch: int, *, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.pool_conv = Conv2d("image_pooling", in_ch, 256, 1, **kw)
        self.pool_bn = BatchNorm("image_pooling_BN", 256, 1e-5, device=device)
        self.aspp0 = Conv2d("aspp0", in_ch, 256, 1, **kw)
        self.aspp0_bn = BatchNorm("aspp0_BN", 256, 1e-5, device=device)
        # MobileNetV2's ASPP has only the pooling and aspp0 branches.
        rates = cfg.xception_rates[3] if cfg.backbone == "xception" else ()
        self.atrous = nn.ModuleList([
            SepConvBN(f"aspp{i}", in_ch, 256, rate=rate, depth_activation=True, **kw)
            for i, rate in enumerate(rates, start=1)])
        self.projection = Conv2d("concat_projection", 256 * (2 + len(self.atrous)),
                                 256, 1, **kw)
        self.projection_bn = BatchNorm("concat_projection_BN", 256, 1e-5,
                                       device=device)

    def forward(self, x: torch.Tensor, store: Store = None) -> torch.Tensor:
        pool = self.pool_conv(global_average_pool(x), store)
        pool = relu(self.pool_bn(pool, store))
        pool = resize_hw(pool, x.shape[-2:], "bilinear").to(x.dtype)
        b0 = relu(self.aspp0_bn(self.aspp0(x, store), store))
        branches = [pool, b0] + [conv(x, store) for conv in self.atrous]
        out = self.projection(torch.cat(branches, dim=1), store)
        return relu(self.projection_bn(out, store))


class Decoder(nn.Module):
    """The standard decoder (upsampled ASPP output + projected skip), or a
    variant: only_DCNN (the projected backbone output alone) or only_ASPP
    (the ASPP output alone), both upsampled to cfg.first_upsample_size."""

    def __init__(self, cfg: DeepLabConfig, in_ch: int, skip_ch: int, *, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.variant = ("only_dcnn" if cfg.only_dcnn_output else
                        "only_aspp" if cfg.only_aspp_output else "standard")
        self.upsample_size = cfg.first_upsample_size
        if self.variant != "only_aspp":
            self.projection = Conv2d("feature_projection0", skip_ch, 48, 1, **kw)
            self.projection_bn = BatchNorm("feature_projection0_BN", 48, 1e-5,
                                           device=device)
        conv0_in = {"standard": in_ch + 48, "only_dcnn": 48, "only_aspp": in_ch}
        self.conv0 = SepConvBN("decoder_conv0", conv0_in[self.variant], 256,
                               depth_activation=True, epsilon=1e-5, **kw)
        self.conv1 = SepConvBN("decoder_conv1", 256, 256, depth_activation=True,
                               epsilon=1e-5, **kw)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor],
                store: Store = None) -> torch.Tensor:
        """x: the ASPP output (standard, only_ASPP) or the backbone output
        (only_DCNN); skip: the low-level features (standard only)."""
        if self.variant == "standard":
            x = resize_hw(x, skip.shape[-2:], "bilinear").to(skip.dtype)
            dec_skip = relu(self.projection_bn(self.projection(skip, store), store))
            x = torch.cat([x, dec_skip], dim=1)
        else:
            if self.variant == "only_dcnn":
                x = relu(self.projection_bn(self.projection(x, store), store))
            x = resize_hw(x, self.upsample_size, "bilinear").to(x.dtype)
        return self.conv1(self.conv0(x, store), store)


class DeepLab(nn.Module):
    """DeepLabV3+ (Xception or MobileNetV2). ``forward``: (B, H, W, 3) ->
    (B, h, w, classes) float32 logits; without the final upsample h = H / 4
    (Xception, standard decoder), H / 8 (MobileNetV2) or the decoder
    variants' first_upsample_size."""

    def __init__(self, cfg: DeepLabConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.decoder = None
        if cfg.backbone == "xception":
            self.backbone = XceptionBackbone(cfg, device=device)
            self.aspp = ASPP(cfg, 2048, device=device)
            self.decoder = Decoder(cfg, 256, 2048 if cfg.only_dcnn_output else 256,
                                   device=device)
        else:
            self.backbone = MobileNetBackbone(cfg, device=device)
            # No decoder: the ASPP output feeds the head.
            self.aspp = ASPP(cfg, self.backbone.out_ch, device=device)
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

    def forward(self, image: torch.Tensor, store: Store = None) -> torch.Tensor:
        cfg = self.cfg
        x = image.to(cfg.dtype).permute(0, 3, 1, 2)
        if self.decoder is None:
            out = segment(self.aspp, store, self.backbone(x, store))
        else:
            encoder_out, skip = self.backbone(x, store)
            if self.decoder.variant == "only_dcnn":
                # The ASPP output is unused; in training the reference still
                # runs it, so its BN layers record batch statistics (and
                # their moving statistics move).
                if store is not None:
                    segment(self.aspp, store, encoder_out)
                out = segment(self.decoder, store, encoder_out, None)
            else:
                out = segment(self.decoder, store, segment(self.aspp, store, encoder_out),
                              skip)
        if self.head is not None:
            out = self.head(out, store)
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

    def forward_train(self, image: torch.Tensor,
                      params: Dict[str, Dict[str, torch.Tensor]], remat: bool = False,
                      sync_group=None) -> Tuple[torch.Tensor, BNStats]:
        """The forward in training mode: weights from ``params`` (f32 master
        tensors keyed like ``weights.params_from_jax``'s dict), cast to the
        compute dtype in the graph; batch-statistics BatchNorm. Returns
        (logits, bn_batch_stats), the latter mapping each BN layer's name to
        its batch (mean, var). The module's own buffers are not read, so a
        model built on the "meta" device serves. remat=True checkpoints each
        block of the backbone, ASPP and the decoder (``layers.segment``):
        the same numbers, activations recomputed in the backward.
        sync_group: synchronised BatchNorm over that process group's ranks
        (``layers.BatchStatStore``)."""
        store = BatchStatStore(params, remat=remat, sync_group=sync_group)
        return self.forward(image, store), store.bn_batch_stats
