"""The yardstick's counts against hand counts at tiny shapes."""

import json
import os

import pytest
import torch

from asr_bench import counts
from asr_bench.reference import deeplab as ref_net

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs")


def test_convolution_and_resize_flops():
    """2 x multiply-adds: a 3x3 conv 4 -> 6 on 5x7 with stride 1, a
    depthwise 3x3 on 4 channels, and a 5x7 -> 10x14 resize of 6 planes."""
    flops = [0]
    net = ref_net.Net(ref_net.Params(), flops=flops)
    x = torch.empty((2, 4, 5, 7), device="meta")
    y = net.conv(x, "a", 4, 6, 3)
    assert flops[0] == 2 * (2 * 6 * 5 * 7) * 4 * 9
    flops[0] = 0
    net.conv(x, "b", 4, 4, 3, depthwise=True)
    assert flops[0] == 2 * (2 * 4 * 5 * 7) * 9
    flops[0] = 0
    net.resize(y, (10, 14))
    assert flops[0] == 2 * 12 * (10 * 5 * 7 + 10 * 7 * 14)


@pytest.mark.parametrize("name", ["xception-os16", "mobilenetv2-os8"])
def test_forward_flops_scale_with_the_batch(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["input_size"] = [64, 64]
    one = counts.forward_flops(cfg, 1)
    assert one > 0 and counts.forward_flops(cfg, 3) == 3 * one


def test_head_flops_by_hand():
    """The head alone of the full Xception configuration at 512 px: a 1x1
    conv 256 -> 21 on 128 x 128, counted in the whole forward."""
    with open(os.path.join(CONFIGS, "xception-os16.json")) as f:
        cfg = json.load(f)
    flops = [0]
    net = ref_net.Net(ref_net.Params(), flops=flops)
    net.conv(torch.empty((1, 256, 128, 128), device="meta"), "logits_semantic", 256, 21,
             bias=True)
    assert flops[0] == 2 * 21 * 128 * 128 * 256
    assert counts.forward_flops(cfg, 1) > flops[0]


def test_warp_and_solve_counts():
    assert counts.copies_warp_bytes(2, 3, 4, 5) == 2 * (1 + 3) * 3 * 4 * 5 * 2
    assert counts.SOLVE_OPS_PER_PIXEL_STEP == 158
    assert counts.solve_ops(2, 3, 4, 5) == 2 * 3 * 4 * 5 * 158
    assert counts.solve_bytes(2, 4, 5) == (63 + 4) * 4 * 5 * 4
    pixels = 4 * 5
    assert counts.step_flops(1000, 2, 3, 1, 7, 4, 5, ["aug", "max"]) == (
        1000 + 9 * 3 * 2 * 3 * pixels + 2 * 7 * pixels * 158 + 2 * 9 * 3 * 2 * pixels
        + 9 * 3 * 2 * pixels)
