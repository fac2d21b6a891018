"""The plain reference against the program, on the CPU at small sizes, each
side given the same inputs: the network's logits, the ASR layers on the
same mask stacks, the TTA draw and the scenes (frozen copies)."""

import json
import os

import numpy as np
import pytest
import torch

from asr_bench import run
from asr_bench.check import normalize
from asr_bench.reference import asr as ref_asr
from asr_bench.reference import deeplab as ref_net
from asr_bench.scenes import make_scenes, synthetic_scene
from asr_bench.tta import tta_set
from asr_bench.weights import make_weights
from deeplabv3plus_augmented_superresolution_tpu_torch.cli._common import SEED
from deeplabv3plus_augmented_superresolution_tpu_torch.data.synthetic import (
    synthetic_scene as program_scene)
from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline.augment import (
    sample_augmentations)
from deeplabv3plus_augmented_superresolution_tpu_torch.sr.solver import (
    augmented_superresolution, multiclass_max_mean_superresolution)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs")


def _config(name, size):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        cfg = json.load(f)
    cfg.update(input_size=[size, size], compute_dtype="float32")
    return cfg


@pytest.mark.parametrize("name", ["xception-os16", "mobilenetv2-os8"])
def test_network_logits_match_the_program(name):
    """The program's float32 forward and the reference's, from one weights
    dict: equal to float32 rounding."""
    cfg = _config(name, 64)
    weights = make_weights(cfg, 3, "cpu")
    model = run.build_program_model(cfg, weights, "cpu")
    images = torch.as_tensor(np.stack(make_scenes(3, 3, (64, 64), list(range(1, 21)), 3)))
    want = ref_net.logits(weights, images, cfg)
    got = model(images)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


class _Model:
    cfg = type("cfg", (), {"backbone": "xception", "input_shape": (128, 128, 3)})()


def _masks(angles, shifts):
    """(1, N, 32, 32) normalised masks: an ellipse pushed through the
    reference operator and binarised."""
    yy, xx = torch.meshgrid(torch.arange(128.0), torch.arange(128.0), indexing="ij")
    hr = (((yy - 60) ** 2 / 900 + (xx - 68) ** 2 / 500) < 1).float()
    lr = (ref_asr.operator(hr[None], angles, shifts, (32, 32))[:, 0] > 0.5).float()
    return normalize(lr[None] > 0, [8])


def test_asr_layers_match_the_program():
    """The same mask stacks through the program's solve (Gram stencil,
    shear warp) and max/mean, and through the reference's explicit
    operator: estimates within 0.06 (aug) and 0.05 (max, mean) of a peak of
    1, thresholded masks equal on 99.5% of the pixels or more."""
    cfg = _config("xception-os16", 128)
    cfg["asr"] = dict(cfg["asr"], num_aug=8, num_iter=60, shift_max=10.0)
    sr_cfg = run.program_sr_config(cfg, _Model())
    angles, shifts = tta_set(SEED, 8, 0.15, 10.0)
    masks = _masks(angles, shifts)
    want = ref_asr.aug_solve(masks, angles, shifts, cfg["asr"], (128, 128))[0]
    got = augmented_superresolution(masks[0][..., None], angles, shifts, sr_cfg)[0][..., 0]
    assert float((got - want).abs().max()) < 0.06
    agree = (ref_asr.threshold(got[None], 0.2) == ref_asr.threshold(want[None], 0.2))
    assert float(agree.float().mean()) >= 0.995
    mx, mean = ref_asr.max_mean(masks, angles, shifts, (128, 128))
    pmx, pmean = multiclass_max_mean_superresolution(masks[..., None], angles, shifts, sr_cfg)
    assert float((pmx[0, ..., 0] - mx[0]).abs().max()) < 0.05
    assert float((pmean[0, ..., 0] - mean[0]).abs().max()) < 0.05


def test_tta_draw_is_the_programs():
    want = sample_augmentations(torch.Generator().manual_seed(SEED), 100, 0.15, 80.0,
                                device="cpu")
    got = tta_set(SEED, 100, 0.15, 80.0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_scenes_are_the_programs():
    for seed in (0, 2 ** 31 + 5):
        got = synthetic_scene(np.random.default_rng(seed), (96, 80), list(range(1, 21)), 3)
        want, _ = program_scene(np.random.default_rng(seed), (96, 80), list(range(1, 21)), 3)
        np.testing.assert_array_equal(got, want)
