"""Faults planted under the timed path, to show that the check sees them
(``tests/test_asr_bench_faults.py`` on the CPU, ``calibrate --fault_seeds``
on the card): each a context manager that patches one function of the
program. The benchmark's own runs plant none."""

import contextlib
from unittest import mock

import torch

PORT = "deeplabv3plus_augmented_superresolution_tpu_torch"


@contextlib.contextmanager
def solve_returns_its_state():
    """Every optimizer step of the SR solve returns the estimate unchanged."""
    with mock.patch(f"{PORT}.sr.optimizer._Optimizer.step", lambda self, param, grad: param):
        yield


@contextlib.contextmanager
def half_the_batch_left_out():
    """The network sees the first half of each step's images; the second
    half's predictions are copies of the first half's (the mean over the
    step is then taken over the half that ran)."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import end_to_end

    real = end_to_end._forward

    def forward(model, images, *args):
        preds = real(model, images, *args)                 # (B, N, h, w, classes)
        half = max(images.shape[0] // 2, 1)
        return torch.cat([preds[:half]] * (images.shape[0] // half + 1))[:images.shape[0]]

    with mock.patch.object(end_to_end, "_forward", forward):
        yield


@contextlib.contextmanager
def copies_unwarped():
    """The network sees every copy as the unwarped image."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import end_to_end

    def copies(images, angles, shifts, num_aug, **kw):
        return images[None].expand(num_aug, *images.shape).contiguous()

    with mock.patch.object(end_to_end, "make_augmented_copies", copies):
        yield


@contextlib.contextmanager
def half_the_copies_left_out_of_the_mean():
    """mean SR over the first half of the copies only."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.sr import solver

    with mock.patch.object(solver, "_copies_mean",
                           lambda up, cfg: up[: up.shape[0] // 2].mean(dim=0)):
        yield


@contextlib.contextmanager
def answer_altered():
    """Each thresholded mask has an eighth-by-eighth block at its centre
    inverted where it is produced."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import end_to_end

    real = end_to_end.threshold_image

    def threshold(image, th_value, th_factor=0.15, th_mask=None):
        out = real(image, th_value, th_factor, th_mask)
        h, w = out.shape[-3], out.shape[-2]
        rows, cols = slice(h // 2 - h // 16, h // 2 + h // 16), slice(w // 2 - w // 16,
                                                                      w // 2 + w // 16)
        block = out[..., rows, cols, :]
        out[..., rows, cols, :] = torch.where(block > 0, torch.zeros_like(block),
                                              torch.ones_like(block) * th_value)
        return out

    with mock.patch.object(end_to_end, "threshold_image", threshold):
        yield


FAULTS = {f.__name__: f for f in (solve_returns_its_state, half_the_batch_left_out,
                                   copies_unwarped, half_the_copies_left_out_of_the_mean,
                                   answer_altered)}
