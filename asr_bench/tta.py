"""The run's fixed test-time-augmentation set, drawn as the program draws
it: a frozen copy of ``pipeline/augment.sample_augmentations`` seeded as
``cli/run_asr.serve`` seeds it (``tta_seed`` in the configuration, the
program's ``cli/_common.SEED``). The reference reads this draw, not the
program's."""

from typing import Tuple

import torch


def tta_set(tta_seed: int, num_aug: int, angle_max: float, shift_max: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(angles (N,) rad, shifts (N, 2) px) on the CPU, copy 0 the identity."""
    g = torch.Generator().manual_seed(int(tta_seed))
    u_angle = torch.rand(num_aug, generator=g, dtype=torch.float32)
    u_shift = torch.rand((num_aug, 2), generator=g, dtype=torch.float32)
    angles = -angle_max + u_angle * (2.0 * angle_max)
    shifts = -shift_max + u_shift * (2.0 * shift_max)
    angles[0] = 0.0
    shifts[0] = 0.0
    return angles, shifts
