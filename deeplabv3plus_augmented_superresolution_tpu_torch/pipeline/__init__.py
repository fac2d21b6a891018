from .augment import (make_augmented_copies, sample_augmentations, sample_warp_draws,
                      warp_augment_batch, warp_augment_batch_with_draws)
from .end_to_end import asr_step, asr_step_multiclass

__all__ = ["make_augmented_copies", "sample_augmentations", "sample_warp_draws",
           "warp_augment_batch", "warp_augment_batch_with_draws", "asr_step",
           "asr_step_multiclass"]
