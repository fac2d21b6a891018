from .augment import (create_augmented_copies, make_augmented_copies, sample_augmentations,
                      sample_warp_draws, warp_augment_batch, warp_augment_batch_with_draws)
from .end_to_end import asr_step, asr_step_multiclass
from .feature_maps import augmented_feature_maps, compute_augmented_feature_maps

__all__ = ["create_augmented_copies", "make_augmented_copies", "sample_augmentations",
           "sample_warp_draws", "warp_augment_batch", "warp_augment_batch_with_draws",
           "asr_step", "asr_step_multiclass", "augmented_feature_maps",
           "compute_augmented_feature_maps"]
