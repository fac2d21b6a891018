from .augment import make_augmented_copies, sample_augmentations
from .end_to_end import asr_step, asr_step_multiclass

__all__ = ["make_augmented_copies", "sample_augmentations", "asr_step",
           "asr_step_multiclass"]
