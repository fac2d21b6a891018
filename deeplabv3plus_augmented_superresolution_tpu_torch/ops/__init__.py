from .resize import resize, resize_hw, resize_matrix
from .shear_warp import (paeth_inverse_rotate_translate, paeth_rotate_translate,
                         shear_cols, shear_cols_dispatch, shear_rows,
                         shear_rows_dispatch)
from .shear_kernel import shear_cols_cuda, shear_rows_cuda
from .fused_operator import fused_warp_downsample
from .opm import (extract_masks, extract_masks_multiclass, min_max_normalization,
                  normalize_stack, prepare_sr_inputs)
from .gradients import (bilateral_tv, image_gradients, image_gradients_transpose,
                        total_variation)

__all__ = [
    "resize",
    "resize_hw",
    "resize_matrix",
    "paeth_rotate_translate",
    "paeth_inverse_rotate_translate",
    "shear_cols",
    "shear_cols_cuda",
    "shear_cols_dispatch",
    "shear_rows",
    "shear_rows_cuda",
    "shear_rows_dispatch",
    "fused_warp_downsample",
    "extract_masks",
    "extract_masks_multiclass",
    "min_max_normalization",
    "normalize_stack",
    "prepare_sr_inputs",
    "bilateral_tv",
    "image_gradients",
    "image_gradients_transpose",
    "total_variation",
]
