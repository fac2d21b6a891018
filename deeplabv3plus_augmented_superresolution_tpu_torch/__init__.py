"""PyTorch / CUDA port of the Augmented Super-Resolution (ASR) framework.

The JAX package ``deeplabv3plus_augmented_superresolution_tpu`` is the
reference: this package mirrors its subpackages (``ops/ models/ sr/
pipeline/ data/ cli/``) so every module has a counterpart of the same name,
and its public functions keep the reference's tensor layouts (images NHWC,
the SR target ``(1, H, W, 1)``, the Gram stencil ``(Sy, Sx, H, W)``).

The hand-written kernels are the fractional shears of the warp: the shift
along W with one shift per row (``csrc/shear_rows.cu``) and the shift along H
with one shift per column (``csrc/shear_cols.cu``), both bound in
``ops/shear_kernel.py``. They are built with ``nvcc`` at first use; a CUDA
tensor always goes through them, a CPU tensor through their plain PyTorch
versions (``ops/shear_warp.shear_rows`` and ``shear_cols``).

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
