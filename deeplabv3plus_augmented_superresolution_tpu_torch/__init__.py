"""PyTorch / CUDA port of the Augmented Super-Resolution (ASR) framework.

The JAX package ``deeplabv3plus_augmented_superresolution_tpu`` is the
reference: this package mirrors its subpackages (``ops/ models/ sr/
pipeline/ data/ cli/``) so every module has a counterpart of the same name,
and its public functions keep the reference's tensor layouts (images NHWC,
the SR target ``(1, H, W, 1)``, the Gram stencil ``(Sy, Sx, H, W)``).

The one hand-written kernel is the per-row fractional shear
(``csrc/shear_rows.cu``, bound in ``ops/shear_kernel.py``). It is built with
``nvcc`` at first use; a CUDA tensor always goes through it, a CPU tensor
through its plain PyTorch version (``ops/shear_warp.shear_rows``).

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
