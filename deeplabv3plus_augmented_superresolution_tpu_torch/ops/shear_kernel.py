"""Build, bind and launch the CUDA per-row shear kernel (``csrc/shear_rows.cu``).

The kernel replaces the JAX package's Pallas kernel
``ops/pallas_shear.py::_shear_rows_pallas_impl``. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface and
loaded with ``ctypes``. The build happens at first use, from the sources in
this package, into ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``); the file name carries a hash of the source and flags, so an
edited source is rebuilt. Builds therefore need a source checkout (or an
editable install): a non-editable install would place that directory beside
``site-packages``.

``shear_rows_cuda`` takes only CUDA tensors and raises on anything it cannot
run: there is no fallback. Its plain PyTorch version is
``ops/shear_warp.shear_rows``; ``ops/shear_warp.shear_rows_dispatch`` picks
between the two by the device of the tensor.

``shear_rows_cuda.launches`` counts the kernel launches of the process, so a
run can show that its path went through the kernel.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "shear_rows.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA shear kernel cannot be built")


def build(ptxas_verbose: bool = False) -> Tuple[Path, str]:
    """Compile the kernel library if it is not built yet.

    Returns (library path, compiler diagnostics). With ptxas_verbose the
    library is compiled anew and the diagnostics hold ptxas's register and
    spill report."""
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if ptxas_verbose else ())
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    out = BUILD_DIR / f"libshear_rows_{tag}.so"
    if out.exists() and not ptxas_verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        launch_args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        for name in ("shear_rows_f32", "shear_rows_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = launch_args
            fn.restype = ctypes.c_int
        lib.shear_rows_error_string.argtypes = [ctypes.c_int]
        lib.shear_rows_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_args(images: torch.Tensor, s: torch.Tensor) -> None:
    """Raise unless (images, s) is a call the kernel takes: images (N, H, W)
    float32/bfloat16, s (N, H) float32, both contiguous, on one device."""
    if images.dim() != 3:
        raise ValueError(f"images must be (N, H, W), got shape {tuple(images.shape)}")
    if tuple(s.shape) != tuple(images.shape[:2]):
        raise ValueError(f"s must be (N, H) = {tuple(images.shape[:2])}, "
                         f"got {tuple(s.shape)}")
    if images.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"images must be float32 or bfloat16, got {images.dtype}")
    if s.dtype != torch.float32:
        raise TypeError(f"s must be float32, got {s.dtype}")
    if not (images.is_contiguous() and s.is_contiguous()):
        raise ValueError("images and s must be contiguous (rows are read as "
                         "contiguous runs); call .contiguous() first")
    if images.device != s.device:
        raise ValueError(f"images on {images.device} but s on {s.device}")


def shear_rows_cuda(images: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """out[n, y, x] = lerp(images[n, y, x + s(n, y)]), zero fill, on the card."""
    check_args(images, s)
    if images.device.type != "cuda":
        raise ValueError(f"shear_rows_cuda needs CUDA tensors, got {images.device}")
    n, h, w = images.shape
    rows = n * h
    if rows >= 2 ** 31 or w >= 2 ** 31:
        raise ValueError(f"too many rows for one launch: {rows} x {w}")
    out = torch.empty_like(images)
    if rows == 0 or w == 0:
        return out
    lib = _library()
    fn = lib.shear_rows_f32 if images.dtype == torch.float32 else lib.shear_rows_bf16
    stream = torch.cuda.current_stream(images.device).cuda_stream
    err = fn(ctypes.c_void_p(images.data_ptr()), ctypes.c_void_p(s.data_ptr()),
             ctypes.c_void_p(out.data_ptr()), ctypes.c_int(rows), ctypes.c_int(w),
             ctypes.c_int(images.device.index or 0), ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.shear_rows_error_string(err).decode()
        raise RuntimeError(f"shear_rows kernel launch failed: cudaError {err} ({msg})")
    shear_rows_cuda.launches += 1
    return out


shear_rows_cuda.launches = 0
