"""Build, bind and launch the CUDA shear kernels (``csrc/shear_rows.cu``,
``csrc/shear_cols.cu``).

``shear_rows`` (the shift along W, one shift per row) replaces the JAX
package's Pallas kernel ``ops/pallas_shear.py::_shear_rows_pallas_impl``;
``shear_cols`` (the shift along H, one shift per column) is the y pass that
the JAX package runs through the same Pallas kernel on a transposed array.
All sources are compiled by one ``nvcc`` call for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. The build
happens at first use, from the sources in this package, into
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``);
the file name carries a hash of every source and of the flags, so an edited
source is rebuilt. Builds therefore need a source checkout (or an editable
install): a non-editable install would place that directory beside
``site-packages``.

Both wrappers take the images as (N, H, W) or (N, C, H, W) whose (H, W)
planes are contiguous; the strides over N and C are free and may be 0 (an
``expand``ed batch: every copy reads the same planes and nothing is
copied). The shift is shared by the C planes of a copy. The output is a new
contiguous tensor of the input's shape.

``shear_rows_cuda`` and ``shear_cols_cuda`` take only CUDA tensors and raise
on anything they cannot run: there is no fallback. Their plain PyTorch
versions are ``ops/shear_warp.shear_rows`` and ``shear_cols``;
``ops/shear_warp.shear_rows_dispatch`` and ``shear_cols_dispatch`` pick by
the device of the tensor.

``shear_rows_cuda.launches`` and ``shear_cols_cuda.launches`` count the
kernel launches of the process, so a run can show that its path went through
the kernels.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "shear_rows.cu", CSRC / "shear_cols.cu")
HEADERS = (CSRC / "shear_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# The row kernel adds a shift of up to 255 to a column index held in an int.
MAX_WIDTH = 2 ** 31 - 512

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
                       "the CUDA shear kernels cannot be built")


def build(ptxas_verbose: bool = False) -> Tuple[Path, str]:
    """Compile the kernel library if it is not built yet.

    Returns (library path, compiler diagnostics). With ptxas_verbose the
    library is compiled anew and the diagnostics hold ptxas's register and
    spill report."""
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if ptxas_verbose else ())
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in SOURCES + HEADERS:
        digest.update(path.name.encode() + path.read_bytes())
    out = BUILD_DIR / f"libshear_{digest.hexdigest()[:16]}.so"
    if out.exists() and not ptxas_verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-o", str(tmp), *map(str, SOURCES)]
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
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        for name in ("shear_rows_f32", "shear_rows_bf16",
                     "shear_cols_f32", "shear_cols_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = launch_args
            fn.restype = ctypes.c_int
        lib.shear_error_string.argtypes = [ctypes.c_int]
        lib.shear_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_args(images: torch.Tensor, s: torch.Tensor, axis: str = "rows") -> None:
    """Raise unless (images, s) is a call the kernels take.

    images: (N, H, W) or (N, C, H, W), float32/bfloat16, the last two
    dimensions contiguous, any stride (0 included) over N and C. s: float32,
    contiguous, on the same device, (N, H) for axis="rows" (one shift per
    row) or (N, W) for axis="cols" (one shift per column)."""
    if axis not in ("rows", "cols"):
        raise ValueError(f"axis must be rows or cols, got {axis!r}")
    if images.dim() not in (3, 4):
        raise ValueError("images must be (N, H, W) or (N, C, H, W), got shape "
                         f"{tuple(images.shape)}")
    n, (h, w) = images.shape[0], images.shape[-2:]
    want = (n, h) if axis == "rows" else (n, w)
    if tuple(s.shape) != want:
        raise ValueError(f"s must be (N, {'H' if axis == 'rows' else 'W'}) = {want}, "
                         f"got {tuple(s.shape)}")
    if images.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"images must be float32 or bfloat16, got {images.dtype}")
    if s.dtype != torch.float32:
        raise TypeError(f"s must be float32, got {s.dtype}")
    if (w > 1 and images.stride(-1) != 1) or (h > 1 and images.stride(-2) != w):
        raise ValueError("the (H, W) planes of images must be contiguous (rows are "
                         "read as contiguous runs); call .contiguous() first")
    if not s.is_contiguous():
        raise ValueError("s must be contiguous; call .contiguous() first")
    if images.device != s.device:
        raise ValueError(f"images on {images.device} but s on {s.device}")


def _launch(wrapper, axis: str, images: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Check, allocate the output, launch on the current stream, and count the
    launch on ``wrapper.launches``."""
    check_args(images, s, axis)
    if images.device.type != "cuda":
        raise ValueError(f"shear_{axis}_cuda needs CUDA tensors, got {images.device}")
    view = images if images.dim() == 4 else images[:, None]
    n, c, h, w = view.shape
    if n * c * h >= 2 ** 31 or w >= MAX_WIDTH:
        raise ValueError(f"too large for one launch: {n * c * h} rows x {w}")
    out = torch.empty(images.shape, dtype=images.dtype, device=images.device)
    if out.numel() == 0:
        return out
    lib = _library()
    suffix = "f32" if images.dtype == torch.float32 else "bf16"
    fn = getattr(lib, f"shear_{axis}_{suffix}")
    stream = torch.cuda.current_stream(images.device).cuda_stream
    err = fn(images.data_ptr(), s.data_ptr(), out.data_ptr(), n, c, h, w,
             view.stride(0), view.stride(1), images.device.index or 0, stream)
    if err != 0:
        msg = lib.shear_error_string(err).decode()
        raise RuntimeError(f"shear_{axis} kernel launch failed: cudaError {err} ({msg})")
    wrapper.launches += 1
    return out


def shear_rows_cuda(images: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """out[n, (c,) y, x] = lerp(images[n, (c,) y, x + s[n, y]]), zero fill, on
    the card."""
    return _launch(shear_rows_cuda, "rows", images, s)


def shear_cols_cuda(images: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """out[n, (c,) y, x] = lerp(images[n, (c,) y + s[n, x], x]), zero fill, on
    the card."""
    return _launch(shear_cols_cuda, "cols", images, s)


shear_rows_cuda.launches = 0
shear_cols_cuda.launches = 0
