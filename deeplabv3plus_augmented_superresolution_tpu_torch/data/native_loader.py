"""ctypes bindings for the native host-staging runtime (``csrc/asr_host.cc``).

Port of the JAX package's ``data/native_loader.py`` (numpy and ctypes only;
the C++ source is this package's own copy). The library is compiled at first
use with g++, libjpeg and libpng into ``build/torch_host/`` at the repository
root (listed in ``.gitignore``), its file name carrying a hash of the source
and the flags. Where the toolchain or the libraries are missing,
``available()`` returns False and callers decode through ``data/io.py``.

  load_image_native(path, image_size, normalize, is_label) -> float32 HWC
  ImageRing(paths, image_size, ...)  threaded in-order decode-ahead ring,
      yielding (index, frame tensor): float32, or bfloat16 rounded in C++
      (delivered as uint16 bit patterns viewed as torch.bfloat16, so no
      ml_dtypes is needed)
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "asr_host.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_host"
GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")
LIBS = ("-ljpeg", "-lpng")


class _Library:
    """The compiled library, built and loaded once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.error: Optional[str] = None

    def _build(self) -> Path:
        digest = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode()
                                + SOURCE.read_bytes()).hexdigest()[:16]
        out = BUILD_DIR / f"libasr_host_{digest}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{out.name}.{os.getpid()}.tmp"
        cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise OSError(f"{' '.join(cmd)} failed:\n{proc.stderr[-2000:]}")
        os.replace(tmp, out)
        return out

    def get(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if self._lib is not None or self.error is not None:
                return self._lib
            try:
                lib = ctypes.CDLL(str(self._build()))
            except OSError as exc:  # no g++, libjpeg or libpng: decode in Python
                self.error = str(exc)
                return None
            lib.asr_load_image.restype = ctypes.c_int
            lib.asr_load_image.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            lib.asr_ring_create2.restype = ctypes.c_void_p
            lib.asr_ring_create2.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
            lib.asr_ring_next.restype = ctypes.c_int
            lib.asr_ring_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_int)]
            lib.asr_ring_destroy.restype = None
            lib.asr_ring_destroy.argtypes = [ctypes.c_void_p]
            self._lib = lib
            return lib


_LIBRARY = _Library()


def available() -> bool:
    return _LIBRARY.get() is not None


def build_error() -> Optional[str]:
    _LIBRARY.get()
    return _LIBRARY.error


def _lib() -> ctypes.CDLL:
    lib = _LIBRARY.get()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_LIBRARY.error}")
    return lib


def load_image_native(path: str, image_size: Tuple[int, int],
                      normalize: bool = True, is_label: bool = False) -> np.ndarray:
    """Decode + resize one image natively; the contract of data.io.load_image
    (float32 HWC, bilinear for photos, nearest for label PNGs)."""
    h, w = image_size
    out = np.empty((h, w, 1 if is_label else 3), np.float32)
    rc = _lib().asr_load_image(os.fsencode(path), h, w, int(is_label), int(normalize),
                               out.ctypes.data)
    if rc != 1:
        raise IOError(f"native decode failed for {path}")
    return out


class ImageRing:
    """In-order decode-ahead over a path list: a worker pool decodes and
    resizes into a bounded slot ring in C++; iteration yields (index, frame)
    in the original order while later files decode in the background.
    dtype="bfloat16" delivers frames rounded to bf16 in C++
    (round-to-nearest-even, as torch's conversion): half the host->device
    bytes, the serving path's input format."""

    def __init__(self, paths: Sequence[str], image_size: Tuple[int, int],
                 normalize: bool = True, is_label: bool = False,
                 n_threads: int = 4, capacity: int = 8, dtype: str = "float32"):
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported ring dtype {dtype!r}")
        self._lib = _lib()
        self._n = len(paths)
        self._shape = (image_size[0], image_size[1], 1 if is_label else 3)
        self._bf16 = dtype == "bfloat16"
        self._paths = (ctypes.c_char_p * self._n)(*[os.fsencode(p) for p in paths])
        self._handle = self._lib.asr_ring_create2(
            self._paths, self._n, image_size[0], image_size[1], int(is_label),
            int(normalize), int(n_threads), int(capacity), int(self._bf16))

    def __iter__(self) -> Iterator[Tuple[int, torch.Tensor]]:
        idx = ctypes.c_int(0)
        for _ in range(self._n):
            out = np.empty(self._shape, np.uint16 if self._bf16 else np.float32)
            rc = self._lib.asr_ring_next(self._handle, out.ctypes.data,
                                         ctypes.byref(idx))
            if rc == 0:
                return
            if rc < 0:
                raise IOError(f"native decode failed at index {idx.value}")
            frame = torch.from_numpy(out)
            yield idx.value, frame.view(torch.bfloat16) if self._bf16 else frame

    def close(self) -> None:
        if self._handle is not None:
            self._lib.asr_ring_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "ImageRing":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
