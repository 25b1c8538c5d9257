"""ctypes loader for the native host runtime (fad_native.cpp).

The port's copy of frechet_audio_distance_exported_tpu/native/__init__.py
(L10-177): the same ctypes signatures, wrappers, ABI check and
FAD_TPU_DISABLE_NATIVE=1 switch to the NumPy paths. fad_native.cpp is a
verbatim copy of the JAX package's source. Two things differ from the JAX
loader, which compiles next to its source:

- the library is built with the JAX flags (g++ -O3 -fopenmp -shared -fPIC)
  into the port's build directory, ops/_build.build_dir():
  $FAD_TPU_TORCH_BUILD_DIR (the counterpart of the JAX package's
  FAD_TPU_NATIVE_DIR), else the package's _build/;
- it is named by a hash of the source and the flags, written under a name
  of its own and installed with os.replace, so two processes that build it
  at once never load a half-written file.

This is host code, not a GPU kernel. Every entry point has a NumPy
fallback at its call site, so `available()` returning False only costs
speed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops import _build

SOURCE = Path(__file__).resolve().parent / "fad_native.cpp"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")
ABI_VERSION = 1
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return _build.build_dir() / f"libfad_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile fad_native.cpp unless the library for this source exists;
    returns its path. A missing g++ or a failed compile raises."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    try:
        subprocess.run(
            ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)  # atomic: a process building it at once never loads half a file
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _build_and_load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError):
        return None

    lib.resample_kaiser.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.resample_kaiser.restype = None
    lib.pcm16_to_f32.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
    ]
    lib.pcm16_to_f32.restype = None
    lib.pcm32_to_f32.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
    ]
    lib.pcm32_to_f32.restype = None
    lib.flac_rice_residuals.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.flac_rice_residuals.restype = ctypes.c_int64
    lib.flac_reconstruct_fixed.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
    ]
    lib.flac_reconstruct_fixed.restype = None
    lib.flac_reconstruct_lpc.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.flac_reconstruct_lpc.restype = None
    lib.fad_native_abi_version.restype = ctypes.c_int32
    if lib.fad_native_abi_version() != ABI_VERSION:
        return None
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if os.environ.get("FAD_TPU_DISABLE_NATIVE"):
        return None
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            _LIB = _build_and_load()
            _TRIED = True
    return _LIB


def available() -> bool:
    return _lib() is not None


def resample_kaiser(
    x: np.ndarray, sample_ratio: float, n_out: int,
    win: np.ndarray, delta: np.ndarray, num_table: int,
) -> Optional[np.ndarray]:
    """Native wing-accumulation loop; returns None if the library is absent."""
    lib = _lib()
    if lib is None:
        return None
    x64 = np.ascontiguousarray(x, dtype=np.float64)
    y = np.empty(n_out, dtype=np.float64)
    lib.resample_kaiser(
        x64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        x64.shape[0], n_out, float(sample_ratio),
        np.ascontiguousarray(win).ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        np.ascontiguousarray(delta).ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        win.shape[0], num_table,
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return y


def flac_rice_residuals(data: bytes, bit_pos: int, block_size: int, order: int):
    """Partitioned-Rice residual decode (FLAC). Returns (residuals, new_bit_pos)
    or None if the library is absent / the stream needs the Python fallback
    (which produces the detailed error)."""
    lib = _lib()
    if lib is None:
        return None
    out = np.empty(block_size - order, dtype=np.int64)
    buf = np.frombuffer(data, dtype=np.uint8)
    new_pos = lib.flac_rice_residuals(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.shape[0], bit_pos, block_size, order,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if new_pos < 0:
        return None
    return out, int(new_pos)


def flac_reconstruct(x: np.ndarray, order: int, coefs=None, shift: int = 0) -> bool:
    """In-place predictor reconstruction (FIXED when coefs is None, else LPC).
    Returns False when the library is absent."""
    lib = _lib()
    if lib is None:
        return False
    if x.dtype != np.int64 or not x.flags.c_contiguous:
        raise ValueError("flac_reconstruct needs a C-contiguous int64 array")
    ptr = x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    if coefs is None:
        lib.flac_reconstruct_fixed(ptr, x.shape[0], order)
    else:
        c = np.ascontiguousarray(coefs, dtype=np.int32)
        lib.flac_reconstruct_lpc(
            ptr, x.shape[0], order,
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), shift,
        )
    return True


def pcm_to_f32(samples: np.ndarray, channels: int, mixdown: bool) -> Optional[np.ndarray]:
    """Native int16/int32 PCM -> float32 (+ optional mean mixdown)."""
    lib = _lib()
    if lib is None:
        return None
    frames = samples.shape[0] // channels if samples.ndim == 1 else samples.shape[0]
    flat = np.ascontiguousarray(samples).reshape(-1)
    out_n = frames if (mixdown and channels > 1) else frames * channels
    out = np.empty(out_n, dtype=np.float32)
    if flat.dtype == np.int16:
        lib.pcm16_to_f32(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), frames, channels,
            int(mixdown), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
    elif flat.dtype == np.int32:
        lib.pcm32_to_f32(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), frames, channels,
            int(mixdown), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
    else:
        return None
    if not (mixdown and channels > 1) and channels > 1:
        return out.reshape(frames, channels)
    return out
