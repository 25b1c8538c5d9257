"""Build the package's CUDA sources on first use and load them with ctypes.

Every csrc/*.cu file is compiled by nvcc, for sm_90a, into one shared
library with a plain C interface; no PyTorch header is included, so a build
takes seconds rather than the minutes a torch extension build takes. The
sources compile in parallel (one nvcc process each, all started together)
and are then linked. The library lands in the directory that
FAD_TPU_TORCH_BUILD_DIR names (for an install the user cannot write to; the
counterpart of the JAX package's FAD_TPU_NATIVE_DIR), else in the package's
_build/ (listed in .gitignore), where the native host library (native/)
is built too. It is named by a hash of the sources, the headers they include (csrc/*.cuh) and
the flags, so an edited source or header is rebuilt and an unchanged tree
is loaded as it is. A missing nvcc, a failed build or
a failed load raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
BUILD_DIR_ENV = "FAD_TPU_TORCH_BUILD_DIR"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills of each kernel, into the build log
)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if candidate.is_file():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (not on PATH, nor under $CUDA_HOME/bin or /usr/local/cuda/bin): "
            "the CUDA kernels of frechet_audio_distance_exported_tpu_torch cannot be built"
        )
    return nvcc


def build_dir() -> Path:
    """$FAD_TPU_TORCH_BUILD_DIR if it is set and not empty, else BUILD_DIR."""
    env = os.environ.get(BUILD_DIR_ENV)
    return Path(env) if env else BUILD_DIR


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return build_dir() / f"libfad_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objects = [out.parent / f"{tag}.{src.stem}.o" for src in sources]
    tmp = out.with_name(f"{tag}.tmp.so")
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objects)
    ]
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in compiles
    ]
    log, failed = [], []
    for cmd, proc in zip(compiles, procs):
        output = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + output)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {cmd[-1]}:\n{output}")
    if not failed:
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}")
    out.with_suffix(".log").write_text("\n".join(log))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {out.name}:\n" + "\n".join(failed))
    os.replace(tmp, out)  # atomic: a concurrent builder never loads a half-written file
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    lib.vggish_logmel_launch.argtypes = [
        ctypes.c_void_p,  # wave
        ctypes.c_void_p,  # window
        ctypes.c_void_p,  # twiddle (cos, -sin) pairs
        ctypes.c_void_p,  # mel bands (start, count, offset), int32
        ctypes.c_void_p,  # mel taps
        ctypes.c_void_p,  # out
        ctypes.c_int,  # batch
        ctypes.c_longlong,  # num_samples
        ctypes.c_int,  # num_frames
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.vggish_logmel_launch.restype = ctypes.c_int
    lib.pann_logmel_launch.argtypes = [
        ctypes.c_void_p,  # wave
        ctypes.c_void_p,  # n_valid (int32)
        ctypes.c_void_p,  # window
        ctypes.c_void_p,  # twiddle (cos, -sin) pairs
        ctypes.c_void_p,  # mel bands (start, count, offset), int32
        ctypes.c_void_p,  # mel taps
        ctypes.c_void_p,  # out
        ctypes.c_int,  # batch
        ctypes.c_longlong,  # num_samples
        ctypes.c_int,  # num_frames
        ctypes.c_int,  # n_fft
        ctypes.c_int,  # hop
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.pann_logmel_launch.restype = ctypes.c_int
    lib.tf32_split_launch.argtypes = [
        ctypes.c_void_p,  # w [in, out]
        ctypes.c_int,  # in
        ctypes.c_int,  # out
        ctypes.c_void_p,  # [2, out, in]: hi, lo of w^T
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tf32_split_launch.restype = ctypes.c_int
    attention_args = [
        ctypes.c_void_p,  # x
        ctypes.c_void_p,  # w_qkv (float32: its tf32_split form)
        ctypes.c_void_p,  # b_qkv
        ctypes.c_void_p,  # w_proj (float32: its tf32_split form)
        ctypes.c_void_p,  # b_proj
        ctypes.c_void_p,  # bias
        ctypes.c_void_p,  # mask
        ctypes.c_int,  # mask_count
        ctypes.c_void_p,  # gamma1
        ctypes.c_void_p,  # beta1
    ]
    tail = [
        ctypes.c_int,  # windows (BW)
        ctypes.c_int,  # C
        ctypes.c_int,  # heads
        ctypes.c_void_p,  # cudaStream_t
    ]
    mlp_args = [
        ctypes.c_void_p,  # gamma2
        ctypes.c_void_p,  # beta2
        ctypes.c_void_p,  # w_fc1 (float32: its tf32_split form)
        ctypes.c_void_p,  # b_fc1
        ctypes.c_void_p,  # w_fc2 (float32: its tf32_split form)
        ctypes.c_void_p,  # b_fc2
    ]
    signatures = {
        # float32 (csrc/window_attn.cu)
        "window_attention_launch": [
            *attention_args,
            ctypes.c_void_p,  # stats scratch [M, 2]
            ctypes.c_void_p,  # a scratch (attn)
            ctypes.c_void_p,  # qkv scratch
            ctypes.c_void_p,  # out
            *tail,
        ],
        "swin_block_launch": [
            *attention_args, *mlp_args,
            ctypes.c_void_p,  # stats scratch [M, 2]
            ctypes.c_void_p,  # work scratch [M, 4C]
            ctypes.c_void_p,  # x2 scratch [M, C]
            ctypes.c_void_p,  # out
            *tail,
        ],
        # bf16 (csrc/window_attn_bf16.cu)
        "window_attention_bf16_launch": [
            *attention_args,
            ctypes.c_void_p,  # a scratch (LN1(x), then attn)
            ctypes.c_void_p,  # qkv scratch
            ctypes.c_void_p,  # out
            *tail,
        ],
        "swin_block_bf16_launch": [
            *attention_args, *mlp_args,
            ctypes.c_void_p,  # attn scratch
            ctypes.c_void_p,  # out
            *tail,
        ],
    }
    for name, argtypes in signatures.items():
        entry = getattr(lib, name)
        entry.argtypes = argtypes
        entry.restype = ctypes.c_int
    # csrc/group_norm.cu
    geometry = [
        ctypes.c_int,  # batch
        ctypes.c_longlong,  # n = C * T
        ctypes.c_int,  # T
        ctypes.c_uint,  # mul and
        ctypes.c_int,  # shift of the division by T
        ctypes.c_longlong,  # chunk
        ctypes.c_int,  # splits
        ctypes.c_int,  # width: channels a slice spans at most
    ]
    tail = [
        ctypes.c_int,  # bf16
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.group_norm_moments_launch.argtypes = [
        ctypes.c_void_p,  # y [B, C, T]
        ctypes.c_void_p,  # conv_bias [C] or null
        ctypes.c_void_p,  # partial [B, splits, 2] float64 scratch
        *geometry,
        *tail,
    ]
    lib.group_norm_moments_launch.restype = ctypes.c_int
    norm = [
        ctypes.c_void_p,  # y [B, C, T]
        ctypes.c_void_p,  # conv_bias [C] or null
        ctypes.c_void_p,  # gamma [C]
        ctypes.c_void_p,  # beta [C]
        ctypes.c_void_p,  # partial, as the moments filled it
        ctypes.c_double,  # eps
    ]
    lib.group_norm_apply_launch.argtypes = [
        ctypes.c_int,  # form
        *norm,
        *norm,  # the residual's second norm
        ctypes.c_void_p,  # raw out [B, C, T] or null
        ctypes.c_void_p,  # act out [B, C, left + T + right] or null
        ctypes.c_int,  # left
        ctypes.c_int,  # right
        *geometry,  # the apply's own grid
        ctypes.c_int,  # parts: the moments' splits, partials a row
        *tail,
    ]
    lib.group_norm_apply_launch.restype = ctypes.c_int
    lib.group_norm_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]  # bf16, kernel
    lib.group_norm_blocks_per_sm.restype = ctypes.c_int
    return lib
