"""The VGGish log-mel frontend: the CUDA kernel's wrapper and its plain version.

fused_vggish_logmel launches csrc/vggish_logmel.cu, the Hopper port of the
TPU kernel frechet_audio_distance_exported_tpu/ops/pallas_frontend.py:83
(the source's header says what bounds it and how it is laid out). A CPU
tensor goes to fused_vggish_logmel_reference, the plain torch chunk-sum
version of the same function; a CUDA tensor goes to the kernel or raises.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, dsp, launches
from .frontends import (
    VGGISH_FFT,
    VGGISH_HOP,
    VGGISH_LOG_OFFSET,
    VGGISH_MEL_BINS,
    VGGISH_MEL_MAX_HZ,
    VGGISH_MEL_MIN_HZ,
    VGGISH_SAMPLE_RATE,
    VGGISH_WINDOW,
)

_MAX_GRID_Y = 65535  # the kernel puts the batch on gridDim.y


def _htk_mel_np() -> np.ndarray:
    return dsp.htk_mel_matrix(
        VGGISH_MEL_BINS, VGGISH_FFT // 2 + 1, VGGISH_SAMPLE_RATE,
        VGGISH_MEL_MIN_HZ, VGGISH_MEL_MAX_HZ,
    )


@functools.lru_cache(maxsize=8)
def _mel_tensor(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_htk_mel_np()).to(device)


@functools.lru_cache(maxsize=8)
def _kernel_operands(device: torch.device):
    """The kernel's tables (dsp.fft_logmel_tables: window [400], twiddle
    [512, 2], bands [64, 3] int32 and the 461 taps of the HTK mel) as
    contiguous tensors on ``device``, copied once: the kernel reads them
    through raw row-major pointers."""
    tables = dsp.fft_logmel_tables(VGGISH_WINDOW, VGGISH_FFT, _htk_mel_np())
    return tuple(torch.from_numpy(t).to(device) for t in tables)


def fused_vggish_logmel_reference(wave: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Plain torch version: float32 [B, S] at 16 kHz -> [B, num_frames, 64]
    log(HTK mel of |windowed DFT| + 0.01), chunk-sum order."""
    mag = dsp.stft_magnitude_strided(wave, num_frames, VGGISH_WINDOW, VGGISH_FFT, VGGISH_HOP)
    mel = torch.matmul(mag, _mel_tensor(wave.device))
    return torch.log(mel + VGGISH_LOG_OFFSET)


def fused_vggish_logmel(wave: torch.Tensor, num_frames: int) -> torch.Tensor:
    """float32 [B, S] at 16 kHz -> [B, num_frames, 64] HTK log-mel.

    Frame t spans wave[t*160 : t*160 + 400]; samples past S read as zero.
    No mask: VGGish callers mask whole patches by per-file patch counts.
    CPU tensor: the plain version. CUDA tensor: the hand-written kernel."""
    if wave.dtype != torch.float32:
        raise TypeError(f"fused_vggish_logmel takes float32, got {wave.dtype}")
    if wave.dim() != 2:
        raise ValueError(f"fused_vggish_logmel takes [B, S], got shape {tuple(wave.shape)}")
    if num_frames < 0:
        raise ValueError(f"num_frames must be >= 0, got {num_frames}")
    if wave.device.type == "cpu":
        return fused_vggish_logmel_reference(wave, num_frames)
    if wave.device.type != "cuda":
        raise ValueError(f"fused_vggish_logmel runs on CPU or CUDA tensors, got {wave.device}")
    if not wave.is_contiguous():
        raise ValueError("fused_vggish_logmel needs a contiguous wave")
    batch, num_samples = wave.shape
    if batch > _MAX_GRID_Y:
        raise ValueError(f"batch {batch} exceeds the kernel's grid limit {_MAX_GRID_Y}")

    lib = _build.load_library()
    tables = _kernel_operands(wave.device)
    out = torch.empty((batch, num_frames, VGGISH_MEL_BINS), dtype=torch.float32, device=wave.device)
    if batch == 0 or num_frames == 0:
        return out
    with torch.cuda.device(wave.device):
        stream = torch.cuda.current_stream(wave.device).cuda_stream
        err = lib.vggish_logmel_launch(
            *(ctypes.c_void_p(t.data_ptr()) for t in (wave, *tables, out)),
            batch,
            num_samples,
            num_frames,
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"vggish_logmel kernel launch failed with cudaError {err}")
    launches.count("fused_vggish_logmel")
    return out
