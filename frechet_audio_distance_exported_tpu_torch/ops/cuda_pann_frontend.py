"""The PANN (and CLAP) log-mel frontend: the CUDA kernel's wrapper and its plain version.

fused_pann_logmel launches csrc/pann_logmel.cu, the Hopper port of the TPU
kernel frechet_audio_distance_exported_tpu/ops/pallas_frontend.py:185 (the
source's header says what bounds it and how it is laid out). A CPU tensor
goes to fused_pann_logmel_reference, the plain torch chunk-sum version of
the same function; a CUDA tensor goes to the kernel or raises. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, dsp, launches
from .frontends import PANN_CONFIGS

_MAX_GRID_Y = 65535  # the kernel puts the batch on gridDim.y


def _geometry(target_sample_rate: int):
    """(n_fft, hop, mel_bins) of a PANN_CONFIGS entry; ValueError for another rate."""
    cfg = PANN_CONFIGS.get(target_sample_rate)
    if cfg is None:
        raise ValueError(
            f"no PANN log-mel config for {target_sample_rate} Hz; have {sorted(PANN_CONFIGS)}"
        )
    return cfg["window_size"], cfg["hop_size"], cfg["mel_bins"]


def _slaney_mel_np(target_sample_rate: int) -> np.ndarray:
    cfg = PANN_CONFIGS[target_sample_rate]
    return dsp.slaney_mel_matrix(
        target_sample_rate, cfg["window_size"], cfg["mel_bins"], cfg["fmin"], cfg["fmax"]
    )


@functools.lru_cache(maxsize=16)
def _mel_tensor(target_sample_rate: int, device: torch.device) -> torch.Tensor:
    """Row-major [n_fft/2 + 1, 64]: the kernel reads it through a raw pointer,
    and slaney_mel_matrix is a transposed (column-major) array."""
    mel = np.ascontiguousarray(_slaney_mel_np(target_sample_rate))
    return torch.from_numpy(mel).to(device)


@functools.lru_cache(maxsize=16)
def _kernel_operands(target_sample_rate: int, device: torch.device):
    """The kernel's tables (dsp.fft_logmel_tables: window [n_fft], twiddle
    [n_fft, 2], bands [64, 3] int32 and taps of the Slaney mel) as
    contiguous tensors on ``device``, copied once: the kernel reads them
    through raw row-major pointers."""
    n_fft, _, _ = _geometry(target_sample_rate)
    tables = dsp.fft_logmel_tables(n_fft, n_fft, _slaney_mel_np(target_sample_rate))
    return tuple(torch.from_numpy(t).to(device) for t in tables)


def fused_pann_logmel_reference(
    wave: torch.Tensor, n_valid_frames: torch.Tensor, target_sample_rate: int, num_frames: int
) -> torch.Tensor:
    """Plain torch version: reflect-padded float32 [B, L] -> [B, num_frames, 64]
    10*log10(max(Slaney mel of |windowed DFT|^2, 1e-10)), chunk-sum order,
    rows >= n_valid_frames[b] set to 0."""
    n_fft, hop, _ = _geometry(target_sample_rate)
    power = dsp.stft_power_strided(wave, num_frames, n_fft, n_fft, hop)
    mel = torch.matmul(power, _mel_tensor(target_sample_rate, wave.device))
    log_mel = 10.0 * torch.log10(torch.clamp_min(mel, 1e-10))
    frame_ids = torch.arange(num_frames, device=wave.device)[None, :, None]
    keep = frame_ids < n_valid_frames.to(wave.device)[:, None, None]
    return torch.where(keep, log_mel, torch.zeros((), dtype=log_mel.dtype, device=wave.device))


def fused_pann_logmel(
    wave: torch.Tensor, n_valid_frames: torch.Tensor, target_sample_rate: int, num_frames: int
) -> torch.Tensor:
    """Reflect-padded float32 [B, L] -> [B, num_frames, 64] Slaney log-mel (dB).

    Frame t spans wave[t*hop : t*hop + n_fft]; samples past L read as zero.
    Rows >= n_valid_frames[b] (int32 [B], on the wave's device) are exactly 0.
    CPU tensor: the plain version. CUDA tensor: the hand-written kernel."""
    n_fft, hop, mels = _geometry(target_sample_rate)
    if wave.dtype != torch.float32:
        raise TypeError(f"fused_pann_logmel takes float32, got {wave.dtype}")
    if wave.dim() != 2:
        raise ValueError(f"fused_pann_logmel takes [B, L], got shape {tuple(wave.shape)}")
    if num_frames < 0:
        raise ValueError(f"num_frames must be >= 0, got {num_frames}")
    if n_valid_frames.dtype != torch.int32 or tuple(n_valid_frames.shape) != (wave.shape[0],):
        raise ValueError(
            f"n_valid_frames must be int32 [{wave.shape[0]}], got "
            f"{n_valid_frames.dtype} {tuple(n_valid_frames.shape)}"
        )
    if wave.device.type == "cpu":
        return fused_pann_logmel_reference(wave, n_valid_frames, target_sample_rate, num_frames)
    if wave.device.type != "cuda":
        raise ValueError(f"fused_pann_logmel runs on CPU or CUDA tensors, got {wave.device}")
    if n_valid_frames.device != wave.device:
        raise ValueError(
            f"n_valid_frames must be on {wave.device} like the wave, got {n_valid_frames.device}"
        )
    if not (wave.is_contiguous() and n_valid_frames.is_contiguous()):
        raise ValueError("fused_pann_logmel needs a contiguous wave and n_valid_frames")
    batch, num_samples = wave.shape
    if batch > _MAX_GRID_Y:
        raise ValueError(f"batch {batch} exceeds the kernel's grid limit {_MAX_GRID_Y}")

    lib = _build.load_library()
    tables = _kernel_operands(target_sample_rate, wave.device)
    out = torch.empty((batch, num_frames, mels), dtype=torch.float32, device=wave.device)
    if batch == 0 or num_frames == 0:
        return out
    with torch.cuda.device(wave.device):
        stream = torch.cuda.current_stream(wave.device).cuda_stream
        err = lib.pann_logmel_launch(
            *(ctypes.c_void_p(t.data_ptr()) for t in (wave, n_valid_frames, *tables, out)),
            batch,
            num_samples,
            num_frames,
            n_fft,
            hop,
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"pann_logmel kernel launch failed with cudaError {err}")
    launches.count("fused_pann_logmel")
    return out
