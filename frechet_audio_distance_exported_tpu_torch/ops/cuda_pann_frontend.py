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
def _kernel_operands(target_sample_rate: int, device: torch.device, nbin_pad: int):
    """(dft [n_fft, nbin_pad, 2] (cos, sin) pairs, mel [n_fft/2 + 1, 64]) on ``device``.

    The windowed DFT matrix is the chunked matrix of the plain version
    without its zero rows (K = n_fft), with cos and sin of a bin side by
    side and zero bins past n_fft/2."""
    n_fft, _, _ = _geometry(target_sample_rate)
    cos_m, sin_m = dsp.windowed_dft_matrices(n_fft, n_fft)
    nbin = cos_m.shape[1]
    pairs = np.zeros((n_fft, nbin_pad, 2), np.float32)
    pairs[:, :nbin, 0] = cos_m
    pairs[:, :nbin, 1] = sin_m
    return torch.from_numpy(pairs).to(device), _mel_tensor(target_sample_rate, device)


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
    nbin_pad = lib.pann_logmel_nbin_pad(n_fft)
    if nbin_pad <= 0:
        raise ValueError(f"the PANN log-mel kernel has no instantiation for n_fft {n_fft}")
    dft, mel = _kernel_operands(target_sample_rate, wave.device, nbin_pad)
    out = torch.empty((batch, num_frames, mels), dtype=torch.float32, device=wave.device)
    if batch == 0 or num_frames == 0:
        return out
    with torch.cuda.device(wave.device):
        stream = torch.cuda.current_stream(wave.device).cuda_stream
        err = lib.pann_logmel_launch(
            ctypes.c_void_p(wave.data_ptr()),
            ctypes.c_void_p(n_valid_frames.data_ptr()),
            ctypes.c_void_p(dft.data_ptr()),
            ctypes.c_void_p(mel.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
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
