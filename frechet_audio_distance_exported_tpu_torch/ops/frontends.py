"""Batched VGGish audio frontend (torch).

Counterpart of frechet_audio_distance_exported_tpu/ops/frontends.py for the
VGGish family: mono 16 kHz -> 25 ms / 10 ms periodic-Hann STFT magnitude
(512-point) -> HTK mel (64 bins, 125-7500 Hz, DC zeroed) -> log(mel + 0.01)
-> non-overlapping [96, 64] patches, incomplete tail dropped.

The host only decodes and resamples; the frontend runs on the device with
per-file frame counts kept out of the shapes (callers mask whole patches).
A CUDA tensor goes to the hand-written log-mel kernel, a CPU tensor to its
plain torch version (ops/cuda_frontend.py decides, by the tensor's device).
"""

from __future__ import annotations

import torch

# VGGish frontend constants (JAX ops/frontends.py L38-46).
VGGISH_SAMPLE_RATE = 16000
VGGISH_WINDOW = 400  # 25 ms
VGGISH_HOP = 160  # 10 ms
VGGISH_FFT = 512  # 2**ceil(log2(400))
VGGISH_MEL_BINS = 64
VGGISH_MEL_MIN_HZ = 125.0
VGGISH_MEL_MAX_HZ = 7500.0
VGGISH_LOG_OFFSET = 0.01
VGGISH_PATCH_FRAMES = 96  # 0.96 s window and hop -> non-overlapping patches


def vggish_num_frames(num_samples: int) -> int:
    """Frames of the uncentered VGGish STFT."""
    if num_samples < VGGISH_WINDOW:
        return 0
    return 1 + (num_samples - VGGISH_WINDOW) // VGGISH_HOP


def vggish_num_patches(num_samples: int) -> int:
    """Complete non-overlapping 96-frame patches (tail dropped)."""
    return vggish_num_frames(num_samples) // VGGISH_PATCH_FRAMES


def dequant_i16(wave: torch.Tensor) -> torch.Tensor:
    """int16-shipped waveforms -> float32 on the device; float32 passes through.

    Division, not a reciprocal multiply: k / 32768 reproduces the host's
    float32 dequantisation bit for bit, and stays exact for a grid whose
    reciprocal is not a power of two (CLAP's k/32767, when it is ported)."""
    if wave.dtype == torch.int16:
        return wave.to(torch.float32) / 32768.0
    return wave


def vggish_logmel_batch(wave: torch.Tensor, num_frames: int) -> torch.Tensor:
    """[B, S] float32 (or PCM16-exact int16) at 16 kHz -> [B, num_frames, 64]
    HTK log-mel of the magnitude spectrum. Frames are the uncentered 400/160
    grid; rows beyond a file's true frame count are defined but must be
    masked by the caller."""
    from .cuda_frontend import fused_vggish_logmel

    return fused_vggish_logmel(dequant_i16(wave).contiguous(), num_frames)


def vggish_patches_batch(wave: torch.Tensor, num_patches: int) -> torch.Tensor:
    """[B, S] -> [B, P, 96, 64] non-overlapping log-mel patches."""
    log_mel = vggish_logmel_batch(wave, num_patches * VGGISH_PATCH_FRAMES)
    return log_mel.reshape(wave.shape[0], num_patches, VGGISH_PATCH_FRAMES, VGGISH_MEL_BINS)
