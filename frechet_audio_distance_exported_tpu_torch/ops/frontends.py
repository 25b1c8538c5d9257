"""Batched audio frontends (torch) for the VGGish, PANN and CLAP families,
and Encodec's host preprocessing.

Counterpart of frechet_audio_distance_exported_tpu/ops/frontends.py:
- VGGish: mono 16 kHz -> 25 ms / 10 ms periodic-Hann STFT magnitude
  (512-point) -> HTK mel (64 bins, 125-7500 Hz, DC zeroed) -> log(mel + 0.01)
  -> non-overlapping [96, 64] patches, incomplete tail dropped.
- PANN: mono at the model rate -> librosa-style centered, reflect-padded
  STFT power -> Slaney mel (64 bins) -> 10*log10(max(mel, 1e-10)), with the
  rows past each file's frame count set to 0 (the reference's zero pad onto
  the 32k-24 time grid).
- CLAP: the PANN log-mel at 48 kHz (n_fft 1024, hop 480), 1001 frames, on
  a wave zero-padded to 10 s and quantized to the k/32767 grid on the host.
- Encodec has no log-mel: the host mixes or duplicates channels and
  resamples each channel (preprocess_for_encodec), and the model reads the
  [C, S] waveform itself.

The host only decodes, resamples and applies PANN's small reflect pad; the
frontend runs on the device with per-file frame counts kept out of the
shapes (VGGish callers mask whole patches, PANN masks rows in the kernel).
A CUDA tensor goes to a hand-written log-mel kernel, a CPU tensor to its
plain torch version (ops/cuda_frontend.py and ops/cuda_pann_frontend.py
decide, by the tensor's device).

The reference-compatible single-file helpers at the end (waveform_to_examples,
waveform_to_logmel, preprocess_for_clap, clap_quantize, the padding helpers)
take NumPy audio, as the JAX package's do (ops/frontends.py:339-534); those
that compute a log-mel take a ``device`` ("cuda" by default, which raises
without CUDA) and run the log-mel kernels there.
"""

from __future__ import annotations

import numpy as np
import torch

from .resample import resample

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

# PANN frontend configs (JAX ops/frontends.py L50-55). The 48 kHz entry is
# the CLAP mel config, which the PANN log-mel kernel also serves.
PANN_CONFIGS = {
    8000: {"sample_rate": 8000, "window_size": 256, "hop_size": 80, "mel_bins": 64, "fmin": 50, "fmax": 4000},
    16000: {"sample_rate": 16000, "window_size": 512, "hop_size": 160, "mel_bins": 64, "fmin": 50, "fmax": 8000},
    32000: {"sample_rate": 32000, "window_size": 1024, "hop_size": 320, "mel_bins": 64, "fmin": 50, "fmax": 14000},
    48000: {"sample_rate": 48000, "window_size": 1024, "hop_size": 480, "mel_bins": 64, "fmin": 50, "fmax": 14000},
}

# CLAP constants (JAX ops/frontends.py L57-61).
CLAP_SAMPLE_RATE = 48000
CLAP_MAX_AUDIO_SECONDS = 10
CLAP_MAX_SAMPLES = CLAP_MAX_AUDIO_SECONDS * CLAP_SAMPLE_RATE  # 480000
CLAP_TIME_FRAMES = 1001

# Encodec constants (JAX ops/frontends.py L62-80).
ENCODEC_MAX_AUDIO_SECONDS = 10
ENCODEC_CONFIGS = {
    24000: {
        "sample_rate": 24000,
        "channels": 1,
        "embedding_dim": 128,
        "hop_length": 320,
        "max_samples": ENCODEC_MAX_AUDIO_SECONDS * 24000,
    },
    48000: {
        "sample_rate": 48000,
        "channels": 2,
        "embedding_dim": 128,
        "hop_length": 320,
        "max_samples": ENCODEC_MAX_AUDIO_SECONDS * 48000,
    },
}


def vggish_num_frames(num_samples: int) -> int:
    """Frames of the uncentered VGGish STFT."""
    if num_samples < VGGISH_WINDOW:
        return 0
    return 1 + (num_samples - VGGISH_WINDOW) // VGGISH_HOP


def vggish_num_patches(num_samples: int) -> int:
    """Complete non-overlapping 96-frame patches (tail dropped)."""
    return vggish_num_frames(num_samples) // VGGISH_PATCH_FRAMES


# Copied from frechet_audio_distance_exported_tpu/ops/frontends.py:101.
def pann_num_frames(num_samples: int, hop_size: int) -> int:
    """librosa center=True frame count: 1 + floor(S / hop)."""
    return 1 + num_samples // hop_size


# Copied from frechet_audio_distance_exported_tpu/ops/frontends.py:106.
def pann_valid_time(time: int) -> int:
    """Smallest t >= time with t = 32k - 24 (the exported-PANN time grid the
    reference zero-pads to). That padding is part of the numerics: zero
    log-mel rows flow through global pooling."""
    k = (time + 24 + 31) // 32
    valid = 32 * k - 24
    if valid < time:  # unreachable for time >= 1; mirrors the reference's own bump
        valid += 32
    return valid


# Copied from frechet_audio_distance_exported_tpu/ops/frontends.py:216.
def reflect_pad_host(audio: np.ndarray, n_fft: int) -> np.ndarray:
    """librosa center=True reflect pad (host-side, O(n_fft) work). It keeps
    the device frontend independent of each file's true length, so zero-
    padded buffers stay numerically exact."""
    return np.pad(audio, n_fft // 2, mode="reflect")


def dequant_i16(wave: torch.Tensor, full_scale: float = 32768.0) -> torch.Tensor:
    """int16-shipped waveforms -> float32 on the device; float32 passes through.

    Division, not a reciprocal multiply: k / full_scale reproduces the
    host's float32 dequantisation bit for bit, and stays exact for a grid
    whose reciprocal is not a power of two (CLAP's k/32767)."""
    if wave.dtype == torch.int16:
        return wave.to(torch.float32) / full_scale
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


def pann_logmel_batch(
    padded_wave: torch.Tensor,
    target_sample_rate: int,
    num_frames: int,
    n_valid_frames: torch.Tensor,
    i16_full_scale: float = 32768.0,
) -> torch.Tensor:
    """Reflect-padded [B, L] float32 (or int16 on the k/i16_full_scale grid)
    -> [B, num_frames, 64] Slaney log-mel in dB (JAX ops/frontends.py
    L267-335).

    Rows are reflect_pad_host(x, n_fft), zero-extended to a common length L.
    Frame t spans padded[t*hop : t*hop + n_fft], which reproduces
    librosa.stft(center=True, pad_mode='reflect'). Rows >= n_valid_frames[b]
    (an int32 tensor on the wave's device) are exactly 0.0."""
    from .cuda_pann_frontend import fused_pann_logmel

    return fused_pann_logmel(
        dequant_i16(padded_wave, i16_full_scale).contiguous(),
        n_valid_frames,
        target_sample_rate,
        num_frames,
    )


def clap_logmel_batch(padded_wave: torch.Tensor, n_valid_frames: torch.Tensor) -> torch.Tensor:
    """Quantized, reflect-padded [B, L] -> [B, 1001, 64] (JAX ops/frontends.py
    L352-364). The caller zero-pads the waveform to 10 s before the reflect
    pad (a mel of zeros is not zeros); int16 input dequantizes on CLAP's
    k/32767 grid."""
    return pann_logmel_batch(
        padded_wave, CLAP_SAMPLE_RATE, CLAP_TIME_FRAMES, n_valid_frames, 32767.0
    )


# Copied from frechet_audio_distance_exported_tpu/ops/frontends.py:455.
def preprocess_for_encodec(
    audio: np.ndarray,
    sample_rate: int,
    target_sample_rate: int = 24000,
    target_channels: int = 1,
    return_tensor: bool = True,
):
    """Encodec: channel conversion (mono mix, or a mono file duplicated to
    two channels), then a resample per channel, then [C, S] float32; with
    return_tensor a torch [1, C, S] tensor."""
    if target_sample_rate not in ENCODEC_CONFIGS:
        raise ValueError(
            f"Unsupported target sample rate: {target_sample_rate}. "
            f"Must be one of {list(ENCODEC_CONFIGS.keys())}"
        )
    audio = np.asarray(audio)
    if audio.ndim == 1:
        num_channels = 1
    elif audio.ndim == 2:
        num_channels = audio.shape[1]
    else:
        raise ValueError(f"Audio must be 1D or 2D, got shape {audio.shape}")

    if target_channels == 1:
        if num_channels > 1:
            audio = np.mean(audio, axis=1)
    elif target_channels == 2:
        if num_channels == 1:
            if audio.ndim == 1:
                audio = np.column_stack([audio, audio])
            else:
                audio = np.concatenate([audio, audio], axis=1)

    if audio.ndim == 2 and audio.shape[1] != target_channels:
        raise ValueError(
            f"Channel conversion failed. Expected {target_channels} channels, got {audio.shape[1]}"
        )

    if sample_rate != target_sample_rate:
        if audio.ndim == 1:
            audio = resample(audio, sample_rate, target_sample_rate)
        else:
            audio = np.column_stack(
                [resample(audio[:, c], sample_rate, target_sample_rate) for c in range(audio.shape[1])]
            )

    audio = audio.astype(np.float32)
    audio = audio.reshape(1, -1) if audio.ndim == 1 else audio.T  # [C, S]
    if return_tensor:
        return torch.from_numpy(np.ascontiguousarray(audio))[None, :, :]  # [1, C, S]
    return audio


# Copied from frechet_audio_distance_exported_tpu/ops/frontends.py:507.
def pad_to_fixed_length(x, target_sample_rate: int):
    """Zero-pad a [..., S] waveform (numpy or torch) to exactly 10 s; raise
    beyond."""
    config = ENCODEC_CONFIGS[target_sample_rate]
    max_samples = config["max_samples"]
    samples = x.shape[-1]
    if samples > max_samples:
        raise ValueError(
            f"Audio too long: {samples} samples > {max_samples} max samples "
            f"({ENCODEC_MAX_AUDIO_SECONDS} seconds at {target_sample_rate}Hz). "
            f"Please split audio into shorter segments."
        )
    if samples < max_samples:
        if isinstance(x, torch.Tensor):
            x = torch.nn.functional.pad(x, (0, max_samples - samples))
        else:
            x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, max_samples - samples)])
    return x


# ---------------------------------------------------------------------------
# Reference-compatible single-file helpers (NumPy in, NumPy or torch out)
# ---------------------------------------------------------------------------


def clap_quantize(audio) -> torch.Tensor:
    """The int16 round trip CLAP was trained with, on a float tensor (or
    array): NumPy's float -> int16 cast, which truncates toward zero and wraps
    values past full scale modulo 2^16 (copied from
    frechet_audio_distance_exported_tpu/ops/frontends.py:339-350)."""
    x = torch.as_tensor(audio, dtype=torch.float32)
    q = (x * 32767.0).to(torch.int32)
    q = ((q + 32768) % 65536) - 32768
    return q.to(torch.float32) / 32767.0


def waveform_to_examples(data: np.ndarray, sample_rate: int, return_tensor: bool = True,
                         device="cuda"):
    """VGGish: waveform -> [N, 96, 64] log-mel patches (JAX
    ops/frontends.py:372-393). The log-mel runs on ``device``.

    return_tensor=True returns a torch tensor [N, 1, 96, 64] on the device;
    else a NumPy [N, 96, 64] array."""
    from ..config import resolve_device

    dev = resolve_device(device)
    data = np.asarray(data)
    if data.ndim > 1:
        data = np.mean(data, axis=1)
    if sample_rate != VGGISH_SAMPLE_RATE:
        data = resample(data, sample_rate, VGGISH_SAMPLE_RATE)
    num_patches = vggish_num_patches(len(data))
    if num_patches == 0:
        out = torch.zeros((0, VGGISH_PATCH_FRAMES, VGGISH_MEL_BINS), device=dev)
    else:
        need = VGGISH_WINDOW + (num_patches * VGGISH_PATCH_FRAMES - 1) * VGGISH_HOP
        wave = torch.from_numpy(np.ascontiguousarray(data[:need], dtype=np.float32))
        out = vggish_patches_batch(wave[None, :].to(dev), num_patches)[0]
    if return_tensor:
        return out[:, None, :, :]
    return out.cpu().numpy()


def waveform_to_logmel(audio: np.ndarray, sample_rate: int, target_sample_rate: int = 16000,
                       return_tensor: bool = True, device="cuda"):
    """PANN: waveform -> Slaney log-mel (JAX ops/frontends.py:396-420). The
    log-mel runs on ``device``.

    return_tensor=True returns a torch tensor [1, 1, T, 64] on the device;
    else a NumPy [T, 64] array."""
    from ..config import resolve_device

    if target_sample_rate not in PANN_CONFIGS:
        raise ValueError(f"target_sample_rate must be one of {list(PANN_CONFIGS.keys())}")
    dev = resolve_device(device)
    cfg = PANN_CONFIGS[target_sample_rate]
    audio = np.asarray(audio)
    if audio.ndim > 1:
        audio = np.mean(audio, axis=1)
    if sample_rate != target_sample_rate:
        audio = resample(audio, sample_rate, target_sample_rate)
    audio = audio.astype(np.float32)
    num_frames = pann_num_frames(len(audio), cfg["hop_size"])
    padded = torch.from_numpy(reflect_pad_host(audio, cfg["window_size"]))[None, :].to(dev)
    n_valid = torch.full((1,), num_frames, dtype=torch.int32, device=dev)
    log_mel = pann_logmel_batch(padded, target_sample_rate, num_frames, n_valid)
    if return_tensor:
        return log_mel[:, None, :, :]
    return log_mel[0].cpu().numpy()


def preprocess_for_clap(audio: np.ndarray, sample_rate: int, return_tensor: bool = True,
                        apply_quantization: bool = True, device="cuda"):
    """CLAP: mono mix -> int16 quantisation -> 48 kHz log-mel (JAX
    ops/frontends.py:423-439)."""
    audio = np.asarray(audio)
    if audio.ndim > 1:
        audio = np.mean(audio, axis=1)
    if apply_quantization:
        audio = audio.astype(np.float32)
        audio = (audio * 32767.0).astype(np.int16).astype(np.float32) / 32767.0
    return waveform_to_logmel(audio, sample_rate, target_sample_rate=CLAP_SAMPLE_RATE,
                              return_tensor=return_tensor, device=device)


# Copied from frechet_audio_distance_exported_tpu/ops/frontends.py:442.
def pad_audio_to_max_length(audio: np.ndarray, sample_rate: int) -> np.ndarray:
    """Zero-pad a waveform to 10 s; raise beyond."""
    max_samples = CLAP_MAX_AUDIO_SECONDS * sample_rate
    if len(audio) > max_samples:
        raise ValueError(
            f"Audio too long: {len(audio) / sample_rate:.2f}s > {CLAP_MAX_AUDIO_SECONDS}s max"
        )
    if len(audio) < max_samples:
        audio = np.pad(audio, (0, max_samples - len(audio)), mode="constant")
    return audio


def pad_to_valid_encodec_length(x):
    """Zero-pad a [..., S] waveform (NumPy or torch) to a multiple of the hop
    320 (JAX ops/frontends.py:525-534; deprecated in the reference too)."""
    hop_length = 320
    remainder = x.shape[-1] % hop_length
    if remainder != 0:
        if isinstance(x, torch.Tensor):
            x = torch.nn.functional.pad(x, (0, hop_length - remainder))
        else:
            x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, hop_length - remainder)])
    return x
