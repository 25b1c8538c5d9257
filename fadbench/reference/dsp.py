"""Plain log-mel front ends of the benchmark's reference, in float32 torch.

Frozen from frechet_audio_distance_exported_tpu_torch/ops/dsp.py (the
periodic Hann window, the windowed DFT matrices, the HTK and Slaney mel
matrices, all built in float64 NumPy) and from the plain versions in
ops/cuda_frontend.py and ops/cuda_pann_frontend.py. Framing here is one
unfold and one product with the windowed DFT matrix, where the port's plain
versions sum hop-sized chunks: the same function in another summation order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def periodic_hann(window_length: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi / window_length * np.arange(window_length))


def windowed_dft(window_length: int, fft_length: int) -> np.ndarray:
    """[W, 2F] float32: cos | -sin of the DFT with the periodic Hann window
    folded in, F = fft_length // 2 + 1 (frames zero-padded to fft_length)."""
    w = periodic_hann(window_length)
    n = np.arange(window_length)[:, None]
    k = np.arange(fft_length // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / fft_length
    return np.concatenate([w[:, None] * np.cos(ang), -w[:, None] * np.sin(ang)], axis=1).astype(
        np.float32
    )


def _hertz_to_mel_htk(hz):
    return 1127.0 * np.log(1.0 + hz / 700.0)


def htk_mel(num_bins: int, fft_length: int, sample_rate: int, lo_hz: float, hi_hz: float):
    """[F, M] unnormalised HTK triangles with the DC bin zeroed (VGGish's
    mel_features.spectrogram_to_mel_matrix)."""
    bins_mel = _hertz_to_mel_htk(np.linspace(0.0, sample_rate / 2.0, fft_length // 2 + 1))
    edges = np.linspace(_hertz_to_mel_htk(lo_hz), _hertz_to_mel_htk(hi_hz), num_bins + 2)
    lower = (bins_mel[:, None] - edges[None, :-2]) / (edges[None, 1:-1] - edges[None, :-2])
    upper = (edges[None, 2:] - bins_mel[:, None]) / (edges[None, 2:] - edges[None, 1:-1])
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights[0, :] = 0.0
    return weights.astype(np.float32)


def _hz_to_mel_slaney(hz):
    hz = np.asanyarray(hz, dtype=np.float64)
    mels = hz / (200.0 / 3)
    logstep = np.log(6.4) / 27.0
    return np.where(hz >= 1000.0, 15.0 + np.log(np.maximum(hz, 1000.0) / 1000.0) / logstep, mels)


def _mel_to_hz_slaney(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= 15.0, 1000.0 * np.exp(logstep * (mels - 15.0)), mels * (200.0 / 3))


def slaney_mel(sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float):
    """[F, M] Slaney-scale, Slaney-normalised mel matrix (librosa.filters.mel
    with htk=False, norm='slaney', transposed)."""
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz_slaney(
        np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    )
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


def _spectrum(frames: torch.Tensor, window_length: int, fft_length: int):
    """frames [..., W] -> (re, im), each [..., F]."""
    dft = torch.from_numpy(windowed_dft(window_length, fft_length)).to(frames.device)
    both = torch.matmul(frames, dft)
    nbin = fft_length // 2 + 1
    return both[..., :nbin], both[..., nbin:]


def vggish_logmel(wave: torch.Tensor, num_frames: int, cfg: dict) -> torch.Tensor:
    """float32 [B, S] -> [B, num_frames, M]: log(HTK mel of |DFT| + offset)
    over the uncentred frames wave[t*hop : t*hop + window]."""
    win, hop, n_fft = cfg["stft_window_samples"], cfg["stft_hop_samples"], cfg["fft_length"]
    frames = wave.unfold(-1, win, hop)[:, :num_frames]
    re, im = _spectrum(frames, win, n_fft)
    mel = htk_mel(cfg["mel_bands"], n_fft, cfg["sample_rate"], cfg["mel_min_hz"], cfg["mel_max_hz"])
    mel = torch.matmul(torch.sqrt(re * re + im * im), torch.from_numpy(mel).to(wave.device))
    return torch.log(mel + cfg["log_offset"])


def pann_logmel(wave: torch.Tensor, num_frames: int, cfg: dict) -> torch.Tensor:
    """float32 [B, S] -> [B, num_frames, M]: librosa's centred STFT
    (reflect pad n_fft/2) power, Slaney mel, 10 log10(max(mel, 1e-10))."""
    n_fft, hop = cfg["fft_length"], cfg["stft_hop_samples"]
    padded = F.pad(wave[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = padded.unfold(-1, n_fft, hop)[:, :num_frames]
    re, im = _spectrum(frames, n_fft, n_fft)
    mel = slaney_mel(cfg["sample_rate"], n_fft, cfg["mel_bands"], cfg["mel_min_hz"], cfg["mel_max_hz"])
    mel = torch.matmul(re * re + im * im, torch.from_numpy(mel).to(wave.device))
    return 10.0 * torch.log10(torch.clamp_min(mel, 1e-10))
