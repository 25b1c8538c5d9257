"""DSP building blocks: numpy constant builders and the torch chunk-sum STFT.

The numpy builders are copies of frechet_audio_distance_exported_tpu/ops/dsp.py
(L33-160, L178-207), kept here so the port never imports the JAX package.
They are float64 NumPy, cached per configuration. fft_logmel_tables,
the port's own, builds the tables of the FFT log-mel kernels from them.

stft_spectrum_strided / stft_power_strided / stft_magnitude_strided are the
torch counterparts of the JAX chunk-sum STFT (ops/dsp.py L210-276, the
single_matmul=False branch): framing becomes shifted views of a
non-overlapping reshape of the wave into hop-sized rows, and the windowed
DFT is the sum of ceil(W/hop) [T, hop] x [hop, 2F] products, in chunk
order. They are the plain versions of the log-mel kernels
(ops/cuda_frontend.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def periodic_hann(window_length: int) -> np.ndarray:
    """Periodic Hann window: 0.5 - 0.5*cos(2*pi*n/N)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi / window_length * np.arange(window_length))


@functools.lru_cache(maxsize=16)
def windowed_dft_matrices(window_length: int, fft_length: int):
    """[W, F] cos / sin matrices with the periodic-Hann window folded in.

    For frames x[.., W]:  re = x @ C, im = x @ S  equals
    np.fft.rfft(x * hann, fft_length). F = fft_length//2 + 1.
    """
    w = periodic_hann(window_length)
    n = np.arange(window_length)[:, None]
    k = np.arange(fft_length // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / fft_length
    cos_m = (w[:, None] * np.cos(ang)).astype(np.float32)
    sin_m = (-w[:, None] * np.sin(ang)).astype(np.float32)
    return cos_m, sin_m


def fft_logmel_tables(window_length: int, n_fft: int, mel: np.ndarray):
    """The tables of the FFT log-mel kernels (csrc/rfft.cuh and its two
    users), as contiguous numpy arrays: (window [window_length] f32, twiddle
    [n_fft, 2] f32, bands [mel_bins, 3] int32, taps [nnz] f32).

    - window: the periodic Hann window of window_length samples in float32,
      the values of the plain version's windowed DFT matrix (its bin-0
      column); the kernels zero-pad a shorter window to n_fft.
    - twiddle: exp(-2 pi i m / n_fft) for m < n_fft as (cos, -sin) pairs,
      computed in float64 and rounded once to float32. The FFT of n_fft/2
      points reads every other entry; the split step reads the first
      n_fft/2 + 1.
    - bands, taps: mel [n_fft/2 + 1, mel_bins] as a sparse matrix. Band j's
      nonzero taps are the contiguous bins start .. start + count - 1 (a
      triangle); row j of bands is (start, count, offset), and
      taps[offset : offset + count] are its weights, the float32 values of
      mel. A band without taps has count 0."""
    window = periodic_hann(window_length).astype(np.float32)
    angle = 2.0 * np.pi * np.arange(n_fft) / n_fft
    twiddle = np.stack([np.cos(angle), -np.sin(angle)], axis=1).astype(np.float32)
    bands, taps = [], []
    for j in range(mel.shape[1]):
        nonzero = np.flatnonzero(mel[:, j])
        start = int(nonzero[0]) if nonzero.size else 0
        count = int(nonzero[-1]) + 1 - start if nonzero.size else 0
        bands.append((start, count, sum(len(t) for t in taps)))
        taps.append(mel[start : start + count, j])
    tables = (window, twiddle, np.asarray(bands, np.int32), np.concatenate(taps))
    return tuple(np.ascontiguousarray(t) for t in tables)


_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def _hertz_to_mel_htk(frequencies_hertz):
    return _MEL_HIGH_FREQUENCY_Q * np.log(1.0 + (frequencies_hertz / _MEL_BREAK_FREQUENCY_HERTZ))


@functools.lru_cache(maxsize=16)
def htk_mel_matrix(
    num_mel_bins: int,
    num_spectrogram_bins: int,
    audio_sample_rate: int,
    lower_edge_hertz: float,
    upper_edge_hertz: float,
) -> np.ndarray:
    """[F, M] HTK-style triangular mel matrix with the DC bin zeroed
    (the Google VGGish frontend: unnormalized triangles on the HTK mel
    scale, spectrogram DC bin excluded)."""
    nyquist = audio_sample_rate / 2.0
    if lower_edge_hertz < 0.0:
        raise ValueError(f"lower_edge_hertz {lower_edge_hertz} must be >= 0")
    if lower_edge_hertz >= upper_edge_hertz:
        raise ValueError(f"lower_edge_hertz {lower_edge_hertz} >= upper_edge_hertz {upper_edge_hertz}")
    if upper_edge_hertz > nyquist:
        raise ValueError(f"upper_edge_hertz {upper_edge_hertz} is greater than Nyquist {nyquist}")

    bins_hz = np.linspace(0.0, nyquist, num_spectrogram_bins)
    bins_mel = _hertz_to_mel_htk(bins_hz)
    edges_mel = np.linspace(
        _hertz_to_mel_htk(lower_edge_hertz), _hertz_to_mel_htk(upper_edge_hertz), num_mel_bins + 2
    )
    lower = edges_mel[:-2][None, :]
    center = edges_mel[1:-1][None, :]
    upper = edges_mel[2:][None, :]
    lower_slope = (bins_mel[:, None] - lower) / (center - lower)
    upper_slope = (upper - bins_mel[:, None]) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    weights[0, :] = 0.0  # HTK excludes the spectrogram DC bin
    return weights.astype(np.float32)


# Copied from frechet_audio_distance_exported_tpu/ops/dsp.py:111.
def _hz_to_mel_slaney(frequencies):
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = frequencies >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(frequencies, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


# Copied from frechet_audio_distance_exported_tpu/ops/dsp.py:127.
def _mel_to_hz_slaney(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


# Copied from frechet_audio_distance_exported_tpu/ops/dsp.py:140.
@functools.lru_cache(maxsize=16)
def slaney_mel_matrix(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """[F, M] Slaney-scale, Slaney-normalized mel matrix (librosa parity:
    librosa.filters.mel(htk=False, norm='slaney'), transposed)."""
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz_slaney(
        np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    )
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


@functools.lru_cache(maxsize=16)
def chunked_dft_matrices(window_length: int, fft_length: int, hop_length: int):
    """The windowed DFT matrix split into hop-sized row chunks, zero-padded:
    ([m, hop, F] cos, [m, hop, F] sin) with m = ceil(W/hop)."""
    cos_m, sin_m = windowed_dft_matrices(window_length, fft_length)
    num_chunks = -(-window_length // hop_length)
    padded = num_chunks * hop_length
    f = fft_length // 2 + 1
    cos_p = np.zeros((padded, f), np.float32)
    sin_p = np.zeros((padded, f), np.float32)
    cos_p[:window_length] = cos_m
    sin_p[:window_length] = sin_m
    return (
        cos_p.reshape(num_chunks, hop_length, f),
        sin_p.reshape(num_chunks, hop_length, f),
    )


@functools.lru_cache(maxsize=16)
def _chunked_dft_cat(window_length: int, fft_length: int, hop_length: int):
    """chunked_dft_matrices with cos|sin concatenated: ([m, hop, 2F], F)."""
    cos_c, sin_c = chunked_dft_matrices(window_length, fft_length, hop_length)
    return np.concatenate([cos_c, sin_c], axis=2), cos_c.shape[2]


@functools.lru_cache(maxsize=16)
def _chunked_dft_cat_tensor(
    window_length: int, fft_length: int, hop_length: int, device: torch.device
) -> torch.Tensor:
    """_chunked_dft_cat as a float32 tensor, copied to ``device`` once."""
    cat_c, _ = _chunked_dft_cat(window_length, fft_length, hop_length)
    return torch.from_numpy(cat_c).to(device)


def stft_spectrum_strided(
    wave: torch.Tensor,
    num_frames: int,
    window_length: int,
    fft_length: int,
    hop_length: int,
):
    """[B, S] float32 -> (re, im), each [B, num_frames, F], of the windowed
    DFT of the uncentered frames wave[t*hop : t*hop + W]; samples past S
    read as zero.

    Chunk-sum order: re|im = sum over m of X[:, m:m+T] @ C_m, summed in
    chunk order like the JAX XLA path."""
    cat_c = _chunked_dft_cat_tensor(window_length, fft_length, hop_length, wave.device)
    num_chunks, _, two_f = cat_c.shape
    nbin = two_f // 2
    need = (num_frames + num_chunks - 1) * hop_length
    if wave.shape[-1] < need:
        wave = torch.nn.functional.pad(wave, (0, need - wave.shape[-1]))
    x = wave[:, :need].reshape(wave.shape[0], num_frames + num_chunks - 1, hop_length)
    both = None
    for m in range(num_chunks):
        t = torch.matmul(x[:, m : m + num_frames], cat_c[m])
        both = t if both is None else both + t
    return both[..., :nbin], both[..., nbin:]


def stft_power_strided(wave, num_frames, window_length, fft_length, hop_length) -> torch.Tensor:
    """[B, S] -> [B, num_frames, F] power re^2 + im^2 (stft_spectrum_strided)."""
    re, im = stft_spectrum_strided(wave, num_frames, window_length, fft_length, hop_length)
    return re * re + im * im


def stft_magnitude_strided(wave, num_frames, window_length, fft_length, hop_length) -> torch.Tensor:
    """[B, S] -> [B, num_frames, F] magnitude sqrt(re^2 + im^2)."""
    return torch.sqrt(stft_power_strided(wave, num_frames, window_length, fft_length, hop_length))
