"""Kaiser-windowed sinc resampler (resampy ``kaiser_best`` parity), NumPy.

A copy of the NumPy path of frechet_audio_distance_exported_tpu/ops/resample.py
(L19-96, L104-135 and _accumulate_wing), without the native C call, so the
port never imports the JAX package. A band-limited sinc interpolation
evaluated through a precomputed, linearly interpolated filter table; output
length is ``int(n * sr_new / sr_orig)`` like resampy.
"""

from __future__ import annotations

import functools

import numpy as np

# Filter parameter presets mirroring resampy's shipped filters.
FILTERS = {
    "kaiser_best": dict(
        num_zeros=64, precision=9, beta=14.769656459379492, rolloff=0.9475937167399596
    ),
    "kaiser_fast": dict(num_zeros=16, precision=7, beta=8.555504641634386, rolloff=0.85),
}


@functools.lru_cache(maxsize=8)
def sinc_window(num_zeros: int, precision: int, beta: float, rolloff: float):
    """Half-filter table: rolloff-scaled sinc tapered by a Kaiser window.

    Returns (interp_win, num_table) where num_table = 2**precision entries per
    zero crossing and len(interp_win) == num_zeros * num_table + 1.
    """
    num_table = 2 ** precision
    n = num_table * num_zeros
    taps = np.linspace(0, num_zeros, num=n + 1, endpoint=True)
    sinc_win = rolloff * np.sinc(rolloff * taps)
    taper = np.kaiser(2 * n + 1, beta)[n:]
    return (taper * sinc_win).astype(np.float64), num_table


def resample(
    x: np.ndarray,
    sr_orig: int,
    sr_new: int,
    axis: int = 0,
    filter: str = "kaiser_best",
) -> np.ndarray:
    """Resample ``x`` from ``sr_orig`` to ``sr_new`` along ``axis``."""
    if sr_orig <= 0:
        raise ValueError(f"Invalid sample rate: sr_orig={sr_orig}")
    if sr_new <= 0:
        raise ValueError(f"Invalid sample rate: sr_new={sr_new}")
    x = np.asarray(x)
    if sr_orig == sr_new:
        return x
    if x.ndim == 1:
        return _resample_1d(x, sr_orig, sr_new, filter)
    x_moved = np.moveaxis(x, axis, 0)
    flat = x_moved.reshape(x_moved.shape[0], -1)
    cols = [_resample_1d(flat[:, c], sr_orig, sr_new, filter) for c in range(flat.shape[1])]
    out = np.stack(cols, axis=1).reshape((-1,) + x_moved.shape[1:])
    return np.moveaxis(out, 0, axis)


def _resample_1d(x: np.ndarray, sr_orig: int, sr_new: int, filter: str) -> np.ndarray:
    params = FILTERS[filter]
    interp_win, num_table = sinc_window(
        params["num_zeros"], params["precision"], params["beta"], params["rolloff"]
    )

    sample_ratio = float(sr_new) / float(sr_orig)
    n_out = int(x.shape[0] * sample_ratio)
    if n_out < 1:
        raise ValueError(
            f"Input signal length={x.shape[0]} is too small to resample from "
            f"{sr_orig}->{sr_new}"
        )

    win = interp_win
    if sample_ratio < 1:
        win = win * sample_ratio
    delta = np.zeros_like(win)
    delta[:-1] = np.diff(win)

    out_dtype = x.dtype if np.issubdtype(x.dtype, np.floating) else np.float64
    scale = min(1.0, sample_ratio)
    index_step = int(scale * num_table)
    time_increment = 1.0 / sample_ratio
    t_out = np.arange(n_out, dtype=np.float64) * time_increment

    nwin = win.shape[0]
    n_orig = x.shape[0]

    n = t_out.astype(np.int64)  # floor: t_out >= 0
    xf = x.astype(np.float64, copy=False)
    y = np.zeros(n_out, dtype=np.float64)

    # Left wing: y[t] += sum_i w(offset + i*step) * x[n - i]
    frac = scale * (t_out - n)
    index_frac = frac * num_table
    offset = index_frac.astype(np.int64)
    eta = index_frac - offset
    i_max = np.minimum(n + 1, (nwin - offset) // index_step)
    _accumulate_wing(y, xf, win, delta, offset, eta, i_max, n, -1, index_step)

    # Right wing: y[t] += sum_k w(offset' + k*step) * x[n + k + 1]
    frac_r = scale - frac
    index_frac = frac_r * num_table
    offset = index_frac.astype(np.int64)
    eta = index_frac - offset
    k_max = np.minimum(n_orig - n - 1, (nwin - offset) // index_step)
    _accumulate_wing(y, xf, win, delta, offset, eta, k_max, n + 1, +1, index_step)

    return y.astype(out_dtype, copy=False)


def _accumulate_wing(y, x, win, delta, offset, eta, count, base, direction, index_step):
    """Vectorized wing accumulation: loop over tap index, vector ops over outputs."""
    max_taps = int(count.max(initial=0))
    if max_taps <= 0:
        return
    n_orig = x.shape[0]
    for i in range(max_taps):
        valid = i < count
        idx = offset + i * index_step
        # Clip for safe gather; contributions are zeroed by `valid`.
        idx_c = np.minimum(idx, win.shape[0] - 1)
        src = base + direction * i
        src_c = np.clip(src, 0, n_orig - 1)
        weight = win[idx_c] + eta * delta[idx_c]
        y += np.where(valid, weight * x[src_c], 0.0)
