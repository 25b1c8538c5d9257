"""G.711 mu-law / A-law companding (vectorized NumPy).

The port's copy of frechet_audio_distance_exported_tpu/utils/g711.py (L1-59);
the code after this docstring is verbatim. The port never imports the JAX package.

Used by the AU and AIFF-C decoders (utils.au / utils.aiff); the reference
reads these encodings through libsndfile (reference: fad.py:145). The
decode formulas are the standard CCITT G.711 expansions (identical to the
classic Sun g711.c tables); decoded samples land on the usual int16 grid
(mu-law range +-32124, A-law +-32256).
"""

from __future__ import annotations

import numpy as np

_BIAS = 0x84  # mu-law bias


def ulaw_decode(u: np.ndarray) -> np.ndarray:
    """uint8 mu-law bytes -> int16 linear PCM."""
    u = (~u.astype(np.uint8)).astype(np.int32)
    t = ((u & 0x0F) << 3) + _BIAS
    t = t << ((u >> 4) & 0x07)
    return np.where(u & 0x80, _BIAS - t, t - _BIAS).astype(np.int16)


def ulaw_encode(pcm: np.ndarray) -> np.ndarray:
    """int16 linear PCM -> uint8 mu-law bytes (Sun g711.c semantics)."""
    pcm = pcm.astype(np.int32)
    neg = pcm < 0
    mag = np.where(neg, _BIAS - pcm, pcm + _BIAS)
    mag = np.minimum(mag, 0x7FFF)
    # Segment s ends at (1 << (s+8)) - 1 (Sun g711.c's seg_end table).
    seg = np.zeros_like(mag)
    for s in range(7):
        seg = np.where(mag >= (1 << (s + 8)), s + 1, seg)
    uval = (seg << 4) | ((mag >> (seg + 3)) & 0x0F)
    return np.where(neg, uval ^ 0x7F, uval ^ 0xFF).astype(np.uint8)


def alaw_decode(a: np.ndarray) -> np.ndarray:
    """uint8 A-law bytes -> int16 linear PCM."""
    a = a.astype(np.int32) ^ 0x55
    t = (a & 0x0F) << 4
    seg = (a & 0x70) >> 4
    t = np.where(seg == 0, t + 8, np.where(seg == 1, t + 0x108, (t + 0x108) << np.maximum(seg - 1, 0)))
    return np.where(a & 0x80, t, -t).astype(np.int16)


def alaw_encode(pcm: np.ndarray) -> np.ndarray:
    """int16 linear PCM -> uint8 A-law bytes."""
    pcm = pcm.astype(np.int32)
    neg = pcm < 0
    mag = np.where(neg, -pcm - 1, pcm)
    mag = np.minimum(mag, 0x7FFF)
    seg = np.zeros_like(mag)
    for s in range(7):
        seg = np.where(mag >= (1 << (s + 8)), s + 1, seg)
    low = np.where(seg < 2, (mag >> 4) & 0x0F, (mag >> (seg + 3)) & 0x0F)
    aval = (seg << 4) | low
    return (np.where(neg, aval, aval | 0x80) ^ 0x55).astype(np.uint8)
