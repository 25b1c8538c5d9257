"""AU / SND (Sun audio) codec.

The port's copy of frechet_audio_distance_exported_tpu/utils/au.py (L1-101);
the code after this docstring is verbatim. The port never imports the JAX package.

The classic big-endian ``.snd`` container (NeXT/Sun), still common for
G.711 telephony samples; the reference reads it via libsndfile
(reference: fad.py:145). Header: magic '.snd', data offset, data size
(0xFFFFFFFF = unknown), encoding, sample rate, channels — all >u4.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_ENC_ULAW = 1
_ENC_PCM8 = 2  # signed, unlike WAV's unsigned u8
_ENC_PCM16 = 3
_ENC_PCM24 = 4
_ENC_PCM32 = 5
_ENC_F32 = 6
_ENC_F64 = 7
_ENC_ALAW = 27


def read_au(path: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Decode a Sun AU file -> (data, sample_rate), soundfile conventions."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 24 or raw[0:4] != b".snd":
        raise ValueError(f"Not an AU file: {path}")
    offset, size, encoding, sample_rate, channels = struct.unpack_from(">5I", raw, 4)
    if offset < 24 or offset > len(raw):
        raise ValueError(f"Malformed AU header (offset {offset}): {path}")
    payload = raw[offset:]
    if size != 0xFFFFFFFF:
        payload = payload[:size]

    if encoding == _ENC_ULAW:
        from .g711 import ulaw_decode

        samples = ulaw_decode(np.frombuffer(payload, dtype=np.uint8))
    elif encoding == _ENC_ALAW:
        from .g711 import alaw_decode

        samples = alaw_decode(np.frombuffer(payload, dtype=np.uint8))
    elif encoding == _ENC_PCM8:
        samples = np.frombuffer(payload, dtype=np.int8).astype(np.int16) << 8
    elif encoding == _ENC_PCM16:
        samples = np.frombuffer(payload, dtype=">i2").astype(np.int16)
    elif encoding == _ENC_PCM24:
        b = np.frombuffer(payload, dtype=np.uint8)
        b = b[: (len(b) // 3) * 3].reshape(-1, 3)
        out = (
            (b[:, 0].astype(np.int32) << 16)
            | (b[:, 1].astype(np.int32) << 8)
            | b[:, 2].astype(np.int32)
        )
        out = np.where(out >= (1 << 23), out - (1 << 24), out)
        samples = (out << 8).astype(np.int32)
    elif encoding == _ENC_PCM32:
        samples = np.frombuffer(payload, dtype=">i4").astype(np.int32)
    elif encoding == _ENC_F32:
        samples = np.frombuffer(payload, dtype=">f4").astype(np.float32)
    elif encoding == _ENC_F64:
        samples = np.frombuffer(payload, dtype=">f8").astype(np.float64)
    else:
        raise ValueError(f"Unsupported AU encoding {encoding}: {path}")

    if channels > 1:
        frames = samples.shape[0] // channels
        samples = samples[: frames * channels].reshape(frames, channels)

    from .audio_io import _convert_dtype

    return _convert_dtype(samples, dtype), sample_rate


def write_au(path: str, data: np.ndarray, sample_rate: int, subtype: str = "pcm16") -> None:
    """Minimal AU writer (pcm16 | float32 | ulaw | alaw), for tests."""
    data = np.asarray(data)
    channels = 1 if data.ndim == 1 else data.shape[1]
    frames = data.reshape(-1)
    clipped = np.clip(np.round(np.asarray(frames, np.float64) * 32768.0), -32768, 32767)
    if subtype == "pcm16":
        payload, enc = clipped.astype(">i2").tobytes(), _ENC_PCM16
    elif subtype == "float32":
        payload, enc = np.asarray(frames, ">f4").tobytes(), _ENC_F32
    elif subtype == "ulaw":
        from .g711 import ulaw_encode

        payload, enc = ulaw_encode(clipped.astype(np.int16)).tobytes(), _ENC_ULAW
    elif subtype == "alaw":
        from .g711 import alaw_encode

        payload, enc = alaw_encode(clipped.astype(np.int16)).tobytes(), _ENC_ALAW
    else:
        raise ValueError(f"Unsupported subtype: {subtype}")
    header = b".snd" + struct.pack(">5I", 24, len(payload), enc, sample_rate, channels)
    with open(path, "wb") as f:
        f.write(header + payload)
