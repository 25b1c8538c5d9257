"""Apple Core Audio Format (.caf) decode, PCM + G.711 payloads.

The port's copy of frechet_audio_distance_exported_tpu/utils/caf.py (L1-127);
the code after this docstring is verbatim. The port never imports the JAX package.

The reference reads CAF through soundfile/libsndfile (reference:
fad.py:145). CAF is a simple big-endian chunked container (Apple CAF File
Format spec): ``caff`` magic, then chunks of (fourcc, int64 size). The
``desc`` chunk is an AudioStreamBasicDescription; ``data`` starts with a
uint32 edit count. Linear PCM (8/16/24/32-bit int, float32/64, both
endiannesses) and 'ulaw'/'alaw' payloads are supported — the same coverage
as the sibling AIFF/AU codecs.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

CAF_MAGIC = b"caff"

_FLAG_IS_FLOAT = 1 << 0
_FLAG_IS_LITTLE_ENDIAN = 1 << 1


def read_caf(path: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Decode a CAF file; returns (data, sample_rate)."""
    from .audio_io import _convert_dtype

    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8 or raw[0:4] != CAF_MAGIC:
        raise ValueError(f"Not a CAF file: {path}")

    desc = None
    payload = None
    pos = 8  # magic(4) + version(2) + flags(2)
    n = len(raw)
    while pos + 12 <= n:
        fourcc = raw[pos : pos + 4]
        (size,) = struct.unpack_from(">q", raw, pos + 4)
        body_start = pos + 12
        if size == -1:  # final data chunk of unknown size runs to EOF
            if fourcc != b"data":
                raise ValueError(f"Unbounded non-data CAF chunk: {path}")
            size = n - body_start
        elif size < 0:  # any other negative size would stall the chunk walk
            raise ValueError(f"Malformed CAF chunk size {size}: {path}")
        body = raw[body_start : body_start + size]
        if fourcc == b"desc":
            if len(body) < 32:
                raise ValueError(f"Malformed CAF desc chunk: {path}")
            sample_rate, fmt_id, flags, _bpp, _fpp, chans, bits = struct.unpack_from(
                ">d4sIIIII", body, 0
            )
            desc = (sample_rate, fmt_id, flags, chans, bits)
        elif fourcc == b"data":
            payload = body[4:]  # skip uint32 edit count
        pos = body_start + size

    if desc is None or payload is None:
        raise ValueError(f"Malformed CAF file (missing desc/data chunk): {path}")
    sample_rate, fmt_id, flags, channels, bits = desc
    sample_rate = int(round(sample_rate))

    if fmt_id == b"lpcm":
        samples = _decode_lpcm(payload, flags, bits, path)
    elif fmt_id in (b"ulaw", b"alaw"):
        from . import g711

        u8 = np.frombuffer(payload, np.uint8)
        samples = g711.ulaw_decode(u8) if fmt_id == b"ulaw" else g711.alaw_decode(u8)
    else:
        raise ValueError(f"Unsupported CAF format '{fmt_id.decode(errors='replace')}': {path}")

    if channels > 1:
        frames = samples.shape[0] // channels
        samples = samples[: frames * channels].reshape(frames, channels)
    return _convert_dtype(samples, dtype), sample_rate


def _decode_lpcm(payload: bytes, flags: int, bits: int, path: str) -> np.ndarray:
    endian = "<" if (flags & _FLAG_IS_LITTLE_ENDIAN) else ">"
    if flags & _FLAG_IS_FLOAT:
        if bits == 32:
            return np.frombuffer(payload, f"{endian}f4").astype(np.float32)
        if bits == 64:
            return np.frombuffer(payload, f"{endian}f8").astype(np.float64)
        raise ValueError(f"Unsupported CAF float bit depth {bits}: {path}")
    if bits == 16:
        # .astype: native byte order, so _convert_dtype's dtype checks match
        return np.frombuffer(payload, f"{endian}i2").astype(np.int16)
    if bits == 32:
        return np.frombuffer(payload, f"{endian}i4").astype(np.int32)
    if bits == 8:  # CAF integer PCM is always signed
        return (np.frombuffer(payload, np.int8).astype(np.int16) << 8).astype(np.int16)
    if bits == 24:
        b = np.frombuffer(payload, np.uint8)
        b = b[: (len(b) // 3) * 3].reshape(-1, 3)
        if endian == "<":
            lo, mid, hi = b[:, 0], b[:, 1], b[:, 2]
        else:
            hi, mid, lo = b[:, 0], b[:, 1], b[:, 2]
        out = (
            lo.astype(np.int32)
            | (mid.astype(np.int32) << 8)
            | (hi.astype(np.int32) << 16)
        )
        out = np.where(out >= (1 << 23), out - (1 << 24), out)
        return (out << 8).astype(np.int32)  # int32 fullscale, like read_wav
    raise ValueError(f"Unsupported CAF PCM bit depth {bits}: {path}")


def write_caf(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Minimal CAF writer (big-endian PCM16) for tests/tooling."""
    from .audio_io import pcm16_payload

    data = np.asarray(data)
    channels = 1 if data.ndim == 1 else data.shape[1]
    payload = pcm16_payload(data, byteorder=">")
    desc = struct.pack(
        ">d4sIIIII", float(sample_rate), b"lpcm", 0, 2 * channels, 1, channels, 16
    )
    out = CAF_MAGIC + struct.pack(">HH", 1, 0)
    out += b"desc" + struct.pack(">q", len(desc)) + desc
    out += b"data" + struct.pack(">q", 4 + len(payload)) + struct.pack(">I", 0) + payload
    with open(path, "wb") as f:
        f.write(out)
