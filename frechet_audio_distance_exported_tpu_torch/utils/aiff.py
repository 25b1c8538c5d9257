"""AIFF / AIFF-C codec (decode + minimal encoder for tests).

The port's copy of frechet_audio_distance_exported_tpu/utils/aiff.py (L1-183);
the code after this docstring is verbatim. The port never imports the JAX package.

The reference decodes every libsndfile-supported container via
``soundfile.read`` (reference: fad.py:145); AIFF is one of the common
lossless ones (Apple ecosystem exports). This is a self-contained
big-endian IFF parser supporting the PCM and float compression types
libsndfile handles:

- FORM type ``AIFF``: big-endian signed PCM (8/16/24/32 bit)
- FORM type ``AIFC`` compression types: ``NONE`` (BE PCM), ``sowt``
  (little-endian PCM16, the QuickTime variant), ``fl32``/``FL32`` and
  ``fl64``/``FL64`` (IEEE floats), ``ulaw``/``ULAW`` and ``alaw``/``ALAW``
  (G.711, decoded via utils.g711).

Returned integer arrays use the same conventions as utils.audio_io's WAV
path (int16 for <=16-bit, int32 fullscale for 24/32-bit), so dtype
conversion is shared.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def _read_extended80(b: bytes) -> float:
    """80-bit IEEE 754 extended float (the COMM sampleRate field)."""
    (se, mant) = struct.unpack(">HQ", b[:10])
    sign = -1.0 if se & 0x8000 else 1.0
    exp = se & 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    if exp == 0x7FFF:
        return sign * float("inf")
    # Explicit integer bit: value = mant * 2**(exp - 16383 - 63)
    return sign * float(mant) * 2.0 ** (exp - 16383 - 63)


def _write_extended80(x: float) -> bytes:
    if x == 0.0:
        return b"\x00" * 10
    sign = 0x8000 if x < 0 else 0
    x = abs(x)
    exp = int(np.floor(np.log2(x)))
    mant = int(round(x * 2.0 ** (63 - exp)))
    if mant >= 1 << 64:  # rounding overflow: renormalize
        mant >>= 1
        exp += 1
    return struct.pack(">HQ", sign | (exp + 16383), mant)


def read_aiff(path: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Decode an AIFF/AIFF-C file -> (data, sample_rate).

    Data is [frames] (mono) or [frames, channels], converted to ``dtype``
    with libsndfile conventions (via audio_io._convert_dtype).
    """
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 12 or raw[0:4] != b"FORM" or raw[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError(f"Not an AIFF file: {path}")
    is_aifc = raw[8:12] == b"AIFC"

    comm = None
    ssnd = None
    pos = 12
    n = len(raw)
    while pos + 8 <= n:
        chunk_id = raw[pos : pos + 4]
        (chunk_size,) = struct.unpack_from(">I", raw, pos + 4)
        body = raw[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"COMM":
            comm = body
        elif chunk_id == b"SSND":
            ssnd = body
        pos += 8 + chunk_size + (chunk_size & 1)  # IFF chunks are word-aligned

    if comm is None or ssnd is None or len(comm) < 18 or len(ssnd) < 8:
        raise ValueError(f"Malformed AIFF (missing COMM/SSND): {path}")

    channels, num_frames = struct.unpack_from(">hI", comm, 0)
    (bits,) = struct.unpack_from(">h", comm, 6)
    sample_rate = int(round(_read_extended80(comm[8:18])))
    compression = b"NONE"
    if is_aifc and len(comm) >= 22:
        compression = comm[18:22]

    offset, _block = struct.unpack_from(">II", ssnd, 0)
    payload = ssnd[8 + offset :]

    samples = _decode_payload(payload, compression, bits, path)
    samples = samples[: num_frames * channels] if num_frames else samples
    if channels > 1:
        frames = samples.shape[0] // channels
        samples = samples[: frames * channels].reshape(frames, channels)

    from .audio_io import _convert_dtype

    return _convert_dtype(samples, dtype), sample_rate


def _decode_payload(payload: bytes, compression: bytes, bits: int, path: str) -> np.ndarray:
    if compression in (b"NONE", b"twos"):
        if bits == 16:
            return np.frombuffer(payload, dtype=">i2").astype(np.int16)
        if bits == 8:
            # AIFF 8-bit PCM is signed (unlike WAV's unsigned u8).
            return np.frombuffer(payload, dtype=np.int8).astype(np.int16) << 8
        if bits == 24:
            b = np.frombuffer(payload, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            out = (
                (b[:, 0].astype(np.int32) << 16)
                | (b[:, 1].astype(np.int32) << 8)
                | b[:, 2].astype(np.int32)
            )
            out = np.where(out >= (1 << 23), out - (1 << 24), out)
            return (out << 8).astype(np.int32)
        if bits == 32:
            return np.frombuffer(payload, dtype=">i4").astype(np.int32)
        raise ValueError(f"Unsupported AIFF PCM bit depth {bits}: {path}")
    if compression == b"sowt":  # little-endian PCM16 ('twos' reversed)
        return np.frombuffer(payload, dtype="<i2").astype(np.int16)
    if compression in (b"fl32", b"FL32"):
        return np.frombuffer(payload, dtype=">f4").astype(np.float32)
    if compression in (b"fl64", b"FL64"):
        return np.frombuffer(payload, dtype=">f8").astype(np.float64)
    if compression in (b"ulaw", b"ULAW"):
        from .g711 import ulaw_decode

        return ulaw_decode(np.frombuffer(payload, dtype=np.uint8))
    if compression in (b"alaw", b"ALAW"):
        from .g711 import alaw_decode

        return alaw_decode(np.frombuffer(payload, dtype=np.uint8))
    raise ValueError(
        f"Unsupported AIFC compression {compression!r}: {path} "
        f"(supported: NONE/sowt/fl32/fl64/ulaw/alaw)"
    )


def write_aiff(
    path: str, data: np.ndarray, sample_rate: int, subtype: str = "pcm16"
) -> None:
    """Minimal AIFF/AIFC writer (pcm16 | sowt | float32 | ulaw), for tests."""
    data = np.asarray(data)
    channels = 1 if data.ndim == 1 else data.shape[1]
    frames = data.reshape(-1)
    clipped = np.clip(np.round(np.asarray(frames, np.float64) * 32768.0), -32768, 32767)
    if subtype == "pcm16":
        payload, bits, comp = clipped.astype(">i2").tobytes(), 16, None
    elif subtype == "sowt":
        payload, bits, comp = clipped.astype("<i2").tobytes(), 16, b"sowt"
    elif subtype == "float32":
        payload, bits, comp = np.asarray(frames, ">f4").tobytes(), 32, b"fl32"
    elif subtype == "ulaw":
        from .g711 import ulaw_encode

        payload, bits, comp = ulaw_encode(clipped.astype(np.int16)).tobytes(), 8, b"ulaw"
    else:
        raise ValueError(f"Unsupported subtype: {subtype}")

    num_frames = len(frames) // channels
    comm = struct.pack(">hIh", channels, num_frames, bits) + _write_extended80(
        float(sample_rate)
    )
    form_type = b"AIFF"
    if comp is not None:
        form_type = b"AIFC"
        comm += comp + b"\x00\x00"  # empty pascal compression name, padded
    ssnd = struct.pack(">II", 0, 0) + payload

    def chunk(cid: bytes, body: bytes) -> bytes:
        return cid + struct.pack(">I", len(body)) + body + (b"\x00" if len(body) & 1 else b"")

    body = form_type
    if comp is not None:
        body += chunk(b"FVER", struct.pack(">I", 0xA2805140))
    body += chunk(b"COMM", comm) + chunk(b"SSND", ssnd)
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)
