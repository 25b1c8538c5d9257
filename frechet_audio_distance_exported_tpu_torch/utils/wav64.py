"""64-bit WAV-family containers: RF64/BW64 (EBU Tech 3306) and Sony Wave64.

The port's copy of frechet_audio_distance_exported_tpu/utils/wav64.py (L1-162);
the code after this docstring is verbatim. The port never imports the JAX package.

The reference reads these through soundfile/libsndfile (reference:
fad.py:145). Both are thin 64-bit extensions of RIFF/WAVE — the sample
encodings are identical to WAV, so decoding reuses audio_io's fmt parser,
PCM/float decoders, and dtype conversion:

- **RF64/BW64**: RIFF with the outer size and the ``data`` size moved to a
  mandatory leading ``ds64`` chunk when they exceed 4 GiB (files whose
  32-bit size fields are 0xFFFFFFFF).
- **Wave64 (.w64)**: every chunk id is a 16-byte GUID whose first 4 bytes
  are the RIFF fourcc, and every size is a 64-bit count that INCLUDES the
  24-byte chunk header; chunks align to 8 bytes.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

RF64_MAGICS = (b"RF64", b"BW64")
W64_RIFF_GUID = b"riff\x2e\x91\xcf\x11\xa5\xd6\x28\xdb\x04\xc1\x00\x00"
_W64_WAVE_GUID_PREFIX = b"wave"
_GUID_SUFFIX = b"\xf3\xac\xd3\x11\x8c\xd1\x00\xc0\x4f\x8e\xdb\x8a"


def read_rf64(path: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Decode an RF64/BW64 file; returns (data, sample_rate)."""
    from .audio_io import _convert_dtype, _decode_samples, _parse_fmt

    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 16 or raw[0:4] not in RF64_MAGICS or raw[8:12] != b"WAVE":
        raise ValueError(f"Not an RF64/BW64 file: {path}")

    data_size_64 = None
    fmt = None
    data_bytes = None
    pos = 12
    n = len(raw)
    while pos + 8 <= n:
        chunk_id = raw[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", raw, pos + 4)
        if chunk_id == b"ds64":
            # riffSize(8) dataSize(8) sampleCount(8) [+ table]; only the
            # data size matters for decode.
            if chunk_size < 24:
                raise ValueError(f"Malformed ds64 chunk: {path}")
            (data_size_64,) = struct.unpack_from("<Q", raw, pos + 16)
        elif chunk_id == b"data" and chunk_size == 0xFFFFFFFF:
            if data_size_64 is None:
                raise ValueError(f"RF64 data chunk precedes ds64: {path}")
            chunk_size = data_size_64
        body = raw[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = _parse_fmt(body)
        elif chunk_id == b"data":
            data_bytes = body
        pos += 8 + chunk_size + (chunk_size & 1)

    if fmt is None or data_bytes is None:
        raise ValueError(f"Malformed RF64 file (missing fmt/data chunk): {path}")
    audio_format, channels, sample_rate, bits = fmt
    samples = _decode_samples(data_bytes, audio_format, bits, path)
    if channels > 1:
        frames = samples.shape[0] // channels
        samples = samples[: frames * channels].reshape(frames, channels)
    return _convert_dtype(samples, dtype), sample_rate


def read_w64(path: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Decode a Sony Wave64 (.w64) file; returns (data, sample_rate)."""
    from .audio_io import _convert_dtype, _decode_samples, _parse_fmt

    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 40 or raw[0:16] != W64_RIFF_GUID:
        raise ValueError(f"Not a Wave64 file: {path}")
    if raw[24:28] != _W64_WAVE_GUID_PREFIX:
        raise ValueError(f"Wave64 file without wave form type: {path}")

    fmt = None
    data_bytes = None
    pos = 40  # riff GUID(16) + size(8) + wave GUID(16)
    n = len(raw)
    while pos + 24 <= n:
        fourcc = raw[pos : pos + 4]  # GUIDs are distinguished by their fourcc
        (chunk_size,) = struct.unpack_from("<Q", raw, pos + 16)
        if chunk_size < 24:
            raise ValueError(f"Malformed Wave64 chunk at {pos}: {path}")
        body = raw[pos + 24 : pos + chunk_size]
        if fourcc == b"fmt ":
            fmt = _parse_fmt(body)
        elif fourcc == b"data":
            data_bytes = body
        pos += (chunk_size + 7) & ~7  # sizes include the header; 8-align

    if fmt is None or data_bytes is None:
        raise ValueError(f"Malformed Wave64 file (missing fmt/data chunk): {path}")
    audio_format, channels, sample_rate, bits = fmt
    samples = _decode_samples(data_bytes, audio_format, bits, path)
    if channels > 1:
        frames = samples.shape[0] // channels
        samples = samples[: frames * channels].reshape(frames, channels)
    return _convert_dtype(samples, dtype), sample_rate


def _w64_guid(fourcc: bytes) -> bytes:
    return fourcc + _GUID_SUFFIX


def write_rf64(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Minimal RF64 writer (PCM16, always-ds64 form) for tests/tooling."""
    from .audio_io import pcm16_payload

    data = np.asarray(data)
    channels = 1 if data.ndim == 1 else data.shape[1]
    payload = pcm16_payload(data)
    fmt = struct.pack(
        "<HHIIHH", 1, channels, sample_rate, sample_rate * channels * 2, channels * 2, 16
    )
    ds64 = struct.pack(
        "<QQQI",
        # riffSize = bytes after the 8-byte RIFF header: "WAVE" + three
        # chunks (ds64 body is 28 bytes) + data pad byte.
        4 + 8 * 3 + 28 + len(fmt) + len(payload) + (len(payload) & 1),  # riffSize
        len(payload),  # dataSize
        len(payload) // (2 * channels),  # sampleCount
        0,  # table length
    )
    out = b"RF64" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
    out += b"ds64" + struct.pack("<I", len(ds64)) + ds64
    out += b"fmt " + struct.pack("<I", len(fmt)) + fmt
    out += b"data" + struct.pack("<I", 0xFFFFFFFF) + payload
    if len(payload) & 1:
        out += b"\x00"
    with open(path, "wb") as f:
        f.write(out)


def write_w64(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Minimal Wave64 writer (PCM16) for tests/tooling."""
    from .audio_io import pcm16_payload

    data = np.asarray(data)
    channels = 1 if data.ndim == 1 else data.shape[1]
    payload = pcm16_payload(data)
    fmt = struct.pack(
        "<HHIIHH", 1, channels, sample_rate, sample_rate * channels * 2, channels * 2, 16
    )

    def chunk(fourcc: bytes, body: bytes) -> bytes:
        size = 24 + len(body)
        pad = (-size) % 8
        return _w64_guid(fourcc) + struct.pack("<Q", size) + body + b"\x00" * pad

    body = _w64_guid(b"wave") + chunk(b"fmt ", fmt) + chunk(b"data", payload)
    out = W64_RIFF_GUID + struct.pack("<Q", 24 + len(body)) + body
    with open(path, "wb") as f:
        f.write(out)
