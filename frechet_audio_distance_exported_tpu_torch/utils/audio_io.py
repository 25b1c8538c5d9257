"""Audio I/O: WAV codec, normalisation, mono-mix, directory loading.

A copy of the WAV codec and the loaders of
frechet_audio_distance_exported_tpu/utils/audio_io.py (L47-208, L304-360),
without tqdm and without the native C decoder, so the port never imports the
JAX package. Observable semantics are the reference's:

- ``dtype='float32'`` returns float32 in [-1, 1] (PCM full-scale normalised,
  the libsndfile convention).
- ``dtype='int16'``/``'int32'`` return raw integer samples, which
  ``load_audio`` then divides by 32768 / 2**31.
- stereo -> mono by channel mean when ``len(shape) > channels`` (including
  the reference's rank-vs-channels quirk).
- hidden files (leading '.') are skipped when loading directories.

Only RIFF/WAVE decodes here; every other container raises a ValueError that
names its format (its decoder is not ported yet).
"""

from __future__ import annotations

import os
import struct
from multiprocessing.dummy import Pool as ThreadPool
from typing import List, Tuple

import numpy as np

from ..ops.resample import resample

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE file: (data [frames] or [frames, channels], sample_rate)."""
    with open(path, "rb") as f:
        raw = f.read()

    if len(raw) < 12 or raw[0:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"Not a RIFF/WAVE file: {path}")

    fmt = None
    data_bytes = None
    pos = 12
    n = len(raw)
    while pos + 8 <= n:
        chunk_id = raw[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", raw, pos + 4)
        body = raw[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = _parse_fmt(body)
        elif chunk_id == b"data":
            data_bytes = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or data_bytes is None:
        raise ValueError(f"Malformed WAVE file (missing fmt/data chunk): {path}")

    audio_format, channels, sample_rate, bits = fmt
    samples = _decode_samples(data_bytes, audio_format, bits, path)

    if channels > 1:
        frames = samples.shape[0] // channels
        samples = samples[: frames * channels].reshape(frames, channels)

    return _convert_dtype(samples, dtype), sample_rate


def _parse_fmt(body: bytes):
    if len(body) < 16:
        raise ValueError("Malformed fmt chunk")
    audio_format, channels, sample_rate, _, _, bits = struct.unpack_from("<HHIIHH", body, 0)
    if audio_format == _WAVE_FORMAT_EXTENSIBLE and len(body) >= 40:
        # Subformat GUID: first two bytes carry the actual format tag.
        (audio_format,) = struct.unpack_from("<H", body, 24)
    return audio_format, channels, sample_rate, bits


def _decode_samples(data: bytes, audio_format: int, bits: int, path: str) -> np.ndarray:
    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 16:
            return np.frombuffer(data, dtype="<i2")
        if bits == 32:
            return np.frombuffer(data, dtype="<i4")
        if bits == 8:
            return np.frombuffer(data, dtype=np.uint8)
        if bits == 24:
            b = np.frombuffer(data, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            out = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            # Sign-extend 24-bit to 32-bit, scaled into int32 full scale like libsndfile.
            out = np.where(out >= (1 << 23), out - (1 << 24), out)
            return (out << 8).astype(np.int32)
        raise ValueError(f"Unsupported PCM bit depth {bits}: {path}")
    if audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            return np.frombuffer(data, dtype="<f4")
        if bits == 64:
            return np.frombuffer(data, dtype="<f8")
        raise ValueError(f"Unsupported float bit depth {bits}: {path}")
    raise ValueError(f"Unsupported WAVE format tag {audio_format}: {path}")


def _convert_dtype(samples: np.ndarray, dtype: str) -> np.ndarray:
    """Convert decoded samples to the requested dtype, libsndfile-style."""
    kind = samples.dtype
    if dtype in ("float32", "float64"):
        target = np.float32 if dtype == "float32" else np.float64
        if kind == np.int16:
            return (samples.astype(target)) / 32768.0
        if kind == np.int32:
            return (samples.astype(target)) / float(2 ** 31)
        if kind == np.uint8:
            return (samples.astype(target) - 128.0) / 128.0
        return samples.astype(target)
    if dtype == "int16":
        if kind == np.int16:
            return samples
        if kind == np.int32:
            return (samples >> 16).astype(np.int16)
        if np.issubdtype(kind, np.floating):
            return np.clip(np.round(samples * 32768.0), -32768, 32767).astype(np.int16)
        if kind == np.uint8:
            return ((samples.astype(np.int16) - 128) << 8).astype(np.int16)
    if dtype == "int32":
        if kind == np.int32:
            return samples
        if kind == np.int16:
            return samples.astype(np.int32) << 16
        if np.issubdtype(kind, np.floating):
            return np.clip(np.round(samples * float(2 ** 31)), -(2 ** 31), 2 ** 31 - 1).astype(
                np.int32
            )
    raise ValueError(f"Unsupported read dtype: {dtype}")


def pcm16_payload(data: np.ndarray) -> bytes:
    """Float PCM in [-1, 1] -> packed little-endian int16 bytes (round + clip)."""
    return (
        np.clip(np.round(np.asarray(data, np.float64).reshape(-1) * 32768.0), -32768, 32767)
        .astype("<i2")
        .tobytes()
    )


def write_wav(path: str, data: np.ndarray, sample_rate: int, subtype: str = "pcm16") -> None:
    """Minimal WAV writer (PCM16 or float32), used by tests and tools."""
    data = np.asarray(data)
    if data.ndim == 1:
        channels = 1
        frames = data
    else:
        channels = data.shape[1]
        frames = data.reshape(-1)
    if subtype == "pcm16":
        payload = pcm16_payload(frames)
        audio_format, bits = _WAVE_FORMAT_PCM, 16
    elif subtype == "float32":
        payload = np.asarray(frames, dtype="<f4").tobytes()
        audio_format, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
    else:
        raise ValueError(f"Unsupported subtype: {subtype}")

    byte_rate = sample_rate * channels * (bits // 8)
    block_align = channels * (bits // 8)
    fmt = struct.pack("<HHIIHH", audio_format, channels, sample_rate, byte_rate, block_align, bits)
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)


# Containers the JAX package decodes and this package does not yet, by magic bytes.
_UNPORTED_FORMATS = {
    b"fLaC": "FLAC",
    b"FORM": "AIFF/AIFC",
    b".snd": "Sun AU",
    b"RF64": "RF64",
    b"BW64": "BW64",
    b"riff": "Sony Wave64",
    b"caff": "Apple CAF",
    b"OggS": "Ogg (Vorbis/Opus/FLAC)",
}


def sf_read(fname: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Decode ``fname`` by its magic bytes: WAV, or a ValueError naming the format."""
    with open(fname, "rb") as f:
        magic = f.read(4)
    if magic == b"RIFF":
        return read_wav(fname, dtype=dtype)
    name = _UNPORTED_FORMATS.get(magic)
    if name is None and (magic[:3] == b"ID3" or (len(magic) >= 2 and magic[0] == 0xFF and (magic[1] & 0xE0) == 0xE0)):
        name = "MP3"
    if name is not None:
        raise ValueError(f"{name} decoding is not ported yet; only WAV is supported: {fname}")
    raise ValueError(f"Unsupported audio format in {fname} (the port decodes WAV only)")


def load_audio(fname: str, sample_rate: int, channels: int, dtype: str = "float32") -> np.ndarray:
    """Load and preprocess one audio file: decode -> (the reference's integer
    renormalisation quirk) -> mono-mix -> resample to ``sample_rate``."""
    wav_data, sr = sf_read(fname, dtype=dtype)

    # Normalize integer audio to [-1.0, +1.0] (for the default float32 path
    # this is a no-op, kept for parity).
    if dtype == "int16":
        wav_data = wav_data / 32768.0
    elif dtype == "int32":
        wav_data = wav_data / float(2 ** 31)

    # Convert to mono if needed (the rank-vs-channels comparison quirk is
    # kept verbatim as behavioural spec).
    if len(wav_data.shape) > channels:
        wav_data = np.mean(wav_data, axis=1)

    if sr != sample_rate:
        wav_data = resample(wav_data, sr, sample_rate)

    return wav_data


def list_audio_files(directory: str) -> List[str]:
    """Non-hidden files of a directory."""
    return [f for f in os.listdir(directory) if not f.startswith(".")]


def load_audio_files(
    directory: str,
    sample_rate: int,
    channels: int,
    dtype: str = "float32",
    num_workers: int = 8,
    verbose: bool = False,
) -> List[np.ndarray]:
    """Load every non-hidden file in ``directory`` with a thread pool, in
    directory-listing order."""
    files = list_audio_files(directory)
    if verbose:
        print(f"[FAD-TORCH] Loading {len(files)} files from {directory}...")
    paths = [os.path.join(directory, fname) for fname in files]
    return load_audio_paths(paths, sample_rate, channels, dtype, num_workers, verbose)


def load_audio_paths(
    paths: List[str],
    sample_rate: int,
    channels: int,
    dtype: str = "float32",
    num_workers: int = 8,
    verbose: bool = False,
) -> List[np.ndarray]:
    """Load the given files with a thread pool, in the given order."""
    pool = ThreadPool(num_workers)
    try:
        results = [
            pool.apply_async(load_audio, args=(path, sample_rate, channels, dtype))
            for path in paths
        ]
        out = []
        for i, r in enumerate(results, 1):
            out.append(r.get())
            if verbose and (i % 100 == 0 or i == len(results)):
                print(f"[FAD-TORCH] loaded {i}/{len(results)}")
    finally:
        pool.close()
        pool.join()
    return out
