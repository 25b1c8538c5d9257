"""Audio I/O: every container the JAX package decodes, normalisation,
mono-mix, directory loading.

The port's copy of frechet_audio_distance_exported_tpu/utils/audio_io.py
(L19-334): the WAV codec, `_convert_dtype` with the native int -> float32
conversion, `pcm16_payload` with its byte order, `sf_read`'s dispatch by
magic bytes (WAV, RF64/BW64, Wave64, FLAC, FLAC after an ID3v2 tag, AIFF/
AIFC, AU, CAF, Ogg Vorbis/Opus/FLAC, MP3 by its frame sync), the optional
soundfile preference and `set_native_decoder`. The directory loaders are
the port's own (no tqdm). Observable semantics are the reference's:

- ``dtype='float32'`` returns float32 in [-1, 1] (PCM full-scale normalised,
  the libsndfile convention).
- ``dtype='int16'``/``'int32'`` return raw integer samples, which
  ``load_audio`` then divides by 32768 / 2**31.
- stereo -> mono by channel mean when ``len(shape) > channels`` (including
  the reference's rank-vs-channels quirk).
- hidden files (leading '.') are skipped when loading directories.
"""

from __future__ import annotations

import os
import struct
from multiprocessing.dummy import Pool as ThreadPool
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..ops.resample import resample

try:  # Optional: honor soundfile if the environment provides it.
    import soundfile as _sf  # type: ignore

    if not hasattr(_sf, "read"):  # a test stub or broken install, not the API
        _sf = None
except Exception:  # pragma: no cover - absent in this environment
    _sf = None

# Optional native (C) decoder hook: fn(path) -> (float32 array [n] or [n, ch], sr)
_NATIVE_DECODER: Optional[Callable[[str], Tuple[np.ndarray, int]]] = None


def set_native_decoder(fn: Optional[Callable[[str], Tuple[np.ndarray, int]]]) -> None:
    global _NATIVE_DECODER
    _NATIVE_DECODER = fn


_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE file.

    Returns (data, sample_rate) with data shaped [frames] (mono) or
    [frames, channels], matching soundfile's conventions for the requested
    dtype.
    """
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
            # Sign-extend 24-bit to 32-bit, scaled into int32 fullscale like libsndfile.
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
        if kind in (np.int16, np.int32) and dtype == "float32":
            from .. import native  # OpenMP PCM conversion when available

            channels = samples.shape[1] if samples.ndim == 2 else 1
            out = native.pcm_to_f32(samples, channels, mixdown=False)
            if out is not None:
                return out.reshape(samples.shape)
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


def pcm16_payload(data: np.ndarray, byteorder: str = "<") -> bytes:
    """Float PCM in [-1, 1] -> packed int16 bytes (round + clip).

    Shared by every PCM16 container writer (WAV/RF64/W64/CAF) so the
    quantization semantics stay identical across formats."""
    return (
        np.clip(np.round(np.asarray(data, np.float64).reshape(-1) * 32768.0), -32768, 32767)
        .astype(f"{byteorder}i2")
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


def sf_read(fname: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """soundfile.read-compatible entry point: native hook > soundfile > own
    codecs, sniffed by magic bytes (RIFF/WAVE + FLAC + AIFF/AIFC + AU pure,
    Ogg Vorbis / Ogg Opus / MP3 via the system codec libraries)."""
    if _NATIVE_DECODER is not None and dtype in ("float32", "float64"):
        data, sr = _NATIVE_DECODER(fname)
        return _convert_dtype(data, dtype) if data.dtype != np.dtype(dtype) else data, sr
    if _sf is not None:
        return _sf.read(fname, dtype=dtype)
    with open(fname, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        from .flac import read_flac

        return read_flac(fname, dtype=dtype)
    if magic == b"RIFF":
        return read_wav(fname, dtype=dtype)
    if magic == b"FORM":
        from .aiff import read_aiff

        return read_aiff(fname, dtype=dtype)
    if magic == b".snd":
        from .au import read_au

        return read_au(fname, dtype=dtype)
    if magic in (b"RF64", b"BW64"):
        from .wav64 import read_rf64

        return read_rf64(fname, dtype=dtype)
    if magic == b"riff":  # Sony Wave64 GUID starts with lowercase fourcc
        from .wav64 import read_w64

        return read_w64(fname, dtype=dtype)
    if magic == b"caff":
        from .caf import read_caf

        return read_caf(fname, dtype=dtype)
    if magic == b"OggS":
        return _read_ogg(fname, dtype)
    if magic[:3] == b"ID3":
        # ID3v2 tags are not MP3-specific: common tagging tools prepend them
        # to FLAC files too (libsndfile skips the tag; code-review r5).
        # Dispatch on what FOLLOWS the tag; mpg123 skips ID3 itself, so the
        # MP3 route needs no offset.
        with open(fname, "rb") as f:
            head = f.read(10)
            if len(head) == 10:
                # Synchsafe 28-bit size + optional 10-byte footer (flag 0x10).
                size = (
                    (head[6] & 0x7F) << 21 | (head[7] & 0x7F) << 14
                    | (head[8] & 0x7F) << 7 | (head[9] & 0x7F)
                )
                tag_end = 10 + size + (10 if head[5] & 0x10 else 0)
                f.seek(tag_end)
                post = f.read(4)
                if post == b"fLaC":
                    from .flac import read_flac

                    return read_flac(fname, dtype=dtype, offset=tag_end)
        from .mp3 import read_mp3

        return read_mp3(fname, dtype=dtype)
    if len(magic) >= 2 and magic[0] == 0xFF and (magic[1] & 0xE0) == 0xE0:
        from .mp3 import read_mp3

        return read_mp3(fname, dtype=dtype)
    raise ValueError(
        f"Unsupported audio format in {fname} (built-in codecs: WAV, "
        f"RF64/BW64, Wave64, FLAC, AIFF/AIFC, AU, CAF, Ogg Vorbis, Ogg Opus, "
        f"MP3; install soundfile for other libsndfile formats)"
    )


def _read_ogg(fname: str, dtype: str) -> Tuple[np.ndarray, int]:
    """Dispatch an Ogg container by its first packet's codec signature."""
    with open(fname, "rb") as f:
        head = f.read(1024)
    n_segs = head[26] if len(head) > 26 else 0
    first_packet = head[27 + n_segs : 27 + n_segs + 8]
    if first_packet.startswith(b"OpusHead"):
        from .opusogg import read_ogg_opus

        return read_ogg_opus(fname, dtype=dtype)
    if first_packet[:7] == b"\x01vorbis":
        from .vorbis import read_ogg_vorbis

        return read_ogg_vorbis(fname, dtype=dtype)
    if first_packet[:5] == b"\x7fFLAC":
        from .flac import read_ogg_flac

        return read_ogg_flac(fname, dtype=dtype)
    raise ValueError(f"Unrecognized Ogg codec in {fname}")


def load_audio(fname: str, sample_rate: int, channels: int, dtype: str = "float32") -> np.ndarray:
    """Load and preprocess one audio file (reference semantics: fad.py:133-161).

    Decode -> (reference's integer renormalization quirk) -> mono-mix ->
    resample to ``sample_rate``.
    """
    wav_data, sr = sf_read(fname, dtype=dtype)

    # Normalize integer audio to [-1.0, +1.0] (reference: fad.py:147-151; note
    # for the default float32 path this is a no-op, preserved for parity).
    if dtype == "int16":
        wav_data = wav_data / 32768.0
    elif dtype == "int32":
        wav_data = wav_data / float(2 ** 31)

    # Convert to mono if needed (reference: fad.py:153-155 — the rank-vs-channels
    # comparison quirk is preserved verbatim as behavioral spec).
    if len(wav_data.shape) > channels:
        wav_data = np.mean(wav_data, axis=1)

    if sr != sample_rate:
        wav_data = resample(wav_data, sr, sample_rate)

    return wav_data


def list_audio_files(directory: str) -> List[str]:
    """Non-hidden files of a directory (reference: fad.py:570)."""
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
