"""MP3 codec via the system mpg123/LAME libraries (ctypes, no pip deps).

The port's copy of frechet_audio_distance_exported_tpu/utils/mp3.py (L1-253);
the code after this docstring is verbatim. The port never imports the JAX package.

The reference reads any libsndfile-supported format through soundfile
(reference: fad.py:145); libsndfile >= 1.1 includes MP3 (via libmpg123 /
libmp3lame), and so does this module: ``read_mp3`` binds ``libmpg123``
for decode, ``write_mp3`` binds ``libmp3lame`` for encode (tests and
tools). ``have_mp3()``/``have_mp3_encoder()`` let callers gate.

Decode conventions match the sibling codecs: float32 native output in
[-1, 1], mono → [n], stereo → [n, 2]. Gapless playback info (the LAME
info tag) is honored by mpg123, so ``write_mp3`` → ``read_mp3`` round
trips to the exact sample count.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from ._clib import load_library

_MPG123_OK = 0
_MPG123_NEED_MORE = -10
_MPG123_NEW_FORMAT = -11
_MPG123_DONE = -12
_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_MONO_STEREO = 0x3  # MPG123_MONO | MPG123_STEREO


@lru_cache(maxsize=1)
def _mpg123() -> Optional[ctypes.CDLL]:
    lib = load_library("libmpg123.so.0", "libmpg123.so", "mpg123")
    if lib is None:
        return None
    lib.mpg123_init()  # no-op on modern versions, required by older ones
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.mpg123_rates.argtypes = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_long)),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mpg123_read.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_plain_strerror.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=1)
def _lame() -> Optional[ctypes.CDLL]:
    lib = load_library("libmp3lame.so.0", "libmp3lame.so", "mp3lame")
    if lib is None:
        return None
    lib.lame_init.restype = ctypes.c_void_p
    for fname in (
        "lame_set_in_samplerate",
        "lame_set_num_channels",
        "lame_set_mode",
        "lame_set_brate",
        "lame_set_bWriteVbrTag",
        "lame_init_params",
        "lame_close",
    ):
        getattr(lib, fname).argtypes = [ctypes.c_void_p] + (
            [ctypes.c_int] if fname.startswith("lame_set") else []
        )
    lib.lame_encode_buffer_ieee_float.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.lame_get_lametag_frame.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.lame_get_lametag_frame.restype = ctypes.c_size_t
    return lib


def have_mp3() -> bool:
    """True when MP3 decode is available."""
    return _mpg123() is not None


def have_mp3_encoder() -> bool:
    """True when MP3 encode is available (tests/tooling)."""
    return _lame() is not None


def read_mp3(path: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Decode an MPEG audio file; returns (data, sample_rate)."""
    lib = _mpg123()
    if lib is None:
        raise RuntimeError(
            "MP3 decode requires libmpg123 (not found); install mpg123 or "
            "the soundfile package (libsndfile >= 1.1)"
        )
    err = ctypes.c_int(0)
    handle = ctypes.c_void_p(lib.mpg123_new(None, ctypes.byref(err)))
    if not handle.value:
        raise RuntimeError(f"mpg123_new failed: {err.value}")
    try:
        # Pin the output format to float32 for every MPEG rate BEFORE open —
        # format restrictions only apply at stream (re)scan time.
        rates = ctypes.POINTER(ctypes.c_long)()
        n_rates = ctypes.c_size_t(0)
        lib.mpg123_rates(ctypes.byref(rates), ctypes.byref(n_rates))
        lib.mpg123_format_none(handle)
        for i in range(n_rates.value):
            lib.mpg123_format(handle, rates[i], _MPG123_MONO_STEREO, _MPG123_ENC_FLOAT_32)

        rc = lib.mpg123_open(handle, path.encode())
        if rc != _MPG123_OK:
            raise ValueError(f"Cannot open MP3 file (mpg123 error {rc}): {path}")
        try:
            rate = ctypes.c_long(0)
            channels = ctypes.c_int(0)
            encoding = ctypes.c_int(0)
            rc = lib.mpg123_getformat(
                handle, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding)
            )
            if rc != _MPG123_OK or encoding.value != _MPG123_ENC_FLOAT_32:
                raise ValueError(f"Cannot negotiate float MP3 decode for {path}")

            buf = ctypes.create_string_buffer(1 << 18)
            done = ctypes.c_size_t(0)
            chunks = []
            while True:
                rc = lib.mpg123_read(handle, buf, len(buf), ctypes.byref(done))
                if done.value:
                    # string_at copies only the produced bytes (buf.raw would
                    # materialize the whole 256 KiB buffer every iteration).
                    chunks.append(
                        np.frombuffer(ctypes.string_at(buf, done.value), np.float32)
                    )
                if rc == _MPG123_DONE:
                    break
                if rc == _MPG123_NEW_FORMAT:
                    # Mid-stream format change ("Frankenstein" concatenated
                    # streams): silently continuing would misinterleave
                    # channels and mislabel the rate. Refresh and reject any
                    # actual change.
                    new_rate = ctypes.c_long(0)
                    new_ch = ctypes.c_int(0)
                    new_enc = ctypes.c_int(0)
                    lib.mpg123_getformat(
                        handle,
                        ctypes.byref(new_rate),
                        ctypes.byref(new_ch),
                        ctypes.byref(new_enc),
                    )
                    if (new_rate.value, new_ch.value) != (rate.value, channels.value):
                        raise ValueError(
                            f"MP3 stream changes format mid-file "
                            f"({rate.value} Hz/{channels.value}ch -> "
                            f"{new_rate.value} Hz/{new_ch.value}ch): {path}"
                        )
                    continue
                if rc not in (_MPG123_OK, _MPG123_NEED_MORE):
                    msg = lib.mpg123_plain_strerror(rc)
                    raise ValueError(
                        f"MP3 decode error in {path}: "
                        f"{msg.decode() if msg else rc}"
                    )
        finally:
            lib.mpg123_close(handle)
    finally:
        lib.mpg123_delete(handle)

    data = np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)
    if channels.value > 1:
        frames = data.shape[0] // channels.value
        data = data[: frames * channels.value].reshape(frames, channels.value)
    from .audio_io import _convert_dtype

    return _convert_dtype(data, dtype), int(rate.value)


def write_mp3(path: str, data: np.ndarray, sample_rate: int, bitrate_kbps: int = 192) -> None:
    """Encode float PCM in [-1, 1] to a CBR MP3 with a LAME gapless tag.

    Minimal encoder used by tests and tools to author fixtures.
    """
    lib = _lame()
    if lib is None:
        raise RuntimeError("MP3 encode requires libmp3lame (not found)")
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    frames, channels = data.shape
    if channels > 2:
        raise ValueError(f"MP3 supports at most 2 channels, got {channels}")

    gfp = ctypes.c_void_p(lib.lame_init())
    if not gfp.value:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gfp, sample_rate)
        lib.lame_set_num_channels(gfp, channels)
        lib.lame_set_mode(gfp, 3 if channels == 1 else 1)  # MONO / JOINT_STEREO
        lib.lame_set_brate(gfp, bitrate_kbps)
        lib.lame_set_bWriteVbrTag(gfp, 1)  # gapless info tag
        if lib.lame_init_params(gfp) < 0:
            raise ValueError(
                f"lame_init_params rejected rate={sample_rate}, "
                f"channels={channels}, bitrate={bitrate_kbps}"
            )

        left = np.ascontiguousarray(data[:, 0])
        right = np.ascontiguousarray(data[:, 1] if channels == 2 else data[:, 0])
        out = ctypes.create_string_buffer(int(1.25 * frames) + 7200)
        n = lib.lame_encode_buffer_ieee_float(
            gfp,
            left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            frames,
            out,
            len(out),
        )
        if n < 0:
            raise ValueError(f"lame_encode_buffer failed: {n}")
        payload = bytearray(out.raw[:n])
        flush = ctypes.create_string_buffer(7200)
        n = lib.lame_encode_flush(gfp, flush, len(flush))
        payload += flush.raw[:n]
        # Overwrite the placeholder first frame with the finalized LAME tag
        # (encoder delay/padding) so decoders trim to the exact length.
        tag = ctypes.create_string_buffer(8192)
        tag_len = lib.lame_get_lametag_frame(gfp, tag, len(tag))
        if 0 < tag_len <= len(payload):
            payload[:tag_len] = tag.raw[:tag_len]
        with open(path, "wb") as f:
            f.write(bytes(payload))
    finally:
        lib.lame_close(gfp)
