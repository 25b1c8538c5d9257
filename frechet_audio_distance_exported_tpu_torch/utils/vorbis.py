"""Ogg Vorbis codec via the system Xiph libraries (ctypes, no pip deps).

The port's copy of frechet_audio_distance_exported_tpu/utils/vorbis.py (L1-266);
the code after this docstring is verbatim. The port never imports the JAX package.

The reference reads .ogg through soundfile/libsndfile (reference:
fad.py:145); this module provides the same capability by binding
``libvorbisfile`` (decode) and ``libvorbisenc``/``libvorbis``/``libogg``
(encode, used by tests and tools to author fixtures). All entry points
raise ``RuntimeError`` with an actionable message when the libraries are
absent; ``have_vorbis()``/``have_vorbis_encoder()`` let callers gate.

Decoded output follows the libsndfile/soundfile conventions used by the
sibling codecs (wav/flac/aiff/au): float32 in [-1, 1] (Vorbis is
float-native; values may slightly exceed fullscale on hot signals, as
with libsndfile), mono → [n], multichannel → [n, ch].
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from ._clib import load_library

# Opaque Xiph structs are allocated as oversized byte buffers: their real
# sizes (x86-64) are OggVorbis_File ~944, ogg_stream_state ~408,
# vorbis_dsp_state ~120, vorbis_block ~192 bytes. 4 KiB leaves headroom
# across library versions without mattering for a per-file allocation.
_OPAQUE_BYTES = 4096

_OV_EREAD = -128  # canonical libvorbisfile error codes (vorbisfile.h)
_OV_ENOTVORBIS = -132


class _VorbisInfo(ctypes.Structure):
    # codec.h: vorbis_info — only version/channels/rate are read here.
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
        ("bitrate_upper", ctypes.c_long),
        ("bitrate_nominal", ctypes.c_long),
        ("bitrate_lower", ctypes.c_long),
        ("bitrate_window", ctypes.c_long),
        ("codec_setup", ctypes.c_void_p),
    ]


class OggPacket(ctypes.Structure):
    # ogg/ogg.h: ogg_packet (shared with the Opus muxer in opusogg.py).
    _fields_ = [
        ("packet", ctypes.POINTER(ctypes.c_ubyte)),
        ("bytes", ctypes.c_long),
        ("b_o_s", ctypes.c_long),
        ("e_o_s", ctypes.c_long),
        ("granulepos", ctypes.c_int64),
        ("packetno", ctypes.c_int64),
    ]


class OggPage(ctypes.Structure):
    # ogg/ogg.h: ogg_page.
    _fields_ = [
        ("header", ctypes.POINTER(ctypes.c_ubyte)),
        ("header_len", ctypes.c_long),
        ("body", ctypes.POINTER(ctypes.c_ubyte)),
        ("body_len", ctypes.c_long),
    ]


@lru_cache(maxsize=1)
def _vorbisfile() -> Optional[ctypes.CDLL]:
    lib = load_library("libvorbisfile.so.3", "libvorbisfile.so", "vorbisfile")
    if lib is None:
        return None
    lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.ov_fopen.restype = ctypes.c_int
    lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ov_info.restype = ctypes.POINTER(_VorbisInfo)
    lib.ov_pcm_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ov_pcm_total.restype = ctypes.c_int64
    lib.ov_read_float.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.POINTER(ctypes.c_float))),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.ov_read_float.restype = ctypes.c_long
    lib.ov_clear.argtypes = [ctypes.c_void_p]
    return lib


@lru_cache(maxsize=1)
def _ogg() -> Optional[ctypes.CDLL]:
    return load_library("libogg.so.0", "libogg.so", "ogg")


@lru_cache(maxsize=1)
def _vorbis() -> Optional[ctypes.CDLL]:
    lib = load_library("libvorbis.so.0", "libvorbis.so", "vorbis")
    if lib is None:
        return None
    lib.vorbis_analysis_buffer.restype = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
    lib.vorbis_analysis_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


@lru_cache(maxsize=1)
def _vorbisenc() -> Optional[ctypes.CDLL]:
    if _ogg() is None or _vorbis() is None:  # encoder needs all three
        return None
    lib = load_library("libvorbisenc.so.2", "libvorbisenc.so", "vorbisenc")
    if lib is None:
        return None
    lib.vorbis_encode_init_vbr.argtypes = [
        ctypes.c_void_p,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_float,
    ]
    lib.vorbis_encode_init_vbr.restype = ctypes.c_int
    return lib


def have_vorbis() -> bool:
    """True when Ogg Vorbis decode is available."""
    return _vorbisfile() is not None


def have_vorbis_encoder() -> bool:
    """True when Ogg Vorbis encode is available (tests/tooling)."""
    return _vorbisenc() is not None


def read_ogg_vorbis(path: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Decode an Ogg Vorbis file; returns (data, sample_rate)."""
    lib = _vorbisfile()
    if lib is None:
        raise RuntimeError(
            "Ogg Vorbis decode requires libvorbisfile (not found); install "
            "libvorbis or the soundfile package"
        )
    vf = ctypes.create_string_buffer(_OPAQUE_BYTES)
    rc = lib.ov_fopen(path.encode(), vf)
    if rc != 0:
        kind = "not a Vorbis stream" if rc == _OV_ENOTVORBIS else f"error {rc}"
        raise ValueError(f"Cannot open Ogg Vorbis file ({kind}): {path}")
    try:
        info = lib.ov_info(vf, -1).contents
        channels, rate = int(info.channels), int(info.rate)
        total = int(lib.ov_pcm_total(vf, -1))  # -1 on unseekable; only a hint
        pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        bitstream = ctypes.c_int(0)
        chunks = []
        while True:
            n = int(lib.ov_read_float(vf, ctypes.byref(pcm), 65536, ctypes.byref(bitstream)))
            if n == 0:
                break
            if n < 0:  # OV_HOLE / OV_EBADLINK: skip the corrupt section
                continue
            frame = np.empty((n, channels), np.float32)
            for c in range(channels):
                frame[:, c] = np.ctypeslib.as_array(pcm[c], shape=(n,))
            chunks.append(frame)
    finally:
        lib.ov_clear(vf)
    if chunks:
        data = np.concatenate(chunks)
    else:
        data = np.zeros((0, channels), np.float32)
    if total >= 0 and len(data) > total:
        data = data[:total]
    if channels == 1:
        data = data[:, 0]
    from .audio_io import _convert_dtype

    return _convert_dtype(data, dtype), rate


def write_ogg_vorbis(
    path: str, data: np.ndarray, sample_rate: int, quality: float = 0.6
) -> None:
    """Encode float PCM in [-1, 1] to an Ogg Vorbis file (VBR).

    Minimal encoder used by tests and tools to author fixtures; the
    canonical Xiph analysis/packet/page flow.
    """
    ogg, vorbis, venc = _ogg(), _vorbis(), _vorbisenc()
    if venc is None:
        raise RuntimeError(
            "Ogg Vorbis encode requires libvorbisenc/libvorbis/libogg (not found)"
        )
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    frames, channels = data.shape

    vi = ctypes.create_string_buffer(_OPAQUE_BYTES)
    vc = ctypes.create_string_buffer(_OPAQUE_BYTES)
    vd = ctypes.create_string_buffer(_OPAQUE_BYTES)
    vb = ctypes.create_string_buffer(_OPAQUE_BYTES)
    stream = ctypes.create_string_buffer(_OPAQUE_BYTES)

    vorbis.vorbis_info_init(vi)
    try:
        rc = venc.vorbis_encode_init_vbr(vi, channels, sample_rate, ctypes.c_float(quality))
        if rc != 0:
            raise ValueError(
                f"vorbis_encode_init_vbr failed (rc={rc}) for channels={channels}, "
                f"rate={sample_rate}, quality={quality}"
            )
        vorbis.vorbis_comment_init(vc)
        vorbis.vorbis_analysis_init(vd, vi)
        vorbis.vorbis_block_init(vd, vb)
        ogg.ogg_stream_init(stream, 0xFAD)

        out = bytearray()
        page = OggPage()

        def flush_pages(force: bool) -> None:
            fn = ogg.ogg_stream_flush if force else ogg.ogg_stream_pageout
            while fn(stream, ctypes.byref(page)):
                out.extend(ctypes.string_at(page.header, page.header_len))
                out.extend(ctypes.string_at(page.body, page.body_len))

        hdr, hdr_comm, hdr_code = OggPacket(), OggPacket(), OggPacket()
        vorbis.vorbis_analysis_headerout(
            vd, vc, ctypes.byref(hdr), ctypes.byref(hdr_comm), ctypes.byref(hdr_code)
        )
        for packet in (hdr, hdr_comm, hdr_code):
            ogg.ogg_stream_packetin(stream, ctypes.byref(packet))
        flush_pages(force=True)  # audio data must start on a fresh page

        op = OggPacket()

        def drain_analysis() -> None:
            while vorbis.vorbis_analysis_blockout(vd, vb) == 1:
                vorbis.vorbis_analysis(vb, None)
                vorbis.vorbis_bitrate_addblock(vb)
                while vorbis.vorbis_bitrate_flushpacket(vd, ctypes.byref(op)) == 1:
                    ogg.ogg_stream_packetin(stream, ctypes.byref(op))
                    flush_pages(force=False)

        pos = 0
        while pos < frames:
            chunk = min(4096, frames - pos)
            buf = vorbis.vorbis_analysis_buffer(vd, chunk)
            block = np.ascontiguousarray(data[pos : pos + chunk].T)  # [ch, chunk]
            for c in range(channels):
                ctypes.memmove(buf[c], block[c].ctypes.data, chunk * 4)
            vorbis.vorbis_analysis_wrote(vd, chunk)
            drain_analysis()
            pos += chunk
        vorbis.vorbis_analysis_wrote(vd, 0)  # end-of-stream marker
        drain_analysis()
        flush_pages(force=True)

        with open(path, "wb") as f:
            f.write(bytes(out))
    finally:
        ogg.ogg_stream_clear(stream)
        vorbis.vorbis_block_clear(vb)
        vorbis.vorbis_dsp_clear(vd)
        vorbis.vorbis_comment_clear(vc)
        vorbis.vorbis_info_clear(vi)
