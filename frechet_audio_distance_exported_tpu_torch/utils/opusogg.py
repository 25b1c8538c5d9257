"""Ogg Opus codec: own Ogg demuxer + the system libopus (ctypes).

The port's copy of frechet_audio_distance_exported_tpu/utils/opusogg.py (L1-326);
the code after this docstring is verbatim. The port never imports the JAX package.

The reference reads any libsndfile-supported format through soundfile
(reference: fad.py:145), which includes Ogg Opus. Here the Ogg container
layer (RFC 3533) is parsed in pure Python/NumPy — it is simple framing —
and the Opus payload (RFC 6716/7845) is decoded by the system
``libopus``. The test/tooling encoder muxes through ``libogg`` (shared
ctypes structs from vorbis.py) after encoding with libopus.

Conventions match the sibling codecs: float32 native output in [-1, 1],
mono → [n], stereo → [n, 2]. Opus always decodes at 48 kHz (libsndfile
reports Ogg Opus files as 48 kHz likewise); RFC 7845 pre-skip and
end-trimming are applied, so encode → decode round trips to the exact
sample count. Channel-mapping family 0 (mono/stereo single stream) is
supported — families 1+ (surround multistream) raise a clear error.
"""

from __future__ import annotations

import ctypes
import struct
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

from ._clib import load_library

OPUS_SAMPLE_RATE = 48000
_OPUS_APPLICATION_AUDIO = 2049
_OPUS_GET_LOOKAHEAD = 4027
_MAX_FRAME = 5760  # 120 ms @ 48 kHz, the largest legal Opus frame


@lru_cache(maxsize=1)
def _opus() -> Optional[ctypes.CDLL]:
    lib = load_library("libopus.so.0", "libopus.so", "opus")
    if lib is None:
        return None
    lib.opus_decoder_create.restype = ctypes.c_void_p
    lib.opus_decoder_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
    lib.opus_decode_float.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.opus_packet_get_nb_samples.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    # opus_encoder_ctl is variadic; the request used here passes one pointer.
    # This fixed declaration matches the SysV/AAPCS64 Linux ABIs (variadic
    # and fixed args share registers); Darwin/arm64 would need libffi's
    # variadic support instead — out of scope for this TPU-Linux target.
    lib.opus_encoder_ctl.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.opus_encoder_create.restype = ctypes.c_void_p
    lib.opus_encoder_create.argtypes = [
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
    lib.opus_encode_float.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    return lib


@lru_cache(maxsize=1)
def _ogg_mux_available() -> bool:
    from .vorbis import _ogg

    return _ogg() is not None


def have_opus() -> bool:
    """True when Ogg Opus decode is available."""
    return _opus() is not None


def have_opus_encoder() -> bool:
    """True when Ogg Opus encode is available (tests/tooling)."""
    return _opus() is not None and _ogg_mux_available()


def ogg_packets(raw: bytes) -> Tuple[List[bytes], int]:
    """Demux a single-stream Ogg byte string (RFC 3533).

    Returns (packets, final_granulepos). Packets spanning pages are
    reassembled via the 255-lacing-value continuation rule; a truncated
    final packet (no terminating lacing value) is dropped, as liboggz
    does. Grouped/chained multi-stream files use the serial number of
    the first BOS page and ignore other streams.
    """
    packets: List[bytes] = []
    partial = bytearray()
    serial: Optional[int] = None
    final_granule = -1
    pos, n = 0, len(raw)
    while pos + 27 <= n:
        if raw[pos : pos + 4] != b"OggS":
            # Resync: scan for the next capture pattern (robustness to
            # garbage between pages, mirroring libogg's sync layer).
            nxt = raw.find(b"OggS", pos + 1)
            if nxt < 0:
                break
            pos = nxt
            continue
        header_type = raw[pos + 5]
        (granule,) = struct.unpack_from("<q", raw, pos + 6)
        (page_serial,) = struct.unpack_from("<I", raw, pos + 14)
        n_segs = raw[pos + 26]
        seg_table = raw[pos + 27 : pos + 27 + n_segs]
        body_start = pos + 27 + n_segs
        body_len = sum(seg_table)
        if body_start + body_len > n:
            break  # truncated final page
        if serial is None and (header_type & 0x02):  # first BOS page wins
            serial = page_serial
        if serial is not None and page_serial != serial:
            pos = body_start + body_len
            continue
        if not (header_type & 0x01):
            partial = bytearray()  # page does NOT continue a packet
        off = body_start
        for lacing in seg_table:
            partial += raw[off : off + lacing]
            off += lacing
            if lacing < 255:  # packet terminator
                packets.append(bytes(partial))
                partial = bytearray()
        if granule >= 0:
            final_granule = granule
        pos = body_start + body_len
    return packets, final_granule


def _parse_opus_head(packet: bytes, path: str) -> Tuple[int, int, float]:
    """Parse an OpusHead packet (RFC 7845 §5.1) → (channels, pre_skip, gain)."""
    if len(packet) < 19 or packet[:8] != b"OpusHead":
        raise ValueError(f"Missing OpusHead packet in Ogg stream: {path}")
    channels = packet[9]
    (pre_skip,) = struct.unpack_from("<H", packet, 10)
    (output_gain_q8,) = struct.unpack_from("<h", packet, 16)
    mapping_family = packet[18]
    if mapping_family != 0:
        raise ValueError(
            f"Ogg Opus channel-mapping family {mapping_family} (surround "
            f"multistream) is not supported: {path}"
        )
    gain = float(10.0 ** (output_gain_q8 / (20.0 * 256.0)))
    return int(channels), int(pre_skip), gain


def read_ogg_opus(path: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Decode an Ogg Opus file; returns (data, 48000)."""
    lib = _opus()
    if lib is None:
        raise RuntimeError(
            "Ogg Opus decode requires libopus (not found); install libopus "
            "or the soundfile package"
        )
    with open(path, "rb") as f:
        raw = f.read()
    packets, final_granule = ogg_packets(raw)
    if not packets:
        raise ValueError(f"No Ogg packets found in {path}")
    channels, pre_skip, gain = _parse_opus_head(packets[0], path)
    # packets[1] is OpusTags (metadata); audio starts at packets[2].
    err = ctypes.c_int(0)
    dec = ctypes.c_void_p(
        lib.opus_decoder_create(OPUS_SAMPLE_RATE, channels, ctypes.byref(err))
    )
    if err.value != 0 or not dec.value:
        raise RuntimeError(f"opus_decoder_create failed: {err.value}")
    try:
        pcm = np.empty((_MAX_FRAME * channels,), np.float32)
        pcm_ptr = pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        chunks = []
        for packet in packets[2:]:
            got = lib.opus_decode_float(dec, packet, len(packet), pcm_ptr, _MAX_FRAME, 0)
            if got < 0:
                # Corrupt packet: decode packet-loss concealment for its
                # nominal duration (opusfile's OP_HOLE path) — dropping it
                # would shift the timeline and break the granule-based trim.
                dur = lib.opus_packet_get_nb_samples(packet, len(packet), OPUS_SAMPLE_RATE)
                if dur <= 0:
                    dur = OPUS_SAMPLE_RATE // 50  # undecodable TOC: assume 20 ms
                got = lib.opus_decode_float(dec, None, 0, pcm_ptr, dur, 0)
                if got < 0:
                    continue
            chunks.append(pcm[: got * channels].reshape(got, channels).copy())
    finally:
        lib.opus_decoder_destroy(dec)
    data = (
        np.concatenate(chunks) if chunks else np.zeros((0, channels), np.float32)
    )
    # RFC 7845 §4.2: granule positions count 48 kHz samples including
    # pre-skip; trim the head by pre_skip and the tail to the final page's
    # granule position.
    if final_granule >= 0:
        total = max(final_granule - pre_skip, 0)
    else:
        total = max(len(data) - pre_skip, 0)
    data = data[pre_skip : pre_skip + total]
    if gain != 1.0:
        data = data * np.float32(gain)
    if channels == 1:
        data = data[:, 0]
    from .audio_io import _convert_dtype

    return _convert_dtype(data, dtype), OPUS_SAMPLE_RATE


def write_ogg_opus(path: str, data: np.ndarray, sample_rate: int = 48000) -> None:
    """Encode float PCM in [-1, 1] to an Ogg Opus file (tests/tooling).

    ``sample_rate`` must be an Opus-native rate (8/12/16/24/48 kHz); the
    stream still decodes at 48 kHz per the Opus design.
    """
    lib = _opus()
    if lib is None or not _ogg_mux_available():
        raise RuntimeError("Ogg Opus encode requires libopus + libogg (not found)")
    if sample_rate not in (8000, 12000, 16000, 24000, 48000):
        raise ValueError(f"Opus supports 8/12/16/24/48 kHz input, got {sample_rate}")
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    frames, channels = data.shape
    if channels > 2:
        raise ValueError(f"Channel-mapping family 0 supports <= 2 channels, got {channels}")

    from .vorbis import OggPacket, OggPage, _ogg

    ogg = _ogg()
    err = ctypes.c_int(0)
    enc = ctypes.c_void_p(
        lib.opus_encoder_create(sample_rate, channels, _OPUS_APPLICATION_AUDIO, ctypes.byref(err))
    )
    if err.value != 0 or not enc.value:
        raise RuntimeError(f"opus_encoder_create failed: {err.value}")
    stream = ctypes.create_string_buffer(4096)
    ogg.ogg_stream_init(stream, 0x0B05)
    try:
        lookahead = ctypes.c_int(0)
        lib.opus_encoder_ctl(enc, _OPUS_GET_LOOKAHEAD, ctypes.byref(lookahead))
        pre_skip_48k = lookahead.value * (OPUS_SAMPLE_RATE // sample_rate)

        out = bytearray()
        page = OggPage()

        def flush_pages(force: bool) -> None:
            fn = ogg.ogg_stream_flush if force else ogg.ogg_stream_pageout
            while fn(stream, ctypes.byref(page)):
                out.extend(ctypes.string_at(page.header, page.header_len))
                out.extend(ctypes.string_at(page.body, page.body_len))

        def packetin(payload: bytes, packetno: int, granule: int, bos: bool, eos: bool) -> None:
            buf = (ctypes.c_ubyte * max(len(payload), 1)).from_buffer_copy(
                payload or b"\x00"
            )
            op = OggPacket(
                packet=ctypes.cast(buf, ctypes.POINTER(ctypes.c_ubyte)),
                bytes=len(payload),
                b_o_s=1 if bos else 0,
                e_o_s=1 if eos else 0,
                granulepos=granule,
                packetno=packetno,
            )
            ogg.ogg_stream_packetin(stream, ctypes.byref(op))

        head = (
            b"OpusHead"
            + struct.pack("<BBHIhB", 1, channels, pre_skip_48k, sample_rate, 0, 0)
        )
        vendor = b"fad-tpu"
        tags = b"OpusTags" + struct.pack("<I", len(vendor)) + vendor + struct.pack("<I", 0)
        packetin(head, 0, 0, bos=True, eos=False)
        flush_pages(force=True)  # OpusHead must be alone on the first page
        packetin(tags, 1, 0, bos=False, eos=False)
        flush_pages(force=True)  # header pages precede audio pages

        frame = sample_rate // 50  # 20 ms frames
        # Encode at least `lookahead` extra zero samples so the encoder's
        # delay line is flushed — otherwise the tail of the signal never
        # leaves the encoder and the decoded stream comes up short.
        total_padded = ((frames + lookahead.value + frame - 1) // frame) * frame
        padded = np.zeros((total_padded, channels), np.float32)
        padded[:frames] = data
        granule = pre_skip_48k
        final_granule = pre_skip_48k + frames * (OPUS_SAMPLE_RATE // sample_rate)
        outbuf = ctypes.create_string_buffer(4000)  # max recommended packet
        packetno = 2
        for start in range(0, total_padded, frame):
            block = np.ascontiguousarray(padded[start : start + frame])
            n = lib.opus_encode_float(
                enc,
                block.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                frame,
                outbuf,
                len(outbuf),
            )
            if n < 0:
                raise ValueError(f"opus_encode_float failed: {n}")
            last = start + frame >= total_padded
            granule += frame * (OPUS_SAMPLE_RATE // sample_rate)
            # The final page's granule position encodes the true length so
            # decoders trim the zero padding (RFC 7845 §4.2).
            packetin(
                outbuf.raw[:n], packetno, final_granule if last else granule,
                bos=False, eos=last,
            )
            packetno += 1
            flush_pages(force=False)
        flush_pages(force=True)
        with open(path, "wb") as f:
            f.write(bytes(out))
    finally:
        ogg.ogg_stream_clear(stream)
        lib.opus_encoder_destroy(enc)
