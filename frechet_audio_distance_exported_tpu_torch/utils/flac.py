"""Self-contained FLAC codec (decoder + minimal encoder).

The port's copy of frechet_audio_distance_exported_tpu/utils/flac.py (L1-668);
the code after this docstring is verbatim. The port never imports the JAX package.

The reference reads any libsndfile-supported format via soundfile
(reference: fad.py:145); FLAC is the most common lossless format after WAV.
soundfile is unavailable in minimal installs, so this module implements the
FLAC format directly (spec: https://xiph.org/flac/format.html):

Decoder (`read_flac`) — full feature coverage for decoding real-world files:
- STREAMINFO + metadata block skipping
- frame headers: all block-size/sample-rate/bit-depth codes, UTF-8 coded
  frame/sample numbers, fixed and variable blocking strategies
- subframes: CONSTANT, VERBATIM, FIXED (orders 0-4), LPC (orders 1-32),
  wasted bits
- residuals: 4-bit RICE and 5-bit RICE2 partitioned coding incl. escape codes
- stereo decorrelation: left/side, right/side, mid/side
- bit depths 8/12/16/20/24/32, any channel count for independent frames

Encoder (`write_flac`) — a correct, simple subset used by tests and tools:
fixed 4096-sample blocks, independent channels, per-subframe best FIXED
predictor (order 0-2) with single-partition Rice residuals, CRC-8/CRC-16
footers. Output decodes with any conformant FLAC decoder.

Performance: the per-sample hot loops (partitioned-Rice residual decode and
FIXED/LPC reconstruction) run in the native C library (native/fad_native.cpp,
built on first use) — these also release the GIL inside ctypes calls, so
audio_io's ThreadPool gets real overlap across files. Without a compiler the
pure-Python fallbacks below are used: correct but slow (~1 us per residual;
seconds per minute of LPC-coded audio) and GIL-serialized.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

FLAC_MAGIC = b"fLaC"

_BLOCKSIZE_CODES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
    13: 8192, 14: 16384, 15: 32768,
}
_SAMPLE_RATE_CODES = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}
_SAMPLE_SIZE_CODES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


# ---------------------------------------------------------------------------
# Bit reader
# ---------------------------------------------------------------------------


class _BitReader:
    """MSB-first bit reader over bytes with an int accumulator."""

    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data: bytes, byte_pos: int = 0):
        self.data = data
        self.pos = byte_pos
        self.acc = 0
        self.nbits = 0

    def _fill(self, need: int) -> None:
        while self.nbits < need:
            # Pull up to 8 bytes at a time.
            take = min(8, len(self.data) - self.pos)
            if take <= 0:
                raise EOFError("FLAC bitstream truncated")
            chunk = self.data[self.pos : self.pos + take]
            self.pos += take
            self.acc = (self.acc << (8 * take)) | int.from_bytes(chunk, "big")
            self.nbits += 8 * take

    def read_uint(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill(n)
        self.nbits -= n
        out = self.acc >> self.nbits
        self.acc &= (1 << self.nbits) - 1
        return out

    def read_sint(self, n: int) -> int:
        v = self.read_uint(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        """Count zero bits up to the terminating 1-bit."""
        count = 0
        while True:
            if self.nbits == 0:
                self._fill(1)
            if self.acc == 0:  # all buffered bits are zeros
                count += self.nbits
                self.nbits = 0
                continue
            top = self.acc.bit_length()
            zeros = self.nbits - top
            count += zeros
            # Consume the zeros and the terminating 1.
            self.nbits = top - 1
            self.acc &= (1 << self.nbits) - 1
            return count

    def align_byte(self) -> None:
        drop = self.nbits % 8
        self.nbits -= drop
        self.acc &= (1 << self.nbits) - 1

    def byte_position(self) -> int:
        return self.pos - self.nbits // 8

    def bit_position(self) -> int:
        return self.pos * 8 - self.nbits

    def seek_bit(self, bit: int) -> None:
        self.pos = bit >> 3
        self.acc = 0
        self.nbits = 0
        if bit & 7:
            self.read_uint(bit & 7)


def _read_utf8_coded(br: _BitReader) -> int:
    """FLAC's UTF-8-style frame/sample number (up to 36 bits)."""
    first = br.read_uint(8)
    if first < 0x80:
        return first
    n = 0
    mask = 0x80
    while first & mask:
        n += 1
        mask >>= 1
    if n < 2 or n > 7:
        raise ValueError("Invalid UTF-8 coded number in FLAC frame header")
    val = first & (0xFF >> (n + 1))
    for _ in range(n - 1):
        cont = br.read_uint(8)
        if (cont & 0xC0) != 0x80:
            raise ValueError("Invalid UTF-8 continuation in FLAC frame header")
        val = (val << 6) | (cont & 0x3F)
    return val


# ---------------------------------------------------------------------------
# Residual / subframe decoding
# ---------------------------------------------------------------------------

_FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _decode_residuals(br: _BitReader, block_size: int, order: int) -> np.ndarray:
    # Native fast path (C bit reader; the pure-Python loop below costs ~1 us
    # per residual). On any stream problem the C side returns None and the
    # Python path re-parses to produce the detailed error.
    from .. import native

    res = native.flac_rice_residuals(br.data, br.bit_position(), block_size, order)
    if res is not None:
        out, new_pos = res
        br.seek_bit(new_pos)
        return out
    method = br.read_uint(2)
    if method > 1:
        raise ValueError(f"Reserved FLAC residual coding method {method}")
    param_bits, escape = (4, 0xF) if method == 0 else (5, 0x1F)
    part_order = br.read_uint(4)
    n_parts = 1 << part_order
    if block_size % n_parts:
        raise ValueError(
            f"Invalid FLAC partition order {part_order} for block size {block_size}"
        )
    if (block_size >> part_order) <= order and part_order > 0:
        raise ValueError(
            f"FLAC partition too small for predictor order {order} "
            f"(block {block_size}, partition order {part_order})"
        )
    out = np.empty(block_size - order, dtype=np.int64)
    idx = 0
    for p in range(n_parts):
        n = (block_size >> part_order) - (order if p == 0 else 0)
        param = br.read_uint(param_bits)
        if param == escape:
            raw_bits = br.read_uint(5)
            for i in range(n):
                out[idx + i] = br.read_sint(raw_bits) if raw_bits else 0
        else:
            ru = br.read_unary
            rb = br.read_uint
            k = param
            for i in range(n):
                q = ru()
                v = (q << k) | rb(k) if k else q
                out[idx + i] = (v >> 1) ^ -(v & 1)  # zigzag
        idx += n
    return out


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read_uint(1):
        raise ValueError("Invalid FLAC subframe padding bit")
    sf_type = br.read_uint(6)
    wasted = 0
    if br.read_uint(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if sf_type == 0:  # CONSTANT
        out = np.full(block_size, br.read_sint(bps), dtype=np.int64)
    elif sf_type == 1:  # VERBATIM
        out = np.array([br.read_sint(bps) for _ in range(block_size)], dtype=np.int64)
    elif 8 <= sf_type <= 12:  # FIXED
        from .. import native

        order = sf_type - 8
        warm = [br.read_sint(bps) for _ in range(order)]
        res = _decode_residuals(br, block_size, order)
        if order == 0:
            out = np.ascontiguousarray(res)
        else:
            out = np.empty(block_size, dtype=np.int64)
            out[:order] = warm
            out[order:] = res
            if not native.flac_reconstruct(out, order):
                coefs = _FIXED_COEFS[order]
                for i in range(order, block_size):
                    acc = out[i]
                    for j, c in enumerate(coefs):
                        acc += c * out[i - 1 - j]
                    out[i] = acc
    elif sf_type >= 32:  # LPC
        from .. import native

        order = sf_type - 31
        warm = [br.read_sint(bps) for _ in range(order)]
        precision = br.read_uint(4) + 1
        if precision == 16:
            raise ValueError("Invalid FLAC LPC precision")
        shift = br.read_sint(5)
        if shift < 0:
            raise ValueError("Negative FLAC LPC shift")
        coefs = [br.read_sint(precision) for _ in range(order)]
        res = _decode_residuals(br, block_size, order)
        out = np.empty(block_size, dtype=np.int64)
        out[:order] = warm
        out[order:] = res
        if not native.flac_reconstruct(out, order, coefs=coefs, shift=shift):
            for i in range(order, block_size):
                acc = 0
                for j in range(order):
                    acc += int(coefs[j]) * int(out[i - 1 - j])
                out[i] += acc >> shift
    else:
        raise ValueError(f"Reserved FLAC subframe type {sf_type}")

    if wasted:
        out = out << wasted
    return out


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def read_flac(path: str, dtype: str = "float32", offset: int = 0) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file; returns (data, sample_rate) shaped like read_wav
    ([frames] mono / [frames, channels]). ``offset`` skips a leading ID3v2
    tag (audio_io.sf_read computes it; libsndfile-compatible behavior)."""
    with open(path, "rb") as f:
        raw = f.read()
    if offset:
        raw = raw[offset:]
    if raw[:4] != FLAC_MAGIC:
        raise ValueError(f"Not a FLAC file: {path}")

    pos = 4
    streaminfo = None
    while True:
        header = raw[pos : pos + 4]
        last = header[0] >> 7
        btype = header[0] & 0x7F
        size = int.from_bytes(header[1:4], "big")
        body = raw[pos + 4 : pos + 4 + size]
        if btype == 0:  # STREAMINFO
            streaminfo = body
        pos += 4 + size
        if last:
            break
    if streaminfo is None:
        raise ValueError(f"FLAC file missing STREAMINFO: {path}")

    sr, channels, bps_stream, total_samples = _parse_streaminfo(streaminfo)
    data = _decode_frame_stream(raw, pos, sr, channels, bps_stream, total_samples)
    if channels == 1:
        data = data[:, 0]
    return _to_dtype(data, bps_stream, dtype), sr


def _parse_streaminfo(streaminfo: bytes) -> Tuple[int, int, int, int]:
    """STREAMINFO body -> (sample_rate, channels, bits_per_sample, total_samples).

    Layout (bits from MSB): minbs 16, maxbs 16, minfs 24, maxfs 24 (= 80),
    sr 20, channels 3, bps 5, total 36, md5 128."""
    si = int.from_bytes(streaminfo, "big")
    bits_total = len(streaminfo) * 8
    sr = (si >> (bits_total - 100)) & 0xFFFFF
    channels = ((si >> (bits_total - 103)) & 0x7) + 1
    bps_stream = ((si >> (bits_total - 108)) & 0x1F) + 1
    total_samples = (si >> (bits_total - 144)) & ((1 << 36) - 1)
    return sr, channels, bps_stream, total_samples


def _decode_frame_stream(
    raw: bytes, pos: int, sr: int, channels: int, bps_stream: int, total_samples: int
) -> np.ndarray:
    """Decode consecutive FLAC frames from ``raw[pos:]`` -> [n, channels]."""
    br = _BitReader(raw, pos)
    blocks: List[np.ndarray] = []
    decoded = 0
    while (total_samples == 0 or decoded < total_samples) and br.byte_position() < len(raw):
        try:
            block = _decode_frame(br, sr, channels, bps_stream)
        except EOFError:
            break
        blocks.append(block)
        decoded += block.shape[0]

    data = np.concatenate(blocks, axis=0) if blocks else np.zeros((0, channels), np.int64)
    if total_samples:
        data = data[:total_samples]
    return data


def read_ogg_flac(path: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Decode an Ogg-encapsulated FLAC file (Ogg FLAC mapping 1.0).

    The first packet is ``0x7F 'FLAC' major minor nheaders(2BE)`` followed
    by a verbatim native header ('fLaC' + STREAMINFO block); each audio
    packet holds exactly one FLAC frame, so the concatenated packets decode
    with the same frame loop as a native stream.
    """
    from .opusogg import ogg_packets

    with open(path, "rb") as f:
        raw = f.read()
    packets, _ = ogg_packets(raw)
    if not packets or len(packets[0]) < 51 or packets[0][:5] != b"\x7fFLAC":
        raise ValueError(f"Not an Ogg FLAC stream: {path}")
    first = packets[0]
    (n_headers,) = struct.unpack_from(">H", first, 7)
    if first[9:13] != FLAC_MAGIC:
        raise ValueError(f"Ogg FLAC first packet missing native header: {path}")
    # 4-byte metadata block header, then the 34-byte STREAMINFO body.
    streaminfo = first[17:51]
    sr, channels, bps_stream, total_samples = _parse_streaminfo(streaminfo)
    # Skip the n_headers metadata packets (VORBIS_COMMENT etc.); when the
    # count is 0 (unknown), skip consecutive packets whose first byte is a
    # metadata block type (MSB-agnostic value != frame sync start 0xFF).
    audio_start = 1 + n_headers
    if n_headers == 0:
        audio_start = 1
        while audio_start < len(packets) and packets[audio_start][:1] != b"\xff":
            audio_start += 1
    body = b"".join(packets[audio_start:])
    data = _decode_frame_stream(body, 0, sr, channels, bps_stream, total_samples)
    if channels == 1:
        data = data[:, 0]
    return _to_dtype(data, bps_stream, dtype), sr


def _decode_frame(br: _BitReader, sr: int, channels: int, bps_stream: int) -> np.ndarray:
    br.align_byte()
    sync = br.read_uint(14)
    if sync != 0x3FFE:
        raise ValueError(f"Lost FLAC frame sync (got {sync:#x})")
    br.read_uint(1)  # reserved
    br.read_uint(1)  # blocking strategy (frame vs sample number; both UTF-8)
    bs_code = br.read_uint(4)
    sr_code = br.read_uint(4)
    ch_code = br.read_uint(4)
    ss_code = br.read_uint(3)
    br.read_uint(1)  # reserved
    _read_utf8_coded(br)

    if bs_code == 0:
        raise ValueError("Reserved FLAC block size code 0")
    elif bs_code == 6:
        block_size = br.read_uint(8) + 1
    elif bs_code == 7:
        block_size = br.read_uint(16) + 1
    else:
        block_size = _BLOCKSIZE_CODES[bs_code]

    if sr_code == 12:
        br.read_uint(8)
    elif sr_code in (13, 14):
        br.read_uint(16)
    elif sr_code == 15:
        raise ValueError("Invalid FLAC sample rate code")
    # (header sample rate is informational; STREAMINFO governs)

    bps = _SAMPLE_SIZE_CODES.get(ss_code, bps_stream) if ss_code else bps_stream
    br.read_uint(8)  # CRC-8 (not verified; sequential parse)

    if ch_code < 8:
        n_ch = ch_code + 1
        if n_ch != channels:
            raise ValueError("FLAC frame channel count differs from STREAMINFO")
        subs = [_decode_subframe(br, block_size, bps) for _ in range(n_ch)]
        out = np.stack(subs, axis=1)
    elif ch_code == 8:  # left/side
        left = _decode_subframe(br, block_size, bps)
        side = _decode_subframe(br, block_size, bps + 1)
        out = np.stack([left, left - side], axis=1)
    elif ch_code == 9:  # right/side
        side = _decode_subframe(br, block_size, bps + 1)
        right = _decode_subframe(br, block_size, bps)
        out = np.stack([right + side, right], axis=1)
    elif ch_code == 10:  # mid/side
        mid = _decode_subframe(br, block_size, bps)
        side = _decode_subframe(br, block_size, bps + 1)
        left = (2 * mid + (side & 1) + side) >> 1
        out = np.stack([left, left - side], axis=1)
    else:
        raise ValueError(f"Reserved FLAC channel assignment {ch_code}")

    br.align_byte()
    br.read_uint(16)  # CRC-16 (not verified)
    return out


def _to_dtype(data: np.ndarray, bps: int, dtype: str) -> np.ndarray:
    """Match read_wav/libsndfile conventions for the requested dtype."""
    if dtype in ("float32", "float64"):
        return (data.astype(dtype)) / float(1 << (bps - 1))
    if dtype == "int16":
        shift = bps - 16
        return (data >> shift).astype(np.int16) if shift >= 0 else (
            data.astype(np.int16) << -shift
        )
    if dtype == "int32":
        shift = 32 - bps
        return (data << shift).astype(np.int32) if shift >= 0 else (
            (data >> -shift).astype(np.int32)
        )
    raise ValueError(f"Unsupported read dtype: {dtype}")


# ---------------------------------------------------------------------------
# CRCs (encoder)
# ---------------------------------------------------------------------------


def _crc_table(poly: int, width: int) -> np.ndarray:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.empty(256, dtype=np.uint32)
    for b in range(256):
        crc = b << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
        table[b] = crc
    return table


_CRC8_TABLE = _crc_table(0x07, 8)
_CRC16_TABLE = _crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC8_TABLE[crc ^ b])
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC16_TABLE[((crc >> 8) ^ b) & 0xFF]) ^ ((crc << 8) & 0xFFFF)
    return crc


# ---------------------------------------------------------------------------
# Bit writer + encoder
# ---------------------------------------------------------------------------


class _BitWriter:
    __slots__ = ("chunks", "acc", "nbits")

    def __init__(self):
        self.chunks: List[bytes] = []
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int) -> None:
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        if self.nbits >= 4096:
            take = self.nbits - self.nbits % 8
            self.chunks.append(
                (self.acc >> (self.nbits - take)).to_bytes(take // 8, "big")
            )
            self.nbits -= take
            self.acc &= (1 << self.nbits) - 1

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def pad_to_byte(self) -> None:
        if self.nbits % 8:
            self.write(0, 8 - self.nbits % 8)

    def getvalue(self) -> bytes:
        self.pad_to_byte()
        if self.nbits:
            self.chunks.append(self.acc.to_bytes(self.nbits // 8, "big"))
            self.acc = 0
            self.nbits = 0
        out = b"".join(self.chunks)
        self.chunks = [out]
        return out


def _utf8_coded(v: int) -> bytes:
    """FLAC's UTF-8-style coded number, minimal encoding (an n-byte sequence
    carries 5n+1 payload bits: 7-n in the lead byte + 6 per continuation).
    Inverse of _read_utf8_coded."""
    if v < 0x80:
        return bytes([v])
    n = 2
    while v >= (1 << (5 * n + 1)):
        n += 1
    lead = ((0xFF << (8 - n)) & 0xFF) | (v >> (6 * (n - 1)))
    return bytes([lead] + [0x80 | ((v >> (6 * i)) & 0x3F) for i in range(n - 2, -1, -1)])


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    res = x
    for _ in range(order):
        res = np.diff(res)
    return res


def _rice_k(res: np.ndarray) -> int:
    mean = float(np.mean(np.abs(res))) if res.size else 0.0
    k = 0
    while (1 << k) < mean and k < 30:
        k += 1
    return k


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int) -> None:
    if np.all(x == x[0]):
        bw.write(0, 1)
        bw.write(0, 6)  # CONSTANT
        bw.write(0, 1)
        bw.write(int(x[0]), bps)
        return
    # Best FIXED order 0-2 by absolute residual sum.
    best_order, best_res, best_cost = 0, x, float(np.sum(np.abs(x)))
    for order in (1, 2):
        if x.size <= order:
            break
        res = _fixed_residual(x, order)
        cost = float(np.sum(np.abs(res)))
        if cost < best_cost:
            best_order, best_res, best_cost = order, res, cost
    order, res = best_order, best_res

    bw.write(0, 1)
    bw.write(8 + order, 6)  # FIXED
    bw.write(0, 1)  # no wasted bits
    for i in range(order):
        bw.write(int(x[i]), bps)
    # Residuals: RICE method, partition order 0.
    bw.write(0, 2)
    bw.write(0, 4)
    k = _rice_k(res)
    zig = (np.abs(res.astype(np.int64)) << 1) - (res < 0).astype(np.int64)
    # Escape to raw if Rice would blow up (pathological residuals).
    if k >= 15:
        raw_bits = min(32, int(np.max(np.abs(res))).bit_length() + 1)
        bw.write(0xF, 4)
        bw.write(raw_bits, 5)
        for v in res:
            bw.write(int(v), raw_bits)
        return
    bw.write(k, 4)
    for v in zig:
        v = int(v)
        bw.write_unary(v >> k)
        if k:
            bw.write(v, k)


def write_flac(path: str, data: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """Encode float [-1, 1] (or integer) audio as a FLAC file."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    frames, channels = data.shape
    if np.issubdtype(data.dtype, np.floating):
        full = float(1 << (bits - 1))
        pcm = np.clip(np.round(data * full), -full, full - 1).astype(np.int64)
    else:
        pcm = data.astype(np.int64)

    block = 4096
    out = [FLAC_MAGIC]
    # STREAMINFO (last metadata block).
    si = _BitWriter()
    si.write(block, 16)
    si.write(block, 16)
    si.write(0, 24)  # min frame size unknown
    si.write(0, 24)  # max frame size unknown
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bits - 1, 5)
    si.write(frames, 36)
    si.write(0, 128)  # MD5 unknown
    body = si.getvalue()
    out.append(bytes([0x80]) + len(body).to_bytes(3, "big") + body)

    for frame_idx, start in enumerate(range(0, frames, block)):
        chunk = pcm[start : start + block]
        bs = chunk.shape[0]
        hw = _BitWriter()
        hw.write(0x3FFE, 14)
        hw.write(0, 1)  # reserved
        hw.write(0, 1)  # fixed block size strategy
        hw.write(7, 4)  # block size: 16-bit at end
        hw.write(0, 4)  # sample rate: from STREAMINFO
        hw.write(channels - 1, 4)  # independent channels
        hw.write({8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bits], 3)
        hw.write(0, 1)  # reserved
        for octet in _utf8_coded(frame_idx):
            hw.write(octet, 8)
        hw.write(bs - 1, 16)
        header = hw.getvalue()
        header += bytes([_crc8(header)])

        fw = _BitWriter()
        for ch in range(channels):
            _encode_subframe(fw, chunk[:, ch], bits)
        payload = fw.getvalue()
        frame = header + payload
        frame += struct.pack(">H", _crc16(frame))
        out.append(frame)

    with open(path, "wb") as f:
        f.write(b"".join(out))
