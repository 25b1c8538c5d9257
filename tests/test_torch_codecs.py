"""The port's audio containers against the JAX package's, on the CPU.

Every container the JAX package decodes is written once (by the JAX
package's writer, or by hand where it has none: WAV 8/24/32-bit, AIFC
A-law, BW64, FLAC after an ID3v2 tag, Ogg FLAC) and decoded by both
packages' ``sf_read`` with dtype float32, int16 and int32: the arrays must
be ``np.array_equal`` at the same rate, and where the JAX package raises,
the port raises the same exception type. The port's writers must give the
same bytes as the JAX package's; truncated and garbage input must fail (or
decode) alike in both, as tests/test_codec_fuzz.py requires of the JAX
package alone. Ogg Vorbis, MP3 and Ogg Opus go through the system's
libraries; their cases skip where a library is absent, as
tests/test_lossy_codecs.py does. The code of each copied codec module after
its docstring is held equal to its JAX source.
"""

import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from frechet_audio_distance_exported_tpu.utils import aiff as j_aiff  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import au as j_au  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import audio_io as j_io  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import caf as j_caf  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import flac as j_flac  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import g711 as j_g711  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import mp3 as j_mp3  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import opusogg as j_opus  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import vorbis as j_vorbis  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import wav64 as j_wav64  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import aiff, au, audio_io, caf, flac  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import g711, mp3, opusogg, vorbis, wav64  # noqa: E402

REPO_ROOT = Path(__file__).parent.parent
JAX = SimpleNamespace(aiff=j_aiff, au=j_au, io=j_io, caf=j_caf, flac=j_flac, g711=j_g711,
                      mp3=j_mp3, opus=j_opus, vorbis=j_vorbis, wav64=j_wav64)
PORT = SimpleNamespace(aiff=aiff, au=au, io=audio_io, caf=caf, flac=flac, g711=g711,
                       mp3=mp3, opus=opusogg, vorbis=vorbis, wav64=wav64)
SR = 22050
FRAMES = 3000  # even: no IFF pad byte after an 8-bit payload
DTYPES = ("float32", "int16", "int32")


def _clip(channels: int, seed: int = 0) -> np.ndarray:
    """A sine plus noise at 0.6 of full scale, with one sample over it so
    every writer's clipping runs."""
    rng = np.random.default_rng(seed)
    t = np.arange(FRAMES) / SR
    chans = [0.4 * np.sin(2 * np.pi * (440.0 + 110.0 * c) * t) + 0.2 * rng.standard_normal(FRAMES)
             for c in range(channels)]
    x = np.clip(np.stack(chans, axis=1), -1.0, 1.0)
    x[7, 0] = 1.25
    return x[:, 0] if channels == 1 else x


def _riff_wav(path, x, sr, bits):
    """A PCM WAV of 8, 24 or 32 bits (the package writers give 16 and float)."""
    channels = 1 if x.ndim == 1 else x.shape[1]
    flat = np.asarray(x, np.float64).reshape(-1)
    if bits == 8:
        payload = (np.clip(np.round(flat * 128.0), -128, 127) + 128).astype(np.uint8).tobytes()
    else:
        full = float(1 << (bits - 1))
        pcm = np.clip(np.round(flat * full), -full, full - 1).astype("<i4")
        payload = pcm.tobytes() if bits == 32 else b"".join(
            v.tobytes()[:3] for v in pcm.astype("<i4"))
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 1, channels, sr, sr * block, block, bits)
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    chunks += b"data" + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)


def _aifc_alaw(m, path, x, sr):
    """AIFC A-law: the package's mu-law AIFC with the compression type and
    the payload swapped (its writer has no A-law)."""
    m.aiff.write_aiff(path, x, sr, subtype="ulaw")
    raw = bytearray(Path(path).read_bytes())
    pcm = np.clip(np.round(np.asarray(x, np.float64).reshape(-1) * 32768.0), -32768, 32767)
    payload = m.g711.alaw_encode(pcm.astype(np.int16)).tobytes()
    head = raw[: len(raw) - len(payload)]
    comp = head.index(b"ulaw")
    head[comp : comp + 4] = b"alaw"
    Path(path).write_bytes(bytes(head) + payload)


def _bw64(m, path, x, sr):
    m.wav64.write_rf64(path, x, sr)
    raw = bytearray(Path(path).read_bytes())
    raw[:4] = b"BW64"  # ADM BW64 shares the RF64 layout
    Path(path).write_bytes(bytes(raw))


def _id3_flac(m, path, x, sr):
    """FLAC behind an ID3v2 tag of 300 bytes (synchsafe size) with a footer."""
    m.flac.write_flac(path, x, sr)
    size = 300
    synchsafe = bytes([(size >> 21) & 0x7F, (size >> 14) & 0x7F, (size >> 7) & 0x7F, size & 0x7F])
    tag = b"ID3\x04\x00\x10" + synchsafe + b"\x00" * size + b"3DI\x04\x00\x10" + synchsafe
    Path(path).write_bytes(tag + Path(path).read_bytes())


def _ogg_flac(m, path, x, sr):
    """Ogg FLAC muxed with libogg, as tests/test_lossy_codecs.py makes it."""
    from test_lossy_codecs import _mux_ogg

    native = str(path) + ".native.flac"
    m.flac.write_flac(native, x, sr)
    raw = Path(native).read_bytes()
    pos = 4
    while True:  # walk the metadata blocks to the first frame
        last, size = raw[pos] >> 7, int.from_bytes(raw[pos + 1 : pos + 4], "big")
        pos += 4 + size
        if last:
            break
    first = b"\x7fFLAC\x01\x00" + struct.pack(">H", 0) + raw[: 4 + 4 + 34]
    frames = raw[pos:]
    _mux_ogg(path, [first] + [frames[i : i + 777] for i in range(0, len(frames), 777)])


def _needs_ogg(_m):
    return None if j_vorbis.have_vorbis_encoder() else "libogg not available for muxing"


# name -> (channels, writer(m, path, x, sr), whether both packages have the
# writer, a reason to skip or None)
CONTAINERS = {
    **{f"flac{bits}_{'mono' if ch == 1 else 'stereo'}": (
        ch, lambda m, p, x, sr, b=bits: m.flac.write_flac(p, x, sr, bits=b), True, None)
       for bits in (8, 16, 24) for ch in (1, 2)},
    "flac_id3": (2, _id3_flac, True, None),
    "ogg_flac": (2, _ogg_flac, True, _needs_ogg),
    "aiff": (2, lambda m, p, x, sr: m.aiff.write_aiff(p, x, sr), True, None),
    "aifc_sowt": (1, lambda m, p, x, sr: m.aiff.write_aiff(p, x, sr, subtype="sowt"), True, None),
    "aifc_ulaw": (2, lambda m, p, x, sr: m.aiff.write_aiff(p, x, sr, subtype="ulaw"), True, None),
    "aifc_alaw": (1, _aifc_alaw, True, None),
    "aifc_fl32": (2, lambda m, p, x, sr: m.aiff.write_aiff(p, x, sr, subtype="float32"), True,
                  None),
    **{f"au_{sub}": (ch, lambda m, p, x, sr, s=sub: m.au.write_au(p, x, sr, subtype=s), True, None)
       for sub, ch in (("pcm16", 2), ("ulaw", 1), ("alaw", 2), ("float32", 1))},
    "caf": (2, lambda m, p, x, sr: m.caf.write_caf(p, x, sr), True, None),
    "rf64": (2, lambda m, p, x, sr: m.wav64.write_rf64(p, x, sr), True, None),
    "bw64": (1, _bw64, True, None),
    "w64": (2, lambda m, p, x, sr: m.wav64.write_w64(p, x, sr), True, None),
    "wav16": (2, lambda m, p, x, sr: m.io.write_wav(p, x, sr), True, None),
    "wav_float": (2, lambda m, p, x, sr: m.io.write_wav(p, x, sr, subtype="float32"), True, None),
    **{f"wav{bits}": (ch, lambda m, p, x, sr, b=bits: _riff_wav(p, x, sr, b), False, None)
       for bits, ch in ((8, 1), (24, 2), (32, 1))},
}
LOSSY = {
    "vorbis": (lambda m, p, x: m.vorbis.write_ogg_vorbis(p, x, SR),
               lambda: j_vorbis.have_vorbis() and j_vorbis.have_vorbis_encoder()),
    "mp3": (lambda m, p, x: m.mp3.write_mp3(p, x, SR),
            lambda: j_mp3.have_mp3() and j_mp3.have_mp3_encoder()),
    "opus": (lambda m, p, x: m.opus.write_ogg_opus(p, x, 24000),
             lambda: j_opus.have_opus() and j_opus.have_opus_encoder()),
}


def _write(name, m, path):
    channels, writer, _, needs = CONTAINERS[name]
    reason = needs(m) if needs else None
    if reason:
        pytest.skip(reason)
    writer(m, str(path), _clip(channels, seed=len(name)), SR)
    return str(path)


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the type is the outcome compared
        return "raised", type(e)


def _same(path, dtype):
    """Both packages' sf_read on one file: equal arrays, rate and dtype, or
    the same exception type."""
    kind_j, got_j = _outcome(lambda: j_io.sf_read(path, dtype=dtype))
    kind_p, got_p = _outcome(lambda: audio_io.sf_read(path, dtype=dtype))
    assert kind_j == kind_p, (got_j, got_p)
    if kind_j == "raised":
        assert got_j is got_p
        return None
    (a, sr_a), (b, sr_b) = got_j, got_p
    assert sr_a == sr_b and a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)
    return a


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_both_packages_decode_a_container_alike(tmp_path, name, dtype):
    path = _write(name, JAX, tmp_path / name)
    out = _same(path, dtype)
    channels = CONTAINERS[name][0]
    if out is not None:  # a decode, not a refusal: the whole clip
        assert out.shape == ((FRAMES,) if channels == 1 else (FRAMES, channels))


@pytest.mark.parametrize("name", sorted(n for n, c in CONTAINERS.items() if c[2]))
def test_port_writers_give_the_same_bytes(tmp_path, name):
    ours = _write(name, PORT, tmp_path / f"port_{name}")
    ref = _write(name, JAX, tmp_path / f"jax_{name}")
    assert Path(ours).read_bytes() == Path(ref).read_bytes()


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_truncated_and_garbage_input_fail_alike(tmp_path, name):
    raw = Path(_write(name, JAX, tmp_path / name)).read_bytes()
    rng = np.random.default_rng(len(name))
    variants = [raw[:cut] for cut in (4, 12, 40, len(raw) // 3, len(raw) - 5)]
    variants.append(raw[:16] + rng.integers(0, 256, 2048, dtype=np.uint8).tobytes())
    for i, body in enumerate(variants):
        path = tmp_path / f"bad{i}"
        path.write_bytes(body)
        _same(str(path), "float32")


@pytest.mark.parametrize("dtype", ("float32", "int16"))
@pytest.mark.parametrize("name", sorted(LOSSY))
def test_lossy_files_decode_alike(tmp_path, name, dtype):
    writer, present = LOSSY[name]
    if not present():
        pytest.skip(f"the system library for {name} is not available")
    x = _clip(2, seed=3)[:, :2]
    path = str(tmp_path / name)
    writer(JAX, path, x)
    out = _same(path, dtype)
    assert out is not None and out.ndim == 2 and out.shape[1] == 2
    port_path = str(tmp_path / f"port_{name}")
    writer(PORT, port_path, x)
    assert np.array_equal(audio_io.sf_read(port_path, dtype)[0], out)


@pytest.mark.parametrize("have", ["have_vorbis", "have_vorbis_encoder", "have_mp3",
                                  "have_mp3_encoder", "have_opus", "have_opus_encoder"])
def test_the_library_probes_agree(have):
    module = {"vorbis": (j_vorbis, vorbis), "mp3": (j_mp3, mp3), "opus": (j_opus, opusogg)}
    ref, ours = module[have.split("_")[1]]
    assert getattr(ref, have)() == getattr(ours, have)()


def test_the_native_decoder_hook(tmp_path):
    """set_native_decoder routes float reads through the hook, int reads
    not (JAX audio_io.py:37-45, L213-215)."""
    path = _write("wav16", JAX, tmp_path / "a.wav")
    calls = []

    def hook(p):
        calls.append(p)
        return np.full((5, 2), 0.25, np.float32), 1234

    audio_io.set_native_decoder(hook)
    try:
        data, sr = audio_io.sf_read(path)
        assert sr == 1234 and np.array_equal(data, np.full((5, 2), 0.25, np.float32))
        assert audio_io.sf_read(path, dtype="float64")[0].dtype == np.float64
        assert audio_io.sf_read(path, dtype="int16")[1] == SR
        assert calls == [path, path]
    finally:
        audio_io.set_native_decoder(None)
    assert audio_io.sf_read(path)[1] == SR


def test_unknown_magic_is_refused_alike(tmp_path):
    path = tmp_path / "x.bin"
    path.write_bytes(b"ABCD" + b"\x00" * 64)
    with pytest.raises(ValueError, match="Unsupported audio format"):
        audio_io.sf_read(str(path))
    _same(str(path), "float32")


@pytest.mark.parametrize("module", ["aiff", "au", "caf", "flac", "g711", "mp3", "opusogg",
                                    "vorbis", "wav64", "_clib"])
def test_the_copied_code_equals_its_source(module):
    """Each codec module is its JAX source below a docstring of its own."""
    def code(path):
        text = path.read_text()
        return text[text.index('"""', 3) + 3 :]

    ours = REPO_ROOT / "frechet_audio_distance_exported_tpu_torch" / "utils" / f"{module}.py"
    ref = REPO_ROOT / "frechet_audio_distance_exported_tpu" / "utils" / f"{module}.py"
    assert code(ours) == code(ref)
    assert "port's copy of frechet_audio_distance_exported_tpu/utils/" in ours.read_text()
