"""The int16 wire from the decoder, on the CPU.

score()'s streamed path loads each file with ``audio_io.load_audio_wire``:
a mono 16-bit PCM WAV at the model's rate comes back as ``audio_io.Pcm16``
(its decoded int16 samples k, standing for k/32768), and the pipeline ships
those samples, or CLAP's m = trunc(float32(k/32768) * 32767) = k - sign(k),
without turning them into float32 and searching for them again
(``as_int16_exact``). Every other file comes back as ``load_audio`` returns
it.

Held here: CLAP's host steps against a copy of the float32 chain they
replace (every int16 sample, the cut and the zero pad, float input beyond
full scale, a resampled clip); the loader against ``load_audio`` and the
JAX package's loader; whole ``score(device_stats=True)`` calls against the
same calculator fed ``load_audio``'s float32 arrays, bit for bit in the
statistics and the FAD, with the ``prep`` spans' ``pcm16`` counts; Encodec's
wire at both rates, with the files whose second channel the device makes
(``dup``) and the frames its ``step`` spans fold in.
"""

import struct

import numpy as np
import pytest
import torch

from frechet_audio_distance_exported_tpu.utils import audio_io as jax_io
from frechet_audio_distance_exported_tpu_torch.fad import FrechetAudioDistance
from frechet_audio_distance_exported_tpu_torch.ops import frontends as fe
from frechet_audio_distance_exported_tpu_torch.ops.resample import resample
from frechet_audio_distance_exported_tpu_torch.pipeline import EmbeddingPipeline, as_int16_exact
from frechet_audio_distance_exported_tpu_torch.utils import audio_io, profiling
from frechet_audio_distance_exported_tpu_torch.utils.audio_io import Pcm16, write_wav
from frechet_audio_distance_exported_tpu_torch.utils.flac import write_flac

DTYPES = ("float32", "float64", "int16", "int32")


@pytest.fixture(autouse=True)
def own_codecs(monkeypatch):
    """The port's own codecs, as where soundfile is not installed."""
    monkeypatch.setattr(audio_io, "_sf", None)


def clap_prep_oracle(data: np.ndarray, sr: int):
    """EmbeddingPipeline._clap_prep as it was before the wire: the float32
    chain, dequantised by 32767, reflect-padded in float32, searched again."""
    n_fft = fe.PANN_CONFIGS[fe.CLAP_SAMPLE_RATE]["window_size"]
    hop = fe.PANN_CONFIGS[fe.CLAP_SAMPLE_RATE]["hop_size"]
    if data.ndim > 1:
        data = np.mean(data, axis=1)
    need = (fe.CLAP_TIME_FRAMES + 2) * hop
    if sr != fe.CLAP_SAMPLE_RATE:
        need = int(np.ceil(need * sr / fe.CLAP_SAMPLE_RATE)) + 4096
    if len(data) > need:
        data = data[:need]
    pad_target = min(fe.CLAP_MAX_SAMPLES, need)
    if len(data) < pad_target:
        data = np.pad(data, (0, pad_target - len(data)))
    data = data.astype(np.float32)
    data = (data * 32767.0).astype(np.int16).astype(np.float32) / 32767.0
    if sr != fe.CLAP_SAMPLE_RATE:
        data = resample(data, sr, fe.CLAP_SAMPLE_RATE).astype(np.float32)
    n_valid = min(fe.CLAP_TIME_FRAMES, fe.pann_num_frames(len(data), hop))
    padded = fe.reflect_pad_host(data, n_fft)
    q = as_int16_exact(padded, 32767.0)
    return (padded if q is None else q), n_valid


def clap_prep(data, sr, pcm16=False):
    return EmbeddingPipeline.__new__(EmbeddingPipeline)._clap_prep(data, sr, pcm16)


def assert_same_wave(got, want):
    (g, gn), (w, wn) = got, want
    assert g.dtype == w.dtype
    assert g.shape == w.shape
    assert g.tobytes() == w.tobytes()
    assert gn == wn


def pcm(n: int, seed: int, scale: float = 0.3) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(n) * scale
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


# ---------------------------------------------------------------------------
# CLAP's host steps
# ---------------------------------------------------------------------------


def test_clap_wire_maps_every_int16_sample_as_the_float32_chain():
    k = np.arange(-32768, 32768, dtype=np.int16)
    chain = ((k.astype(np.float32) / 32768.0) * 32767.0).astype(np.int16)
    assert np.array_equal(k - np.sign(k), chain)
    # Every k, shuffled, in a 10 s clip: the whole wave, reflect pad included.
    clip = np.resize(np.random.default_rng(0).permutation(k), 480000)
    got = clap_prep(clip, 48000, pcm16=True)
    assert got[0].dtype == np.int16
    assert_same_wave(got, clap_prep_oracle(clip.astype(np.float32) / 32768.0, 48000))


@pytest.mark.parametrize("samples", [240000, 480000, 481000, 481440, 576000])
def test_clap_wire_cuts_and_pads_as_the_float_path(samples):
    """5 s, 10 s, between the 10 s pad and the read window, at the window
    (1003 hops), 12 s: the cut at the window and the zero pad to 10 s."""
    k = pcm(samples, seed=samples)
    want = clap_prep_oracle(k.astype(np.float32) / 32768.0, 48000)
    assert_same_wave(clap_prep(k, 48000, pcm16=True), want)
    assert_same_wave(clap_prep(k.astype(np.float32) / 32768.0, 48000), want)
    assert_same_wave(clap_prep(k.astype(np.float64) / 32768.0, 48000), want)


def test_clap_float_input_beyond_full_scale_ships_the_same_cast():
    """Float input needs no search either: the int16 cast's m, whatever it
    makes of a sample past full scale, is what the search found."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(480000) * 1.5).astype(np.float32)
    x[:6] = [1.0, -1.0, 1.0001, -1.0001, 2.0, -3.0]
    assert np.abs(x).max() > 1.0
    with np.errstate(invalid="ignore"):
        got = clap_prep(x, 48000)
        want = clap_prep_oracle(x, 48000)
    assert got[0].dtype == np.int16
    assert_same_wave(got, want)


def test_clap_stereo_float_input_is_mixed_then_cast():
    x = pcm(2 * 300000, seed=9).reshape(-1, 2).astype(np.float32) / 32768.0
    assert_same_wave(clap_prep(x, 48000), clap_prep_oracle(x, 48000))


def test_clap_resampled_clip_stays_on_the_float32_path():
    k = pcm(441000, seed=3)
    x = k.astype(np.float32) / 32768.0
    got = clap_prep(x, 44100)
    assert got[0].dtype == np.float32
    assert_same_wave(got, clap_prep_oracle(x, 44100))
    # Silence resamples onto the grid, and is still found there.
    silent = clap_prep(np.zeros(44100, np.float32), 44100)
    assert silent[0].dtype == np.int16
    assert_same_wave(silent, clap_prep_oracle(np.zeros(44100, np.float32), 44100))


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------


def write_wav_raw(path, payload: bytes, sr: int, channels: int, bits: int, fmt_tag: int = 1):
    """A canonical RIFF/WAVE file around ``payload``."""
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, sr, sr * channels * bits // 8,
                      channels * bits // 8, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(payload)) + payload
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def write_kind(path, kind: str, sr: int, n: int, seed: int):
    """One file of the given kind, of noise at about -10 dBFS."""
    k = pcm(n, seed)
    if kind == "pcm16":
        write_wav(path, k.astype(np.float64) / 32768.0, sr)
    elif kind == "float32":
        write_wav(path, k.astype(np.float32) / 32768.0 + 1e-6, sr, subtype="float32")
    elif kind == "pcm24":
        v = k.astype(np.int32) * 256 + np.random.default_rng(seed).integers(0, 256, n)
        b = v.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        write_wav_raw(path, b.tobytes(), sr, 1, 24)
    elif kind == "pcm8":
        write_wav_raw(path, ((k >> 8) + 128).astype(np.uint8).tobytes(), sr, 1, 8)
    elif kind == "stereo":
        write_wav(path, np.stack([k, pcm(n, seed + 1)], axis=1) / 32768.0, sr)
    elif kind == "flac16":
        write_flac(path, k.astype(np.float64) / 32768.0, sr)
    else:
        raise ValueError(kind)


@pytest.mark.parametrize("dtype", DTYPES)
def test_load_audio_wire_hands_a_pcm16_wav_out_as_its_samples(tmp_path, dtype):
    path = str(tmp_path / "a.wav")
    write_kind(path, "pcm16", 16000, 7000, seed=1)
    item = audio_io.load_audio_wire(path, 16000, 1, dtype)
    assert isinstance(item, Pcm16)
    assert item.samples.dtype == np.int16 and len(item) == 7000
    np.testing.assert_array_equal(item.samples, pcm(7000, seed=1))
    want = audio_io.load_audio(path, 16000, 1, dtype)
    np.testing.assert_array_equal(np.asarray(item, want.dtype), want)
    np.testing.assert_array_equal(np.asarray(item), audio_io.load_audio(path, 16000, 1))


@pytest.mark.parametrize("kind,channels,sr", [
    ("float32", 1, 16000), ("pcm24", 1, 16000), ("pcm8", 1, 16000),
    ("stereo", 1, 16000), ("stereo", 2, 16000), ("pcm16", 1, 44100), ("flac16", 1, 16000),
])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_load_audio_wire_gives_load_audio_for_every_other_file(tmp_path, kind, channels, sr, dtype):
    path = str(tmp_path / f"a.{'flac' if kind == 'flac16' else 'wav'}")
    write_kind(path, kind, sr, 9000, seed=2)
    got = audio_io.load_audio_wire(path, 16000, channels, dtype)
    want = audio_io.load_audio(path, 16000, channels, dtype)
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_load_audio_wire_leaves_a_native_decoder_its_files(tmp_path):
    path = str(tmp_path / "a.wav")
    write_kind(path, "pcm16", 16000, 5000, seed=4)
    calls = []

    def decoder(p):
        calls.append(p)
        return audio_io.read_wav(p, "float32")

    audio_io.set_native_decoder(decoder)
    try:
        got = audio_io.load_audio_wire(path, 16000, 1, "float32")
        assert isinstance(got, np.ndarray) and calls == [path]
        # The hook serves float reads only; an int16 read is the port's own.
        assert isinstance(audio_io.load_audio_wire(path, 16000, 1, "int16"), Pcm16)
    finally:
        audio_io.set_native_decoder(None)
    np.testing.assert_array_equal(got, audio_io.load_audio(path, 16000, 1))


def test_load_audio_wire_refuses_what_load_audio_refuses(tmp_path):
    path = str(tmp_path / "a.wav")
    write_kind(path, "pcm16", 16000, 5000, seed=4)
    with pytest.raises(ValueError, match="Unsupported read dtype"):
        audio_io.load_audio(path, 16000, 1, "uint8")
    with pytest.raises(ValueError, match="Unsupported read dtype"):
        audio_io.load_audio_wire(path, 16000, 1, "uint8")
    # channels=0: the reference's mono mix of a mono file fails on its axis.
    with pytest.raises(ValueError):
        audio_io.load_audio(path, 16000, 0)
    with pytest.raises(ValueError):
        audio_io.load_audio_wire(path, 16000, 0)
    bad = tmp_path / "b.wav"
    bad.write_bytes(b"RIFF\x04\x00\x00\x00WAVE")
    with pytest.raises(ValueError, match="missing fmt/data"):
        audio_io.load_audio_wire(str(bad), 16000, 1)


def test_the_reference_loaders_still_return_float_arrays(tmp_path):
    """load_audio, _load_audio_files and get_embeddings are the reference's
    surface: float arrays, equal to the JAX package's loader, and
    get_embeddings never takes the wire (its prep spans count 0)."""
    audio = tmp_path / "audio"
    audio.mkdir()
    for i in range(3):
        write_kind(str(audio / f"{i}.wav"), "pcm16", 16000, 20000 + 3000 * i, seed=10 + i)
    fad = FrechetAudioDistance(model_name="vggish", weights="random", device="cpu",
                               ckpt_dir=str(tmp_path / "ck"))
    for dtype in ("float32", "int16"):
        loaded = fad._load_audio_files(str(audio), dtype=dtype)
        names = audio_io.list_audio_files(str(audio))
        assert len(loaded) == len(names) == 3
        for arr, name in zip(loaded, names):
            want = jax_io.load_audio(str(audio / name), 16000, 1, dtype)
            assert isinstance(arr, np.ndarray) and arr.dtype == want.dtype
            np.testing.assert_array_equal(arr, want)
            np.testing.assert_array_equal(
                audio_io.load_audio(str(audio / name), 16000, 1, dtype), want)
    loaded = fad._load_audio_files(str(audio))
    profiling.start()
    try:
        emb = fad.get_embeddings(loaded, 16000)
    finally:
        spans = profiling.stop()
    preps = [s for s in spans if s.name == "prep"]
    assert preps and all(s.counts["pcm16"] == 0 for s in preps)
    items = [Pcm16(np.round(a * 32768.0).astype(np.int16)) for a in loaded]
    np.testing.assert_array_equal(emb, np.concatenate(fad.pipeline.embed_files(items, 16000)))


# ---------------------------------------------------------------------------
# score() end to end
# ---------------------------------------------------------------------------

RATES = {"vggish": 16000, "pann-16k": 16000, "clap": 48000, "encodec-24k": 24000,
         "encodec-48k": 48000}


@pytest.fixture(scope="module")
def calculator(tmp_path_factory):
    made = {}

    def get(model, channels=1):
        if (model, channels) not in made:
            made[model, channels] = FrechetAudioDistance(
                model_name=model, weights="random", device="cpu", channels=channels,
                ckpt_dir=str(tmp_path_factory.mktemp("ck")))
        return made[model, channels]

    return get


def make_dirs(root, kinds_sr, seconds=(1.5, 2.2)):
    """bg/ and ev/ under root: a file per (kind, rate) and length, louder
    in ev/."""
    dirs = []
    for side, seed0 in (("bg", 100), ("ev", 200)):
        d = root / side
        d.mkdir()
        for i, (kind, sr) in enumerate(kinds_sr):
            for j, s in enumerate(seconds):
                write_kind(str(d / f"{i}_{j}.{'flac' if kind == 'flac16' else 'wav'}"), kind, sr,
                           int(s * sr), seed=seed0 + 10 * i + j)
        dirs.append(str(d))
    return dirs


def scored(fad, dirs, dtype, monkeypatch, loader=None, counts=("files", "pcm16"), spans_out=None):
    """score(device_stats=True) -> (FAD, each directory's StreamingStats,
    the prep spans' ``counts``); ``loader`` replaces the streamed path's
    load_audio_wire; every span recorded is appended to ``spans_out``."""
    states = []
    accumulate = fad._accumulate_paths

    def spy(paths, dtype):
        states.append(accumulate(paths, dtype))
        return states[-1]

    with monkeypatch.context() as m:
        m.setattr(fad, "_accumulate_paths", spy)
        if loader is not None:
            m.setattr(audio_io, "load_audio_wire", loader)
        profiling.start()
        try:
            value = fad.score(*dirs, dtype=dtype, device_stats=True)
        finally:
            spans = profiling.stop()
    if spans_out is not None:
        spans_out.extend(spans)
    preps = [tuple(s.counts[c] for c in counts) for s in spans if s.name == "prep"]
    return value, states, preps


def float32_loader(path, sample_rate, channels, dtype):
    return audio_io.load_audio(path, sample_rate, channels, "float32")


def parent_loader(path, sample_rate, channels, dtype):
    return audio_io.load_audio(path, sample_rate, channels, dtype)


def assert_same_stats(got, want):
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for field in ("n", "s", "ss", "shift"):
            assert torch.equal(getattr(a, field), getattr(b, field)), field


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("model", ["vggish", "pann-16k", "clap"])
def test_score_on_the_wire_equals_the_float32_path_bit_for_bit(
        tmp_path, calculator, monkeypatch, model, dtype):
    fad = calculator(model)
    dirs = make_dirs(tmp_path, [("pcm16", RATES[model])])
    value, states, preps = scored(fad, dirs, dtype, monkeypatch)
    want_value, want_states, want_preps = scored(fad, dirs, dtype, monkeypatch, float32_loader)
    assert value > 0 and value == want_value
    assert_same_stats(states, want_states)
    assert preps == [(2, 2), (2, 2)]
    assert want_preps == [(2, 0), (2, 0)]


@pytest.mark.parametrize("kind,channels", [
    ("float32", 1), ("pcm24", 1), ("stereo", 1), ("pcm16-44k", 1), ("flac16", 1),
])
def test_score_fallbacks_keep_their_results_and_count_no_pcm16(
        tmp_path, calculator, monkeypatch, kind, channels):
    fad = calculator("vggish")
    sr = 44100 if kind == "pcm16-44k" else 16000
    dirs = make_dirs(tmp_path, [(kind.split("-")[0], sr)])
    value, states, preps = scored(fad, dirs, "float32", monkeypatch)
    want_value, want_states, _ = scored(fad, dirs, "float32", monkeypatch, parent_loader)
    assert value > 0 and value == want_value
    assert_same_stats(states, want_states)
    assert preps == [(2, 0), (2, 0)]


def test_score_of_a_mixed_directory_counts_its_pcm16_files(tmp_path, calculator, monkeypatch):
    fad = calculator("vggish")
    dirs = make_dirs(tmp_path, [("pcm16", 16000), ("float32", 16000), ("pcm16", 44100),
                                ("pcm16", 16000)])
    for dtype in ("float32", "int16"):
        value, states, preps = scored(fad, dirs, dtype, monkeypatch)
        want_value, want_states, _ = scored(fad, dirs, dtype, monkeypatch, parent_loader)
        assert value == want_value
        assert_same_stats(states, want_states)
        assert preps == [(8, 4), (8, 4)]


@pytest.mark.parametrize("model", ["encodec-24k", "encodec-48k"])
def test_score_of_encodec_takes_pcm16_files_as_float32(tmp_path, calculator, monkeypatch, model):
    """Encodec scores mono PCM16 files on the wire exactly as the float32
    path does: at 24 kHz as [b, 1, S]; at 48 kHz a chunk of such files alone
    ships [b, 1, S] and the device repeats the channel (``dup``). The
    ``step`` spans count the frames folded in: the statistics' row count."""
    fad = calculator(model)
    dirs = make_dirs(tmp_path, [("pcm16", RATES[model])], seconds=(1.0, 1.5))
    counts = ("files", "pcm16", "dup")
    spans = []
    value, states, preps = scored(fad, dirs, "float32", monkeypatch, counts=counts,
                                  spans_out=spans)
    want_value, want_states, want_preps = scored(fad, dirs, "float32", monkeypatch,
                                                 float32_loader, counts=counts)
    assert value > 0 and value == want_value
    assert_same_stats(states, want_states)
    dup = 2 if model == "encodec-48k" else 0  # 24 kHz is mono: no second channel
    assert preps == [(2, 2, dup), (2, 2, dup)]
    assert want_preps == [(2, 0, 0), (2, 0, 0)]
    frames = [s.counts["frames"] for s in spans if s.name == "step"]
    assert frames == [int(st.n.item()) for st in states]
    assert frames == [(RATES[model] + RATES[model] * 3 // 2) // 320] * 2


def test_score_of_encodec48k_ships_a_chunk_with_a_stereo_file_as_two_channels(
        tmp_path, calculator, monkeypatch):
    """A 48 kHz chunk that holds a stereo file packs [b, 2, S]: its mono
    PCM16 files take the wire (``pcm16``) but are duplicated on the host, so
    the device makes no channel (``dup`` 0); the statistics and the FAD
    stay those of the float32 path."""
    fad = calculator("encodec-48k", channels=2)
    dirs = make_dirs(tmp_path, [("pcm16", 48000), ("stereo", 48000)], seconds=(0.5, 0.75))
    counts = ("files", "pcm16", "dup")
    value, states, preps = scored(fad, dirs, "float32", monkeypatch, counts=counts)
    want_value, want_states, want_preps = scored(fad, dirs, "float32", monkeypatch,
                                                 float32_loader, counts=counts)
    assert value > 0 and value == want_value
    assert_same_stats(states, want_states)
    assert preps == [(4, 2, 0), (4, 2, 0)]
    assert want_preps == [(4, 0, 0), (4, 0, 0)]


@pytest.mark.parametrize("model", ["pann-16k", "clap"])
def test_pcm16_items_at_another_rate_are_resampled_as_floats(calculator, model):
    """A Pcm16 item whose rate is not the model's takes the float path (it
    is not counted), and embeds as its float32 waveform does."""
    fad = calculator(model)
    items = [Pcm16(pcm(44100 * 2, seed=s)) for s in (1, 2)]
    profiling.start()
    try:
        got = fad.pipeline.embed_files(items, 44100)
    finally:
        spans = profiling.stop()
    want = fad.pipeline.embed_files([np.asarray(i) for i in items], 44100)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [s.counts["pcm16"] for s in spans if s.name == "prep"] == [0]
