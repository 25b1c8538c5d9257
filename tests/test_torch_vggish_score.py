"""The VGGish slice end to end: the port and the JAX package on the same
weights and the same WAV corpora, on the CPU.

Both packages load one random bundle that the JAX package wrote with
save_weights, through weights="auto". Bounds: per-file embeddings atol 1e-4
(float32 on both sides, different summation orders), FAD within 1e-3
absolute (the bar in BASELINE.md), tightened here to 1e-3 relative as well.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from frechet_audio_distance_exported_tpu import FrechetAudioDistance as JaxFAD  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import audio_io as jax_io  # noqa: E402
from frechet_audio_distance_exported_tpu.utils.weights import (  # noqa: E402
    init_random_params,
    save_weights,
)
from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import registry  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import launches  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import audio_io  # noqa: E402

SR = 16000

# name -> (directory, sample rate, seconds, kind)
FILES = {
    "sine440": ("bg", SR, 2.2, 440.0),
    "sine550": ("bg", SR, 2.2, 550.0),
    "sine660_8k": ("bg", 8000, 2.2, 660.0),  # the resample path
    "sine_short": ("bg", SR, 0.5, 440.0),  # under one 0.96 s patch: zero rows
    "noise0": ("ev", SR, 2.2, None),
    "noise1": ("ev", SR, 2.2, None),
    "noise_long": ("ev", SR, 4.1, None),  # another length bucket
}


def _agree(a, b, rel=1e-3, abs_=1e-3):
    assert abs(a - b) <= abs_, (a, b)
    assert abs(a - b) <= rel * max(abs(a), abs(b)) + 1e-12, (a, b)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_score")
    for d in ("bg", "ev", "empty", "ck"):
        (root / d).mkdir()
    rng = np.random.default_rng(0)
    for name, (d, sr, dur, freq) in FILES.items():
        n = int(sr * dur)
        if freq is None:
            clip = rng.standard_normal(n) * 0.1
        else:
            clip = 0.5 * np.sin(2 * np.pi * freq * np.arange(n) / sr)
        audio_io.write_wav(str(root / d / f"{name}.wav"), clip.astype(np.float32), sr)
    save_weights(str(root / "ck" / "vggish_tpu.npz"), init_random_params("vggish", 0))
    return root


@pytest.fixture(scope="module")
def jax_fad(corpora):
    return JaxFAD(model_name="vggish", weights="auto", ckpt_dir=str(corpora / "ck"))


@pytest.fixture(scope="module")
def fad(corpora):
    return FrechetAudioDistance(
        model_name="vggish", weights="auto", ckpt_dir=str(corpora / "ck"), device="cpu"
    )


@pytest.fixture(scope="module")
def jax_scores(jax_fad, corpora):
    bg, ev = str(corpora / "bg"), str(corpora / "ev")
    return {
        "host": jax_fad.score(bg, ev),
        "device_stats": jax_fad.score(bg, ev, device_stats=True),
    }


@pytest.mark.parametrize("name", sorted(FILES))
def test_per_file_embeddings_match_jax(fad, jax_fad, corpora, name):
    d = FILES[name][0]
    path = str(corpora / d / f"{name}.wav")
    ours_audio = audio_io.load_audio(path, SR, 1)
    jax_audio = jax_io.load_audio(path, SR, 1)
    np.testing.assert_allclose(ours_audio, jax_audio, rtol=0, atol=1e-6)
    ours = fad._get_embedding_for_audio(ours_audio)
    ref = jax_fad._get_embedding_for_audio(jax_audio)
    assert ours.shape == ref.shape == (int(FILES[name][2] / 0.96), 128)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["host", "device_stats"])
def test_score_matches_jax(fad, corpora, jax_scores, mode):
    ours = fad.score(str(corpora / "bg"), str(corpora / "ev"), device_stats=mode == "device_stats")
    ref = jax_scores[mode]
    assert ours != -1 and np.isfinite(ours) and ours > 0
    _agree(ours, ref)


def test_device_stats_agrees_with_host_path(fad, corpora):
    bg, ev = str(corpora / "bg"), str(corpora / "ev")
    _agree(fad.score(bg, ev, device_stats=True), fad.score(bg, ev))


def test_identical_dirs_score_zero(fad, corpora):
    bg = str(corpora / "bg")
    assert abs(fad.score(bg, bg)) <= 1e-9
    assert abs(fad.score(bg, bg, device_stats=True)) <= 1e-6


def test_embedding_cache_round_trip(fad, corpora, tmp_path):
    bg, ev = str(corpora / "bg"), str(corpora / "ev")
    bg_npy, ev_npy = str(tmp_path / "c" / "bg.npy"), str(tmp_path / "c" / "ev.npy")
    first = fad.score(bg, ev, bg_npy, ev_npy)
    assert os.path.exists(bg_npy) and os.path.exists(ev_npy)
    assert np.load(bg_npy).shape == (3 * 2, 128)  # 2 patches per 2.2 s file, none for 0.5 s
    # The second call must read the caches: empty dirs would otherwise give -1.
    empty = str(corpora / "empty")
    assert fad.score(empty, empty, bg_npy, ev_npy) == first


@pytest.mark.parametrize("device_stats", [False, True])
def test_empty_dir_gives_the_sentinel(fad, corpora, device_stats):
    assert fad.score(str(corpora / "empty"), str(corpora / "ev"), device_stats=device_stats) == -1
    assert fad.score(str(corpora / "bg"), str(corpora / "empty"), device_stats=device_stats) == -1


def test_constructor_errors(corpora, monkeypatch):
    ck = str(corpora / "ck")
    with pytest.raises(ValueError, match="Unknown model"):
        FrechetAudioDistance(model_name="vggish2", ckpt_dir=ck, device="cpu")
    # Every valid name is ported and constructs on the CPU.
    assert set(registry.VALID_MODELS) == set(registry.PORTED_MODELS)
    for name in registry.VALID_MODELS:
        fad = FrechetAudioDistance(model_name=name, weights="random", ckpt_dir=ck, device="cpu")
        assert fad.sample_rate == registry.VALID_MODELS[name]["sample_rate"]
    with pytest.raises(ValueError, match="sample_rate"):
        FrechetAudioDistance(model_name="vggish", sample_rate=8000, ckpt_dir=ck, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        FrechetAudioDistance(model_name="vggish", weights="auto", ckpt_dir=ck)


def test_tf32_is_off_after_construction(fad):
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_split_at_patch_chunk_is_invisible(fad, corpora):
    audio = audio_io.load_audio(str(corpora / "ev" / "noise_long.wav"), SR, 1)
    whole = fad._get_embedding_for_audio(audio)
    assert whole.shape[0] == 4
    split = FrechetAudioDistance(
        model_name="vggish", weights="auto", ckpt_dir=str(corpora / "ck"), device="cpu",
        patch_chunk=3,
    )._get_embedding_for_audio(audio)
    np.testing.assert_allclose(split, whole, rtol=0, atol=1e-6)


def test_preprocessing_errors_are_swallowed_unless_strict(fad):
    good = (np.random.default_rng(5).standard_normal(SR * 2) * 0.1).astype(np.float32)
    bad = np.array(["not audio"] * SR * 2)
    rows = fad.get_embeddings([good, bad], sr=SR)
    np.testing.assert_array_equal(rows, fad.get_embeddings([good], sr=SR))
    with pytest.raises(ValueError):
        fad._get_embedding_for_audio(bad)


def test_other_containers_name_their_format(tmp_path):
    """A container other than WAV loads as in the JAX package (FLAC here;
    every container: tests/test_torch_codecs.py); an unknown one raises a
    ValueError that names the formats the port reads."""
    from frechet_audio_distance_exported_tpu_torch.utils import flac

    path = tmp_path / "x.flac"
    flac.write_flac(str(path), 0.5 * np.sin(np.arange(20000) / 9.0), 8000)
    ours = audio_io.load_audio(str(path), SR, 1)
    assert ours.shape == (40000,) and np.array_equal(ours, jax_io.load_audio(str(path), SR, 1))
    unknown = tmp_path / "x.bin"
    unknown.write_bytes(b"ABCD" + bytes(64))
    with pytest.raises(ValueError, match="FLAC"):
        audio_io.load_audio(str(unknown), SR, 1)


def test_hooks_see_every_score(corpora):
    calls = []

    class Hooked(FrechetAudioDistance):
        def calculate_frechet_distance(self, *args, **kwargs):
            calls.append(1)
            return super().calculate_frechet_distance(*args, **kwargs)

    fad = Hooked(model_name="vggish", weights="auto", ckpt_dir=str(corpora / "ck"), device="cpu")
    bg, ev = str(corpora / "bg"), str(corpora / "ev")
    assert fad.score(bg, ev) > 0
    assert fad.score(bg, ev, device_stats=True) > 0
    assert len(calls) == 2


def test_warmup_runs_on_the_plain_path(fad):
    before = launches.read()["fused_vggish_logmel"]
    fad.warmup(durations=(1.0,), num_files=2)
    assert launches.read()["fused_vggish_logmel"] == before
