"""The PANN slice end to end: the port and the JAX package on the same weights
and the same WAV corpora, on the CPU, for pann-8k, pann-16k and pann-32k.

Both packages load one full-width CNN14 bundle that the JAX package wrote
with save_weights, through weights="auto". Its weights are drawn with numpy
at the JAX initializer's scale, uniform(±1/sqrt(fan_in)), and its
BatchNorms are perturbed, bn0 to log-mel statistics
(test_torch_pann_model.cnn14_tree), so the embeddings spread and the FAD
is not a rounding artefact. The corpora hold
short clips at the model's rate, a clip at another rate (the resample
path), two clips of different lengths on one 32k-24 grid (the mask), and a
0.05 s clip that is too short and is swallowed. With at most five rows a
side against d = 2048, score() takes the Gram-trick epilogue.

Bounds: embeddings atol 1e-4 (float32 on both sides, different summation
orders); FAD within 1e-3 absolute (the bar in BASELINE.md) and 1e-3
relative.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from frechet_audio_distance_exported_tpu import FrechetAudioDistance as JaxFAD  # noqa: E402
from frechet_audio_distance_exported_tpu import pipeline as jax_pipeline  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import audio_io as jax_io  # noqa: E402
from frechet_audio_distance_exported_tpu.utils.weights import save_weights  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import pipeline  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.models.pann import BLOCK_CHANNELS  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import launches  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import audio_io  # noqa: E402
from test_torch_pann_model import cnn14_tree  # noqa: E402

MODELS = {"pann-8k": 8000, "pann-16k": 16000, "pann-32k": 32000}
BUNDLES = ("pann_cnn14_8k_tpu.npz", "pann_cnn14_16k_tpu.npz", "pann_cnn14_32k_tpu.npz")

# name -> (directory, rate or None for the model's, seconds, sine Hz or None for noise)
FILES = {
    "sine_a": ("bg", None, 1.0, 440.0),
    "sine_b": ("bg", None, 1.02, 550.0),  # the same grid as sine_a, a different length
    "sine_other_rate": ("bg", "other", 1.2, 660.0),  # the resample path
    "tiny": ("bg", None, 0.05, 440.0),  # too short for CNN14: swallowed
    "noise_a": ("ev", None, 1.0, None),
    "noise_b": ("ev", None, 2.4, None),
    "noise_c": ("ev", None, 1.5, None),
}
OTHER_RATE = {8000: 16000, 16000: 22050, 32000: 16000}


def _agree(a, b, rel=1e-3, abs_=1e-3):
    assert abs(a - b) <= abs_, (a, b)
    assert abs(a - b) <= rel * max(abs(a), abs(b)) + 1e-12, (a, b)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """One JAX-written full-width bundle under the three PANN bundle names."""
    root = tmp_path_factory.mktemp("pann_ck")
    save_weights(str(root / BUNDLES[0]), cnn14_tree(channels=BLOCK_CHANNELS, conv_gain=1.0))
    for name in BUNDLES[1:]:
        os.link(root / BUNDLES[0], root / name)
    return root


@pytest.fixture(scope="module", params=sorted(MODELS))
def setup(request, ckpt_dir, tmp_path_factory):
    """(model name, rate, corpus root, port FAD, JAX FAD, JAX host score)."""
    name = request.param
    sr = MODELS[name]
    root = tmp_path_factory.mktemp(name)
    for d in ("bg", "ev", "empty", "long_only"):
        (root / d).mkdir()
    rng = np.random.default_rng(sr)
    for fname, (d, rate, dur, freq) in FILES.items():
        rate = OTHER_RATE[sr] if rate == "other" else sr
        n = int(rate * dur)
        if freq is None:
            clip = rng.standard_normal(n) * 0.1
        else:
            clip = 0.5 * np.sin(2 * np.pi * freq * np.arange(n) / rate)
        audio_io.write_wav(str(root / d / f"{fname}.wav"), clip.astype(np.float32), rate)
    audio_io.write_wav(str(root / "long_only" / "x.wav"), rng.standard_normal(sr) * 0.1, sr)
    ours = FrechetAudioDistance(
        model_name=name, weights="auto", ckpt_dir=str(ckpt_dir), device="cpu"
    )
    ref = JaxFAD(model_name=name, weights="auto", ckpt_dir=str(ckpt_dir))
    score = ref.score(str(root / "bg"), str(root / "ev"))
    yield name, sr, root, ours, ref, score


def _load_all(root, sr, loader):
    return [
        loader.load_audio(str(root / d / f"{f}.wav"), sr, 1) for f, (d, *_) in FILES.items()
    ]


def test_embeddings_match_jax(setup):
    name, sr, root, fad, jax_fad, _ = setup
    ours_audio = _load_all(root, sr, audio_io)
    jax_audio = _load_all(root, sr, jax_io)
    for a, b in zip(ours_audio, jax_audio):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    ours = fad.get_embeddings(ours_audio, sr)
    ref = jax_fad.get_embeddings(jax_audio, sr)
    assert ours.shape == ref.shape == (len(FILES) - 1, 2048)  # the tiny clip has no row
    assert (ours >= 0).all() and ours.std(axis=0).max() > 1e-3
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_mask_makes_a_file_alone_equal_its_row_in_the_batch(setup):
    """sine_a and sine_b share a grid, so they share a program; sine_b's
    rows past its own frame count are masked, so its embedding alone (its
    own program) equals its row in the batch, and the JAX package's."""
    name, sr, root, fad, jax_fad, _ = setup
    a, b = (audio_io.load_audio(str(root / "bg" / f"{f}.wav"), sr, 1) for f in ("sine_a", "sine_b"))
    batch = fad.get_embeddings([a, b], sr)
    alone = fad._get_embedding_for_audio(b)
    assert alone.shape == (1, 2048)
    np.testing.assert_allclose(batch[1:], alone, rtol=0, atol=1e-5)
    np.testing.assert_allclose(alone, jax_fad._get_embedding_for_audio(b), rtol=0, atol=1e-4)


def test_too_short_clip_is_swallowed_unless_strict(setup):
    name, sr, root, fad, _, _ = setup
    tiny = audio_io.load_audio(str(root / "bg" / "tiny.wav"), sr, 1)
    with pytest.raises(ValueError, match="too short"):
        fad._get_embedding_for_audio(tiny)
    assert fad.get_embeddings([tiny], sr).size == 0


@pytest.mark.parametrize("mode", ["host", "device_stats"])
def test_score_matches_jax(setup, mode):
    name, sr, root, fad, _, jax_score = setup
    ours = fad.score(str(root / "bg"), str(root / "ev"), device_stats=mode == "device_stats")
    assert ours != -1 and np.isfinite(ours) and ours > 0
    _agree(ours, jax_score)


def test_embedding_cache_round_trip(setup, tmp_path):
    name, sr, root, fad, _, jax_score = setup
    bg, ev = str(root / "bg"), str(root / "ev")
    bg_npy, ev_npy = str(tmp_path / "c" / "bg.npy"), str(tmp_path / "c" / "ev.npy")
    first = fad.score(bg, ev, bg_npy, ev_npy)
    _agree(first, jax_score)
    assert np.load(bg_npy).shape == (3, 2048)  # one row per file; the tiny clip has none
    assert np.load(ev_npy).shape == (3, 2048)
    # The second call must read the caches: empty dirs would otherwise give -1.
    empty = str(root / "empty")
    assert fad.score(empty, empty, bg_npy, ev_npy) == first


def test_frame_cap_raises_and_scores_the_sentinel(setup, monkeypatch):
    """Above the frame cap a file is refused loudly: the single-file hook
    raises, score() swallows it per file and a directory of only that file
    gives -1, as in the JAX package."""
    name, sr, root, fad, jax_fad, _ = setup
    monkeypatch.setattr(pipeline, "PANN_MAX_FRAMES", 50)
    monkeypatch.setattr(jax_pipeline, "PANN_MAX_FRAMES", 50)
    audio = audio_io.load_audio(str(root / "long_only" / "x.wav"), sr, 1)
    for calc in (fad, jax_fad):
        with pytest.raises(ValueError, match="too long"):
            calc._get_embedding_for_audio(audio)
        assert calc.score(str(root / "long_only"), str(root / "ev")) == -1


def test_warmup_runs_on_the_plain_path(setup):
    fad = setup[3]
    before = launches.read()["fused_pann_logmel"]
    fad.warmup(durations=(0.5,), num_files=2)
    assert launches.read()["fused_pann_logmel"] == before
