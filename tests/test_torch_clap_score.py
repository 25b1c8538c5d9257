"""The CLAP slice end to end: the port and the JAX package on the same weights
and the same WAV corpora, on the CPU.

Both packages load one full-width CLAP bundle that the JAX package wrote with
save_weights (the perturbed tree of test_torch_clap_model.clap_tree), through
weights="auto". The corpora hold 48 kHz clips (the int16 wire on CLAP's
k/32767 grid) and a 12 s clip (truncated to the 1001-frame read window); a
16 kHz clip goes through get_embeddings with sr=16000 (the resample path),
and an in-memory clip with samples past full scale checks the int16 cast.
Every clip is padded to 10 s, so each costs a full 1001-frame forward: the
fixtures are module-scoped and the corpora small.

Bounds: embeddings atol 1e-4 (float32 on both sides, different summation
orders); FAD within 1e-3 absolute (the bar in BASELINE.md) and 1e-3
relative; device_stats within 1e-3 relative of the host path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from frechet_audio_distance_exported_tpu import FrechetAudioDistance as JaxFAD  # noqa: E402
from frechet_audio_distance_exported_tpu.ops import frontends as jax_fe  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import audio_io as jax_io  # noqa: E402
from frechet_audio_distance_exported_tpu.utils.weights import save_weights  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import frontends as fe  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import launches  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import audio_io  # noqa: E402
from test_torch_clap_model import clap_tree  # noqa: E402

SR = 48000
EMB_ATOL = 1e-4

# name -> (directory, seconds, sine Hz or None for noise)
FILES = {
    "sine_a": ("bg", 1.0, 440.0),
    "sine_b": ("bg", 2.5, 660.0),
    "sine_long": ("bg", 12.0, 550.0),  # past 10 s: truncated to the read window
    "noise_a": ("ev", 1.0, None),
    "noise_b": ("ev", 3.0, None),
    "noise_c": ("ev", 0.5, None),
}


def _agree(a, b, rel=1e-3, abs_=1e-3):
    assert abs(a - b) <= abs_, (a, b)
    assert abs(a - b) <= rel * max(abs(a), abs(b)) + 1e-12, (a, b)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(corpus root, port FAD, JAX FAD, JAX host score)."""
    root = tmp_path_factory.mktemp("clap")
    for d in ("bg", "ev", "ck"):
        (root / d).mkdir()
    save_weights(str(root / "ck" / "clap_tpu.npz"), clap_tree(seed=1))
    rng = np.random.default_rng(0)
    for name, (d, dur, freq) in FILES.items():
        n = int(SR * dur)
        if freq is None:
            clip = rng.standard_normal(n) * 0.1
        else:
            clip = 0.5 * np.sin(2 * np.pi * freq * np.arange(n) / SR)
        audio_io.write_wav(str(root / d / f"{name}.wav"), clip.astype(np.float32), SR)
    ck = str(root / "ck")
    ours = FrechetAudioDistance(model_name="clap", weights="auto", ckpt_dir=ck, device="cpu")
    ref = JaxFAD(model_name="clap", weights="auto", ckpt_dir=ck)
    score = ref.score(str(root / "bg"), str(root / "ev"))
    yield root, ours, ref, score


def test_embeddings_match_jax(setup):
    root, fad, jax_fad, _ = setup
    ours_audio = [audio_io.load_audio(str(root / d / f"{f}.wav"), SR, 1)
                  for f, (d, *_) in FILES.items()]
    jax_audio = [jax_io.load_audio(str(root / d / f"{f}.wav"), SR, 1)
                 for f, (d, *_) in FILES.items()]
    for a, b in zip(ours_audio, jax_audio):
        np.testing.assert_array_equal(a, b)
    ours = fad.get_embeddings(ours_audio, SR)
    ref = jax_fad.get_embeddings(jax_audio, SR)
    assert ours.shape == ref.shape == (len(FILES), 512)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=1), 1.0, rtol=1e-5)
    assert np.abs(ours - ours[0]).max() > 100 * EMB_ATOL  # the clips embed apart
    np.testing.assert_allclose(ours, ref, rtol=0, atol=EMB_ATOL)


def test_resample_path_and_int16_cast_match_jax(setup):
    """A 16 kHz clip (quantized, then resampled to 48 kHz on the host) and a
    48 kHz clip with samples past full scale (numpy's int16 cast), in memory."""
    _, fad, jax_fad, _ = setup
    rng = np.random.default_rng(5)
    low = (0.3 * np.sin(2 * np.pi * 330.0 * np.arange(int(16000 * 1.5)) / 16000)).astype(np.float32)
    loud = (rng.standard_normal(SR) * 0.6).astype(np.float32)
    loud[:50] = np.linspace(-1.8, 1.8, 50, dtype=np.float32)
    assert np.abs(loud).max() > 1.0
    ours = fad.get_embeddings([low], 16000)
    ref = jax_fad.get_embeddings([low], 16000)
    assert ours.shape == (1, 512)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=EMB_ATOL)
    ours = fad.get_embeddings([loud], SR)
    np.testing.assert_allclose(ours, jax_fad.get_embeddings([loud], SR), rtol=0, atol=EMB_ATOL)


@pytest.mark.parametrize("mode", ["host", "device_stats"])
def test_score_matches_jax(setup, mode):
    root, fad, _, jax_score = setup
    ours = fad.score(str(root / "bg"), str(root / "ev"), device_stats=mode == "device_stats")
    assert ours != -1 and np.isfinite(ours) and ours > 0
    _agree(ours, jax_score)


def test_device_stats_matches_the_host_path(setup):
    root, fad, _, _ = setup
    host = fad.score(str(root / "bg"), str(root / "ev"))
    streamed = fad.score(str(root / "bg"), str(root / "ev"), device_stats=True)
    assert abs(streamed - host) <= 1e-3 * abs(host)


def test_clap_logmel_batch_matches_jax():
    """The 48 kHz frontend on CLAP's int16 wire (k/32767), 1001 frames."""
    rng = np.random.default_rng(2)
    wave = np.clip(np.round(rng.standard_normal((2, 1000 * 480 + 1024)) * 3000), -32768, 32767)
    wave = wave.astype(np.int16)
    n_valid = np.array([1001, 400], np.int32)
    ours = fe.clap_logmel_batch(torch.from_numpy(wave), torch.from_numpy(n_valid)).numpy()
    ref = np.asarray(jax_fe.pann_logmel_batch(
        jnp.asarray(wave), 48000, 1001, jnp.asarray(n_valid), i16_full_scale=32767.0, impl="xla"))
    assert ours.shape == (2, 1001, 64)
    assert not ours[1, 400:].any()
    p_ours = 10.0 ** (ours[:, :400].astype(np.float64) / 10.0)
    p_ref = 10.0 ** (ref[:, :400].astype(np.float64) / 10.0)
    assert np.abs(p_ours - p_ref).max() <= 1e-6 * p_ref.max()


def test_cpu_run_launches_no_kernel(setup):
    _, fad, _, _ = setup
    before = launches.read()
    fad.warmup(durations=(0.5,), num_files=2)
    assert launches.read() == before
