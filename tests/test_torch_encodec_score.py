"""The Encodec slice end to end: the port and the JAX package on the same
weights and the same WAV corpora, on the CPU.

Both packages load one JAX-written bundle per rate (the perturbed trees of
test_torch_encodec_model.encodec_tree) through weights="auto". The corpora:
- encodec-24k: mono 24 kHz clips of 2.5 s and 10 s (sines) and 0.3 and
  4 s (noise), plus a 12 s clip that a batch skips;
- encodec-48k: the same make-up in stereo at 48 kHz (the two channels
  differ), read with channels=2.
Every file is padded to 10 s, so each costs a full 10 s forward: the
fixtures are module-scoped and the corpora small.

Bounds: frame embeddings atol 1e-4 (float32 on both sides, different
summation orders); FAD within 1e-3 absolute (the bar in BASELINE.md) and
1e-3 relative; device_stats within 1e-3 relative of the host path and of
the JAX package's device_stats. The device_stats score is not held to 1e-3
absolute: these weights give FADs of order 100 from covariances with small
eigenvalues, whose square roots amplify the float32 statistics' rounding,
so the streamed score sits 3e-4 to 6e-4 relative from the float64 host
path's in both packages (the JAX package's own device_stats included).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from frechet_audio_distance_exported_tpu import FrechetAudioDistance as JaxFAD  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import audio_io as jax_io  # noqa: E402
from frechet_audio_distance_exported_tpu.utils.weights import save_weights  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import pipeline  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import launches  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import audio_io  # noqa: E402
from test_torch_encodec_model import encodec_tree  # noqa: E402

EMB_ATOL = 1e-4
HOP = 320

# name -> (directory, seconds, sine Hz or None for noise)
FILES = {
    "sine_a": ("bg", 2.5, 440.0),
    "sine_b": ("bg", 10.0, 660.0),
    "sine_long": ("bg", 12.0, 550.0),  # past 10 s: skipped by the batch
    "noise_b": ("ev", 4.0, None),
    "noise_c": ("ev", 0.3, None),
}
KEPT = [name for name, (_, dur, _) in FILES.items() if dur <= 10.0]


def _agree(a, b, rel=1e-3, abs_=1e-3):
    assert abs(a - b) <= abs_, (a, b)
    assert abs(a - b) <= rel * max(abs(a), abs(b)) + 1e-12, (a, b)


def _clip(sr, dur, freq, channels, rng):
    n = int(sr * dur)
    if freq is None:
        mono = rng.standard_normal(n) * 0.1
        other = rng.standard_normal(n) * 0.1
    else:
        t = np.arange(n) / sr
        mono = 0.5 * np.sin(2 * np.pi * freq * t)
        other = 0.3 * np.sin(2 * np.pi * 1.5 * freq * t)
    clip = mono if channels == 1 else np.stack([mono, other], axis=1)
    return clip.astype(np.float32)


class Slice:
    """One rate's corpora, the two calculators and both host scores."""

    def __init__(self, root, model, sr, channels):
        self.root, self.model, self.sr, self.channels = root, model, sr, channels
        for d in ("bg", "ev"):
            (root / d).mkdir()
        rng = np.random.default_rng(sr)
        for name, (d, dur, freq) in FILES.items():
            audio_io.write_wav(str(root / d / f"{name}.wav"),
                               _clip(sr, dur, freq, channels, rng), sr)
        ck = str(root.parent / "ck")
        self.fad = FrechetAudioDistance(model_name=model, weights="auto", ckpt_dir=ck,
                                        channels=channels, device="cpu")
        self.jax_fad = JaxFAD(model_name=model, weights="auto", ckpt_dir=ck, channels=channels)
        self.jax_score = self.jax_fad.score(self.dir("bg"), self.dir("ev"))
        self.score = self.fad.score(self.dir("bg"), self.dir("ev"))

    def dir(self, d):
        return str(self.root / d)

    def audio(self, names, io=audio_io):
        return [io.load_audio(str(self.root / FILES[f][0] / f"{f}.wav"), self.sr, self.channels)
                for f in names]


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    root = tmp_path_factory.mktemp("encodec")
    (root / "ck").mkdir()
    for sr in (24000, 48000):
        save_weights(str(root / "ck" / f"encodec_{sr // 1000}k_tpu.npz"), encodec_tree(sr, seed=1))
    return root


@pytest.fixture(scope="module", params=["24k", "48k"])
def slice_(request, bundles):
    sr, channels = {"24k": (24000, 1), "48k": (48000, 2)}[request.param]
    root = bundles / request.param
    root.mkdir()
    return Slice(root, f"encodec-{request.param}", sr, channels)


def test_embeddings_match_jax(slice_):
    """Every file of both corpora, the 12 s one included (skipped on both
    sides): one row per 320 samples of each kept file."""
    names = list(FILES)
    ours_audio = slice_.audio(names)
    for a, b in zip(ours_audio, slice_.audio(names, jax_io)):
        np.testing.assert_array_equal(a, b)
    assert ours_audio[0].ndim == slice_.channels  # stereo files stay stereo with channels=2
    ours = slice_.fad.get_embeddings(ours_audio, slice_.sr)
    ref = slice_.jax_fad.get_embeddings(ours_audio, slice_.sr)
    rows = sum(int(FILES[f][1] * slice_.sr) // HOP for f in KEPT)
    assert ours.shape == ref.shape == (rows, 128)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=EMB_ATOL)


def test_frame_count_and_trim_by_the_length_before_the_resample(slice_):
    """A 2.5 s clip keeps samples // 320 frames; a 16 kHz clip keeps
    int(len * sr / 16000) // 320, counted before the resample."""
    fad, sr = slice_.fad, slice_.sr
    clip = _clip(sr, 2.5, 440.0, 1, None)
    out = fad._get_embedding_for_audio(clip)
    assert out.shape == (int(sr * 2.5) // HOP, 128)
    low = _clip(16000, 1.37, 330.0, 1, None)
    ours = fad.get_embeddings([low], 16000)
    ref = slice_.jax_fad.get_embeddings([low], 16000)
    assert ours.shape == ref.shape == (int(len(low) * sr / 16000) // HOP, 128)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=EMB_ATOL)


def test_too_long_is_skipped_in_a_batch_and_raises_alone(slice_):
    fad, sr = slice_.fad, slice_.sr
    long = _clip(sr, 10.5, 440.0, slice_.channels, None)
    ok = _clip(sr, 1.0, 440.0, slice_.channels, None)
    out = fad.get_embeddings([long, ok], sr)
    assert out.shape == (sr // HOP, 128)
    with pytest.raises(ValueError, match="Audio too long"):
        fad._get_embedding_for_audio(long)


def test_batching_invariance(slice_):
    """One file per program against all files in one program (the same rows
    for each file; the padded batch rows never leak into them)."""
    audio = slice_.audio(["sine_a", "noise_c"])
    joint = slice_.fad.get_embeddings(audio, slice_.sr)
    alone = pipeline.EmbeddingPipeline(slice_.model, slice_.fad.model, "cpu", file_batch=1)
    solo = np.concatenate(alone.embed_files(audio, slice_.sr), axis=0)
    np.testing.assert_allclose(joint, solo, rtol=0, atol=1e-5)


def test_score_matches_jax(slice_):
    ours = slice_.score
    assert ours != -1 and np.isfinite(ours) and ours > 0
    _agree(ours, slice_.jax_score)
    assert slice_.fad.score(slice_.dir("bg"), slice_.dir("bg")) < 1e-6


def test_device_stats_matches_the_host_path_and_jax(slice_):
    host = slice_.score
    streamed = slice_.fad.score(slice_.dir("bg"), slice_.dir("ev"), device_stats=True)
    assert streamed != -1 and np.isfinite(streamed)
    assert abs(streamed - host) <= 1e-3 * abs(host)
    jax_streamed = slice_.jax_fad.score(slice_.dir("bg"), slice_.dir("ev"), device_stats=True)
    assert abs(streamed - jax_streamed) <= 1e-3 * abs(jax_streamed)


def test_cpu_run_launches_no_kernel_and_warms_up(slice_):
    before = launches.read()
    slice_.fad.warmup(durations=(0.5,), num_files=1)
    assert launches.read() == before
    assert slice_.fad.pipeline.file_batch == pipeline.EncodecFamily.file_batch["cpu"] == 16


@pytest.fixture(scope="module")
def stereo_readings(bundles):
    """A stereo 48 kHz file whose channels differ, and the port's rows of it
    read with channels=1 and with channels=2."""
    path = bundles / "stereo.wav"
    audio_io.write_wav(str(path), _clip(48000, 1.5, 300.0, 2, None), 48000)
    rows = {}
    for c in (1, 2):
        fad = FrechetAudioDistance(model_name="encodec-48k", weights="auto",
                                   ckpt_dir=str(bundles / "ck"), channels=c, device="cpu")
        audio = audio_io.load_audio(str(path), 48000, c)
        assert audio.ndim == (1 if c == 1 else 2)
        rows[c] = fad.get_embeddings([audio], 48000)
    assert np.abs(rows[1] - rows[2]).max() > 100 * EMB_ATOL  # the two readings embed apart
    return path, rows


@pytest.mark.parametrize("channels", [1, 2])
def test_48k_stereo_file_read_with_one_or_two_channels(bundles, stereo_readings, channels):
    """channels=2 keeps both channels; channels=1 mono-mixes the file as it
    is loaded (the rank-vs-channels rule of load_audio), and the pipeline
    duplicates the mix to two channels. Each matches the JAX package."""
    path, rows = stereo_readings
    jax_fad = JaxFAD(model_name="encodec-48k", weights="auto", ckpt_dir=str(bundles / "ck"),
                     channels=channels)
    ref = jax_fad.get_embeddings([jax_io.load_audio(str(path), 48000, channels)], 48000)
    assert rows[channels].shape == ref.shape == (int(48000 * 1.5) // HOP, 128)
    np.testing.assert_allclose(rows[channels], ref, rtol=0, atol=EMB_ATOL)

def report() -> None:
    """Print both packages' host and device_stats scores of the corpora
    above: JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_encodec_score.py."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "ck").mkdir()
        for tag, sr, channels in (("24k", 24000, 1), ("48k", 48000, 2)):
            save_weights(str(root / "ck" / f"encodec_{tag}_tpu.npz"), encodec_tree(sr, seed=1))
            (root / tag).mkdir()
            s = Slice(root / tag, f"encodec-{tag}", sr, channels)
            streamed = s.fad.score(s.dir("bg"), s.dir("ev"), device_stats=True)
            jax_streamed = s.jax_fad.score(s.dir("bg"), s.dir("ev"), device_stats=True)
            print(f"encodec-{tag}: host {s.score!r} (JAX {s.jax_score!r}); device_stats "
                  f"{streamed!r} (JAX {jax_streamed!r}); device_stats vs host "
                  f"{abs(streamed - s.score) / s.score:.3e} relative "
                  f"(JAX {abs(jax_streamed - s.jax_score) / s.jax_score:.3e})")


if __name__ == "__main__":
    report()
