"""The host runtime end to end: VGGish scores of mixed-format directories at
44.1 and 22.05 kHz, the port against the JAX package on the CPU.

Each side holds one file per container (FLAC 16 and 24-bit, FLAC after an
ID3v2 tag, AIFF, AIFC float, AU mu-law, CAF, RF64, Wave64, WAV float), so
every file is decoded, mixed to mono and resampled to 16 kHz by the native
C resampler in both packages. Both load one JAX-written bundle through
weights="auto". Bounds: the decoded waveforms np.array_equal (the same
decoders and the same C code), per-file embeddings atol 1e-4, FAD within
1e-3 absolute and relative (the bar in BASELINE.md).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from frechet_audio_distance_exported_tpu import FrechetAudioDistance as JaxFAD  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import weights as jax_weights  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import native  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import aiff, au, audio_io, caf, flac, wav64  # noqa: E402
from test_torch_codecs import PORT, _id3_flac  # noqa: E402
from test_torch_vggish_model import vggish_tree  # noqa: E402

RATES = (44100, 22050)
SECONDS = 2.0


def _writers():
    return {
        "a.flac": lambda p, x, sr: flac.write_flac(p, x, sr),
        "b24.flac": lambda p, x, sr: flac.write_flac(p, x, sr, bits=24),
        "c_id3.flac": lambda p, x, sr: _id3_flac(PORT, p, x, sr),
        "d.aiff": lambda p, x, sr: aiff.write_aiff(p, x, sr),
        "e.aifc": lambda p, x, sr: aiff.write_aiff(p, x, sr, subtype="float32"),
        "f.au": lambda p, x, sr: au.write_au(p, x, sr, subtype="ulaw"),
        "g.caf": lambda p, x, sr: caf.write_caf(p, x, sr),
        "h.rf64": lambda p, x, sr: wav64.write_rf64(p, x, sr),
        "i.w64": lambda p, x, sr: wav64.write_w64(p, x, sr),
        "j.wav": lambda p, x, sr: audio_io.write_wav(p, x, sr, subtype="float32"),
    }


def _agree(a, b, rel=1e-3, abs_=1e-3):
    assert abs(a - b) <= abs_, (a, b)
    assert abs(a - b) <= rel * max(abs(a), abs(b)) + 1e-12, (a, b)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_score")
    (root / "ck").mkdir()
    jax_weights.save_weights(str(root / "ck" / "vggish_tpu.npz"), vggish_tree(seed=1))
    rng = np.random.default_rng(0)
    for sr in RATES:
        t = np.arange(int(sr * SECONDS)) / sr
        for side in ("bg", "ev"):
            d = root / f"{side}{sr}"
            d.mkdir()
            for i, (name, write) in enumerate(_writers().items()):
                if side == "bg":
                    freq = 220.0 * 2 ** (i / 5)
                    x = np.stack([0.5 * np.sin(2 * np.pi * freq * t),
                                  0.3 * np.sin(2 * np.pi * 1.5 * freq * t)], axis=1)
                else:
                    x = np.clip(rng.standard_normal((t.size, 2)) * 0.2, -1, 1)
                write(str(d / name), x, sr)
    return root


@pytest.fixture(scope="module")
def pair(corpora):
    ck = str(corpora / "ck")
    return (JaxFAD(model_name="vggish", weights="auto", ckpt_dir=ck),
            FrechetAudioDistance(model_name="vggish", weights="auto", ckpt_dir=ck, device="cpu"))


@pytest.mark.parametrize("side", ["bg", "ev"])
@pytest.mark.parametrize("sr", RATES)
def test_decoded_waveforms_and_embeddings_match_jax(pair, corpora, sr, side):
    assert native.available()
    jax_fad, fad = pair
    d = str(corpora / f"{side}{sr}")
    ours, ref = fad._load_audio_files(d), jax_fad._load_audio_files(d)
    assert len(ours) == len(ref) == len(_writers())
    for a, b in zip(ours, ref):
        assert a.shape == (int(16000 * SECONDS),) and np.array_equal(a, b)
    emb = fad.get_embeddings(ours, 16000)
    emb_ref = jax_fad.get_embeddings(ref, 16000)
    assert emb.shape == emb_ref.shape == (2 * len(ours), 128)
    np.testing.assert_allclose(emb, emb_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("device_stats", [False, True])
@pytest.mark.parametrize("sr", RATES)
def test_mixed_directories_score_as_in_jax(pair, corpora, sr, device_stats):
    jax_fad, fad = pair
    bg, ev = str(corpora / f"bg{sr}"), str(corpora / f"ev{sr}")
    score = fad.score(bg, ev, device_stats=device_stats)
    assert score != -1 and np.isfinite(score) and score > 0
    _agree(score, jax_fad.score(bg, ev, device_stats=device_stats))
