"""The Fréchet epilogues of the port against the JAX package's, on the CPU.

1. FAD_TPU_EXACT_SQRTM: with it set, score() takes the reference's scipy
   route (frechet_distance_np) and the low-rank fast path stands down, in
   both packages (JAX config.py:77-80, fad.py:182-185 and L272); without it,
   a pair with fewer rows than dimensions takes the low-rank route in both.
   Spies on each package's functions show the route. Fed the same
   embeddings, the two packages' scores agree within 1e-12 relative (the
   same float64 algorithm); on their own embeddings, within the 1e-3 bar.
2. finalize_stats and frechet_distance_torch (eigh and Newton–Schulz)
   against finalize_stats and frechet_distance_jax on the same float32
   inputs: 1e-4 relative on an O(1) FAD; both against the float64 host
   route: 1e-3. The Newton–Schulz eps retry on a singular Σ.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from frechet_audio_distance_exported_tpu import FrechetAudioDistance as JaxFAD  # noqa: E402
from frechet_audio_distance_exported_tpu.ops import stats as jax_stats  # noqa: E402
from frechet_audio_distance_exported_tpu.utils.weights import save_weights  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.models.pann import BLOCK_CHANNELS  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import stats  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import audio_io  # noqa: E402
from test_torch_pann_model import cnn14_tree  # noqa: E402
from test_torch_vggish_model import vggish_tree  # noqa: E402

SR = 16000
MODELS = ("vggish", "pann-16k")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Three 1.2 s clips a side (VGGish: one patch each, 3 rows of 128; PANN:
    3 rows of 2048), one JAX-written bundle per model, both packages'
    calculators on it, and each package's own embeddings of each side in
    .npy caches, so a score reads them in place of running the model."""
    root = tmp_path_factory.mktemp("epilogue")
    for d in ("bg", "ev", "ck", "empty"):
        (root / d).mkdir()
    rng = np.random.default_rng(0)
    t = np.arange(int(SR * 1.2)) / SR
    for i in range(3):
        audio_io.write_wav(str(root / "bg" / f"{i}.wav"),
                           0.5 * np.sin(2 * np.pi * (440.0 + 50 * i) * t), SR)
        audio_io.write_wav(str(root / "ev" / f"{i}.wav"), rng.standard_normal(t.size) * 0.1, SR)
    save_weights(str(root / "ck" / "vggish_tpu.npz"), vggish_tree())
    save_weights(str(root / "ck" / "pann_cnn14_16k_tpu.npz"),
                 cnn14_tree(channels=BLOCK_CHANNELS, conv_gain=1.0))
    fads, caches = {}, {}
    for model in MODELS:
        ck = str(root / "ck")
        fads[model] = (
            JaxFAD(model_name=model, weights="auto", ckpt_dir=ck),
            FrechetAudioDistance(model_name=model, weights="auto", ckpt_dir=ck, device="cpu"),
        )
        for pkg, fad in zip(("jax", "torch"), fads[model]):
            caches[model, pkg] = []
            for side in ("bg", "ev"):
                path = str(root / f"{model}_{pkg}_{side}.npy")
                audio = fad._load_audio_files(str(root / side))
                np.save(path, fad.get_embeddings(audio, SR))
                caches[model, pkg].append(path)
    return root, fads, caches


def _spy(monkeypatch, calls, pkg, module, name, target):
    def spy(*args, **kwargs):
        calls.append((pkg, name, args))
        return target(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("exact", [False, True])
def test_exact_sqrtm_takes_the_same_route_in_both_packages(setup, monkeypatch, model, exact):
    root, fads, caches = setup
    if exact:
        monkeypatch.setenv("FAD_TPU_EXACT_SQRTM", "1")
    else:
        monkeypatch.delenv("FAD_TPU_EXACT_SQRTM", raising=False)
    calls = []
    # scipy's sqrtm at d = 2048 takes about 23 s a call on an 8-core CPU, so for
    # pann-16k the spy records the route and its statistics and returns 0.
    skip = model == "pann-16k" and exact
    for pkg, module in (("jax", jax_stats), ("torch", stats)):
        exact_fn = (lambda *a, **k: 0.0) if skip else module.frechet_distance_np
        _spy(monkeypatch, calls, pkg, module, "frechet_distance_np", exact_fn)
        _spy(monkeypatch, calls, pkg, module, "frechet_distance_lowrank_np",
             module.frechet_distance_lowrank_np)
    jax_fad, fad = fads[model]
    empty = str(root / "empty")
    ref = jax_fad.score(empty, empty, *caches[model, "jax"])
    ours = fad.score(empty, empty, *caches[model, "torch"])
    route = "frechet_distance_np" if exact else "frechet_distance_lowrank_np"
    assert [c[:2] for c in calls] == [("jax", route), ("torch", route)]
    if skip:  # the same statistics went to both packages' scipy route
        for a, b in zip(calls[0][2], calls[1][2]):
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-5)
        return
    assert ours != -1 and ref != -1
    assert abs(ours - ref) <= 1e-3 and abs(ours - ref) <= 1e-3 * abs(ref), (ours, ref)


@pytest.mark.parametrize("exact", [False, True])
def test_same_embeddings_give_the_same_score(setup, tmp_path, monkeypatch, exact):
    """Both packages read one pair of .npy caches (5 and 7 rows of 128, fewer
    rows than dims): the same float64 algorithm, scipy's under the knob."""
    root, fads, _ = setup
    if exact:
        monkeypatch.setenv("FAD_TPU_EXACT_SQRTM", "1")
    else:
        monkeypatch.delenv("FAD_TPU_EXACT_SQRTM", raising=False)
    rng = np.random.default_rng(1)
    paths = [str(tmp_path / "bg.npy"), str(tmp_path / "ev.npy")]
    np.save(paths[0], rng.standard_normal((5, 128)).astype(np.float32))
    np.save(paths[1], (rng.standard_normal((7, 128)) * 1.3 + 0.2).astype(np.float32))
    empty = str(root / "empty")
    jax_fad, fad = fads["vggish"]
    ref = jax_fad.score(empty, empty, *paths)
    ours = fad.score(empty, empty, *paths)
    assert ref > 1.0
    assert abs(ours - ref) <= 1e-12 * abs(ref), (ours, ref)


def test_finalize_stats_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((50, 16)) * 2.0 + 5.0).astype(np.float32)
    mask = np.ones(50, np.float32)
    mask[-7:] = 0.0
    ours = stats.init_update_stats(torch.from_numpy(x), torch.from_numpy(mask))
    ref = jax_stats.init_update_stats(jnp.asarray(x), jnp.asarray(mask))
    for a, b in zip(stats.finalize_stats(ours), jax_stats.finalize_stats(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    mu, sigma = stats.finalize_stats(ours)
    np.testing.assert_allclose(mu.numpy(), x[:-7].mean(0), rtol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), np.cov(x[:-7].astype(np.float64), rowvar=False),
                               rtol=1e-5, atol=1e-5)
    empty = stats.init_stats(4, shift=torch.ones(4))
    assert empty.ss.shape == (4, 4) and float(empty.n) == 0.0 and empty.shift.tolist() == [1.0] * 4


def _o1_stats(d, seed):
    """(μ, Σ) pairs in float64 from 4d samples each: Σ₂ about 2.25 Σ₁ and the
    means 0.5 apart per dim, so the FAD is about d/2 against traces of about
    3d (no deep cancellation)."""
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((4 * d, d))
    x2 = rng.standard_normal((4 * d, d)) * 1.5 + 0.5
    return x1.mean(0), np.cov(x1, rowvar=False), x2.mean(0), np.cov(x2, rowvar=False)


@pytest.mark.parametrize("d", [16, 64, 256])
@pytest.mark.parametrize("method", ["eigh", "newton_schulz"])
def test_frechet_distance_torch_matches_jax(d, method):
    f64 = _o1_stats(d, seed=d)
    f32 = [a.astype(np.float32) for a in f64]
    ours = float(stats.frechet_distance_torch(*map(torch.from_numpy, f32), method=method))
    ref = float(jax_stats.frechet_distance_jax(*map(jnp.asarray, f32), method=method))
    host = stats.frechet_distance_eigh_np(*f64)
    assert host > 0.1 * d
    assert abs(ours - ref) <= 1e-4 * abs(ref), (ours, ref)
    assert abs(ours - host) <= 1e-3 * host and abs(ref - host) <= 1e-3 * host, (ours, ref, host)


def test_eigh_route_decomposes_in_float64(monkeypatch):
    """The eigendecompositions run in float64 (with cuSOLVER's float32 ones
    the route was 1.8e-3 off at d = 512 on an NVIDIA H100 80GB HBM3 at
    700.00 W) and the result keeps the inputs' dtype."""
    seen = []
    for name in ("eigh", "eigvalsh"):
        real = getattr(torch.linalg, name)

        def spy(a, _real=real, **kwargs):
            seen.append(a.dtype)
            return _real(a, **kwargs)

        monkeypatch.setattr(torch.linalg, name, spy)
    f32 = [torch.from_numpy(a.astype(np.float32)) for a in _o1_stats(32, seed=5)]
    out = stats.frechet_distance_torch(*f32)
    assert seen == [torch.float64, torch.float64] and out.dtype == torch.float32


def test_unknown_method_raises():
    z = torch.zeros(2)
    with pytest.raises(ValueError, match="method"):
        stats.frechet_distance_torch(z, torch.eye(2), z, torch.eye(2), method="ns")


def test_newton_schulz_retries_through_eigh_on_a_singular_product():
    """20 samples in 128 dims: Newton-Schulz goes non-finite, and the trace is
    taken again through eigh with eps on the diagonals, as JAX's does. The
    retry's eigendecompositions run in float64, so it matches the float64
    host route on the same eps-offset covariances; JAX's float32 retry is
    held to the JAX package's own bar on a singular Σ (test_stats.py:181)."""
    d, n = 128, 20
    rng = np.random.default_rng(11)
    x1 = rng.standard_normal((n, d))
    x2 = rng.standard_normal((n, d)) + 0.1
    f64 = (x1.mean(0), np.cov(x1, rowvar=False), x2.mean(0), np.cov(x2, rowvar=False))
    t32 = [torch.from_numpy(a.astype(np.float32)) for a in f64]
    assert not bool(torch.isfinite(stats._trace_sqrtm_product_ns(t32[1], t32[3])))
    ours = float(stats.frechet_distance_torch(*t32, method="newton_schulz"))
    eps = torch.eye(d) * 1e-6
    retried = stats._trace_sqrtm_product_eigh(t32[1] + eps, t32[3] + eps)
    by_hand = float(torch.dot(t32[0] - t32[2], t32[0] - t32[2]) + torch.trace(t32[1])
                    + torch.trace(t32[3]) - 2.0 * retried)
    ref = float(jax_stats.frechet_distance_jax(*(jnp.asarray(a, jnp.float32) for a in f64),
                                               method="newton_schulz"))
    offset = [a.double().numpy() for a in (t32[0], t32[1] + eps, t32[2], t32[3] + eps)]
    host = stats.frechet_distance_eigh_np(*offset)
    assert np.isfinite(ours) and ours == by_hand
    assert abs(ours - host) <= 1e-5 * host, (ours, host)
    assert np.isfinite(ref) and abs(ref - host) <= 5e-2 * host, (ref, host)
