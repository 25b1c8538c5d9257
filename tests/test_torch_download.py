"""The port's download-on-miss and in-process artifact conversion, on the CPU.

Hermetic: only file:// URLs, as tests/test_download.py does. Checked:
- utils/download.py: a file:// round trip with a sha256 pin, a mismatch
  that leaves neither the file nor a .part behind, the FAD_TPU_OFFLINE
  refusal; it prints nothing (no progress bar);
- utils/weights.get_params(weights="auto") on a miss: a hosted bundle is
  downloaded, checked and cached; a corrupt one is removed and the next
  source tried; an artifact URL is downloaded and converted in process;
  the errors name the file, FAD_TPU_OFFLINE and the failed attempts;
- utils/convert.py on the non-slow replicas of tests/test_tools.py (a
  torchvggish-style .pth, an upstream Cnn14 .pth, traced Encodec .pt at 24
  and 48 kHz): the same tree as tools/extract_weights.py, and the port's
  module on it gives the JAX package's forward (atol 1e-4);
- a bundle the port writes loads in the JAX package, and the other way round.
"""

import hashlib
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frechet_audio_distance_exported_tpu.models.encodec import encodec_forward  # noqa: E402
from frechet_audio_distance_exported_tpu.models.pann import pann_forward  # noqa: E402
from frechet_audio_distance_exported_tpu.models.vggish import vggish_forward  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import weights as jax_weights  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import registry  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.models import encodec  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.models.pann import PANN  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.models.vggish import VGGish  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import convert, weights  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import download as dl  # noqa: E402
from test_tools import _build_torch_vggish  # noqa: E402
from test_torch_vggish_model import vggish_tree  # noqa: E402
from tools import extract_weights as ew  # noqa: E402
from torch_replicas import SEANetLike  # noqa: E402


@pytest.fixture
def online(monkeypatch):
    monkeypatch.delenv("FAD_TPU_OFFLINE", raising=False)


def _url(path) -> str:
    return pathlib.Path(path).as_uri()


def _flat_equal(a, b):
    fa, fb = jax_weights.flatten_params(a), jax_weights.flatten_params(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])), k


def test_file_url_round_trip_with_sha256(tmp_path, online, capsys):
    payload = bytes(range(256)) * 4099
    src = tmp_path / "src.bin"
    src.write_bytes(payload)
    dst = tmp_path / "sub" / "dst.bin"
    out = dl.download_url_to_file(_url(src), str(dst), sha256=hashlib.sha256(payload).hexdigest(),
                                  chunk_size=1000)
    assert out == str(dst) and dst.read_bytes() == payload
    assert not list(dst.parent.glob("*.part"))
    assert capsys.readouterr() == ("", "")  # no progress bar, no output


def test_sha256_mismatch_leaves_nothing(tmp_path, online):
    src = tmp_path / "src.bin"
    src.write_bytes(b"hello world")
    dst = tmp_path / "dst.bin"
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        dl.download_url_to_file(_url(src), str(dst), sha256="0" * 64)
    assert not dst.exists() and not list(tmp_path.glob("*.part"))


def test_offline_refuses(tmp_path, monkeypatch):
    monkeypatch.setenv("FAD_TPU_OFFLINE", "1")
    assert dl.offline()
    with pytest.raises(RuntimeError, match="FAD_TPU_OFFLINE"):
        dl.download_url_to_file(_url(tmp_path / "x"), str(tmp_path / "y"))
    monkeypatch.setenv("FAD_TPU_OFFLINE", "0")
    assert not dl.offline()


def test_offline_miss_names_the_file_and_the_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("FAD_TPU_OFFLINE", "1")
    monkeypatch.setitem(registry.WEIGHT_BUNDLE_URLS, "vggish", _url(tmp_path / "hosted.npz"))
    with pytest.raises(FileNotFoundError, match="vggish_tpu.npz.*FAD_TPU_OFFLINE"):
        weights.get_params("vggish", str(tmp_path), weights="auto")
    assert not list(tmp_path.iterdir())


def test_failed_downloads_are_reported(tmp_path, online, monkeypatch):
    monkeypatch.setitem(registry.WEIGHT_BUNDLE_URLS, "vggish", _url(tmp_path / "gone.npz"))
    monkeypatch.setitem(registry.EXPORTED_MODEL_URLS, "vggish", _url(tmp_path / "gone.pt2"))
    with pytest.raises(FileNotFoundError,
                       match="Download attempts failed: bundle .*gone.npz.*; artifact .*gone.pt2"):
        weights.get_params("vggish", str(tmp_path / "ck"), weights="auto")


def test_tables_match_the_jax_registry():
    from frechet_audio_distance_exported_tpu import registry as jax_registry

    for table in ("EXPORTED_MODEL_URLS", "EXPORTED_MODEL_SHA256", "WEIGHT_BUNDLE_URLS",
                  "WEIGHT_BUNDLE_SHA256", "REFERENCE_ARTIFACTS"):
        assert getattr(registry, table) == getattr(jax_registry, table), table
    for name in registry.VALID_MODELS:
        assert (registry.get_model_config(name).reference_artifact
                == jax_registry.get_model_config(name).reference_artifact)


def test_hosted_bundle_is_downloaded_and_cached(tmp_path, online, monkeypatch):
    tree = vggish_tree(seed=4)
    hosted = tmp_path / "hosted" / "vggish_tpu.npz"
    jax_weights.save_weights(str(hosted), tree)
    digest = hashlib.sha256(hosted.read_bytes()).hexdigest()
    monkeypatch.setitem(registry.WEIGHT_BUNDLE_URLS, "vggish", _url(hosted))
    monkeypatch.setitem(registry.WEIGHT_BUNDLE_SHA256, "vggish", digest)
    ck = tmp_path / "ck"
    state = weights.get_params("vggish", str(ck), weights="auto")
    assert (ck / "vggish_tpu.npz").read_bytes() == hosted.read_bytes()
    expected = weights.params_from_jax(tree)
    assert state.keys() == expected.keys()
    assert all(torch.equal(state[k], expected[k]) for k in state)


def test_a_corrupt_bundle_download_is_removed(tmp_path, online, monkeypatch):
    hosted = tmp_path / "hosted.npz"
    hosted.write_bytes(b"not an npz")
    monkeypatch.setitem(registry.WEIGHT_BUNDLE_URLS, "vggish", _url(hosted))
    monkeypatch.setitem(registry.EXPORTED_MODEL_URLS, "vggish", _url(tmp_path / "gone.pt2"))
    ck = tmp_path / "ck"
    with pytest.raises(FileNotFoundError, match="bundle .*failed to load"):
        weights.get_params("vggish", str(ck), weights="auto")
    assert not (ck / "vggish_tpu.npz").exists()


def test_bundles_cross_load_between_the_packages(tmp_path):
    tree = vggish_tree(seed=5)
    weights.save_weights(str(tmp_path / "port.npz"), tree)
    _flat_equal(jax_weights.load_weights(str(tmp_path / "port.npz")), tree)
    jax_weights.save_weights(str(tmp_path / "jax.npz"), tree)
    state = weights.load_weights(str(tmp_path / "jax.npz"), "vggish")
    expected = weights.params_from_jax(tree)
    assert all(torch.equal(state[k], expected[k]) for k in expected)
    assert (weights.flatten_params(tree).keys()
            == jax_weights.flatten_params(tree).keys())


# ---------------------------------------------------------------------------
# Artifacts converted in process: the replicas of tests/test_tools.py
# ---------------------------------------------------------------------------


def _pann_sd(seed):
    """An upstream Cnn14 checkpoint's state dict ({'model': ...}), as
    tests/test_tools.py::test_pann_pth_roundtrip builds it."""
    g = torch.Generator().manual_seed(seed)
    sd = {"bn0.weight": torch.rand(64, generator=g) + 0.5, "bn0.bias": torch.randn(64, generator=g),
          "bn0.running_mean": torch.randn(64, generator=g) * 0.1,
          "bn0.running_var": torch.rand(64, generator=g) + 0.5}
    chans = [(1, 64), (64, 128), (128, 256), (256, 512), (512, 1024), (1024, 2048)]
    for i, (cin, cout) in enumerate(chans, start=1):
        sd[f"conv_block{i}.conv1.weight"] = torch.randn(cout, cin, 3, 3, generator=g) * 0.05
        sd[f"conv_block{i}.conv2.weight"] = torch.randn(cout, cout, 3, 3, generator=g) * 0.02
        for bn in ("bn1", "bn2"):
            sd[f"conv_block{i}.{bn}.weight"] = torch.rand(cout, generator=g) + 0.5
            sd[f"conv_block{i}.{bn}.bias"] = torch.randn(cout, generator=g) * 0.1
            sd[f"conv_block{i}.{bn}.running_mean"] = torch.randn(cout, generator=g) * 0.1
            sd[f"conv_block{i}.{bn}.running_var"] = torch.rand(cout, generator=g) + 0.5
    sd["fc1.weight"] = torch.randn(2048, 2048, generator=g) * 0.01
    sd["fc1.bias"] = torch.randn(2048, generator=g) * 0.1
    return {"model": sd}


def _make_vggish(path):
    torch.manual_seed(3)
    torch.save(_build_torch_vggish().state_dict(), path)


def _make_pann(path):
    torch.save(_pann_sd(1), path)


def _make_encodec(channels, causal):
    def make(path):
        torch.manual_seed(2)
        model = SEANetLike(channels, causal).eval()
        torch.jit.trace(model, torch.randn(1, channels, 3200) * 0.1).save(str(path))
    return make


def _port_module(model_name, state):
    family = registry.get_model_config(model_name).family
    with torch.device("meta"):
        model = {"vggish": VGGish, "pann": PANN}[family]() if family != "encodec" else (
            encodec.encodec_for_rate(registry.get_model_config(model_name).sample_rate))
    model.load_state_dict(state, assign=True)
    return model.eval()


def _input(model_name, seed):
    rng = np.random.default_rng(seed)
    if model_name == "vggish":
        return (rng.standard_normal((2, 96, 64)) * 2.0 - 3.0).astype(np.float32)
    if model_name.startswith("pann"):
        return (rng.standard_normal((1, 104, 64)) * 10.0 - 40.0).astype(np.float32)
    channels = registry.VALID_MODELS[model_name]["channels"]
    return (rng.standard_normal((1, channels, 3200)) * 0.1).astype(np.float32)


def _jax_forward(model_name, tree, x):
    tree = jax.tree_util.tree_map(jnp.asarray, tree)
    if model_name == "vggish":
        return np.asarray(vggish_forward(tree, jnp.asarray(x)))
    if model_name.startswith("pann"):
        return np.asarray(pann_forward(tree, jnp.asarray(x)))
    return np.asarray(encodec_forward(tree, jnp.asarray(x), causal=model_name == "encodec-24k"))


ARTIFACTS = {
    "vggish": ("vggish-10086976.pth", _make_vggish),
    "pann-16k": ("Cnn14_16k.pth", _make_pann),
    "encodec-24k": ("encodec_24k_exported.pt", _make_encodec(1, True)),
    "encodec-48k": ("encodec_48k_exported.pt", _make_encodec(2, False)),
}


@pytest.mark.parametrize("model_name", sorted(ARTIFACTS))
def test_conversion_gives_the_jax_tree_and_forward(tmp_path, model_name):
    filename, make = ARTIFACTS[model_name]
    path = str(tmp_path / filename)
    make(path)
    ours = convert.extract(model_name, path)
    ref = ew.extract(model_name, path)
    _flat_equal(ours, ref)
    x = _input(model_name, seed=len(model_name))
    with torch.inference_mode():
        out = _port_module(model_name, weights.params_from_jax(ours))(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, _jax_forward(model_name, ref, x), rtol=0, atol=1e-4)


@pytest.mark.parametrize("model_name", ["encodec-24k", "encodec-48k"])
def test_artifact_url_is_downloaded_converted_and_cached(tmp_path, online, monkeypatch,
                                                          model_name):
    """get_params on a miss: the reference artifact from its URL, converted in
    process without tools/ or the JAX package, cached as a bundle that the
    JAX package loads to the JAX conversion's tree."""
    filename, make = ARTIFACTS[model_name]
    hosted = tmp_path / "hosted" / filename
    hosted.parent.mkdir()
    make(str(hosted))
    monkeypatch.setitem(registry.EXPORTED_MODEL_URLS, model_name, _url(hosted))
    ck = tmp_path / "ck"
    state = weights.get_params(model_name, str(ck), weights="auto")
    cfg = registry.get_model_config(model_name)
    assert (ck / cfg.reference_artifact).read_bytes() == hosted.read_bytes()
    bundle = ck / cfg.weight_filename
    ref = ew.extract(model_name, str(hosted))
    _flat_equal(jax_weights.load_weights(str(bundle)), ref)
    expected = weights.params_from_jax(ref)
    assert state.keys() == expected.keys()
    assert all(torch.equal(state[k], expected[k]) for k in state)
    # The next call loads the cached bundle; the artifact may go.
    (ck / cfg.reference_artifact).unlink()
    again = weights.get_params(model_name, str(ck), weights="auto")
    assert all(torch.equal(state[k], again[k]) for k in state)
