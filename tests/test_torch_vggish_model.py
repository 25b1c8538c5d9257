"""The port's VGGish module against the JAX forward, on the same weights.

VGGish has no width knob, so it runs at full width here; at a few patches
that is cheap. Bound: rtol/atol 1e-4 (float32 on both sides; convolution
and matmul summation orders differ between XLA and torch on the CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frechet_audio_distance_exported_tpu.models.vggish import (  # noqa: E402
    init_vggish_params,
    vggish_forward,
)
from frechet_audio_distance_exported_tpu.utils.weights import save_weights  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.models.vggish import (  # noqa: E402
    CONV_CFG,
    FC_DIMS,
    VGGish,
)
from frechet_audio_distance_exported_tpu_torch import registry  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import weights  # noqa: E402


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, init_vggish_params(jax.random.PRNGKey(0)))


def vggish_tree(seed=0):
    """A JAX-layout VGGish pytree drawn with numpy (HWIO convolutions, [in,
    out] linears), uniform(±1/sqrt(fan_in)) like the JAX initializer: a
    bundle for save_weights in a fraction of init_random_params' time."""
    rng = np.random.default_rng(seed)

    def layer(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return {"w": rng.uniform(-bound, bound, shape).astype(np.float32),
                "b": rng.uniform(-bound, bound, shape[-1:]).astype(np.float32)}

    features, cin = [], 1
    for v in CONV_CFG:
        if v != "M":
            features.append(layer((3, 3, cin, v), 9 * cin))
            cin = v
    return {"features": features, "embeddings": [layer((i, o), i) for i, o in FC_DIMS]}


def _module(state):
    with torch.device("meta"):  # no throwaway init of 72M parameters
        model = VGGish()
    model.load_state_dict(state, assign=True)
    return model.eval()


def _patches(n, seed=0):
    return (np.random.default_rng(seed).standard_normal((n, 96, 64)) * 2.0 - 3.0).astype(
        np.float32
    )


@pytest.mark.parametrize("n", [2, 4])
def test_forward_matches_jax(jax_params, n):
    x = _patches(n, seed=n)
    ref = np.asarray(vggish_forward(jax_params, jnp.asarray(x)))
    with torch.inference_mode():
        ours = _module(weights.params_from_jax(jax_params))(torch.from_numpy(x)).numpy()
    assert ours.shape == (n, 128)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_transposed_input_raises(jax_params):
    model = _module(weights.params_from_jax(jax_params))
    with pytest.raises(ValueError, match="96, 64"):
        model(torch.zeros((2, 64, 96)))


def test_npz_bundle_loads_to_the_same_outputs(jax_params, tmp_path):
    path = tmp_path / "vggish_tpu.npz"
    save_weights(str(path), jax_params)
    loaded = weights.load_weights(str(path))
    bridged = weights.params_from_jax(jax_params)
    assert loaded.keys() == bridged.keys()
    x = torch.from_numpy(_patches(2, seed=9))
    with torch.inference_mode():
        assert torch.equal(_module(loaded)(x), _module(bridged)(x))


def test_random_init_fits_the_module_and_is_deterministic():
    a = weights.init_random_params("vggish", seed=3)
    b = weights.init_random_params("vggish", seed=3)
    with torch.device("meta"):
        expected = {k: tuple(v.shape) for k, v in VGGish().state_dict().items()}
    assert {k: tuple(v.shape) for k, v in a.items()} == expected
    assert all(torch.equal(a[k], b[k]) for k in a)
    bound = 1.0 / np.sqrt(12288)
    assert float(a["embeddings.0.weight"].abs().max()) <= bound


def test_get_params_modes(jax_params, tmp_path):
    with pytest.raises(FileNotFoundError, match="vggish_tpu.npz"):
        weights.get_params("vggish", str(tmp_path), weights="auto")
    (tmp_path / "vggish_tpu.npz").write_bytes(b"not an npz")
    with pytest.raises(RuntimeError, match="failed to load"):
        weights.get_params("vggish", str(tmp_path), weights="auto")
    save_weights(str(tmp_path / "vggish_tpu.npz"), jax_params)
    state = weights.get_params("vggish", str(tmp_path), weights="auto")
    assert torch.equal(state["features.0.bias"], torch.tensor(jax_params["features"][0]["b"]))
    with pytest.raises(ValueError, match="weights"):
        weights.get_params("vggish", str(tmp_path), weights="download")
    # Every valid name is ported: random weights resolve for each of them.
    assert set(registry.VALID_MODELS) == set(registry.PORTED_MODELS)
    for name in registry.VALID_MODELS:
        assert weights.get_params(name, str(tmp_path), weights="random")


def test_numpy_tree_loads_in_both_packages(tmp_path):
    """vggish_tree writes a bundle that both packages load to the same forward."""
    from frechet_audio_distance_exported_tpu.utils.weights import load_weights

    path = str(tmp_path / "vggish_tpu.npz")
    save_weights(path, vggish_tree(seed=3))
    tree = load_weights(path)
    x = _patches(2, seed=9)
    ref = np.asarray(vggish_forward(tree, jnp.asarray(x)))
    with torch.inference_mode():
        ours = _module(weights.params_from_jax(tree))(torch.from_numpy(x)).numpy()
    assert float(np.abs(ref).mean()) > 1e-4
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
