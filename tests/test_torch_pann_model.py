"""The port's PANN (CNN14) module against the JAX forward, on the same weights.

A narrow CNN14 (channels 8 -> 256) runs here, built as a numpy pytree with
every BatchNorm field perturbed: the JAX initializer makes BN the identity,
so a random JAX bundle alone could not reveal a swapped gamma/var or a bn0
applied on the wrong axis. Grid lengths 40, 72 and 232 pool to 1, 2 and 7
time steps (floor pooling at odd sizes), and the inputs carry the zero rows
of the PANN time grid. Bound: atol 1e-4 (float32 on both sides; convolution
summation orders differ between XLA and torch on the CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frechet_audio_distance_exported_tpu.models.pann import pann_forward  # noqa: E402
from frechet_audio_distance_exported_tpu.utils.weights import save_weights  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.models.pann import (  # noqa: E402
    BLOCK_CHANNELS,
    PANN,
)
from frechet_audio_distance_exported_tpu_torch.utils import weights  # noqa: E402

NARROW = ((1, 8), (8, 16), (16, 32), (32, 64), (64, 128), (128, 256))


def perturbed_bn(rng, dim, mean=0.0, var=1.0):
    return {
        "gamma": (1.0 + 0.3 * rng.standard_normal(dim)).astype(np.float32),
        "beta": (0.2 * rng.standard_normal(dim)).astype(np.float32),
        "mean": (mean + 0.2 * np.sqrt(var) * rng.standard_normal(dim)).astype(np.float32),
        "var": (var * (0.5 + rng.random(dim))).astype(np.float32),
    }


def cnn14_tree(seed=0, channels=NARROW, conv_gain=6.0):
    """A JAX-layout CNN14 pytree (HWIO convs, [in, out] fc1) with perturbed BN.

    bn0 carries log-mel statistics (mean about -40 dB, variance about 100),
    so the zero rows of the grid become a large shift, as they do with real
    weights. Convolutions are uniform(±sqrt(conv_gain / fan_in)): the default
    6 is He scaling, which keeps activations of order 1 through all twelve
    of them instead of fading into fc1's bias; 1 is the JAX initializer's
    scale (models/common.py:165)."""
    rng = np.random.default_rng(seed)

    def uniform(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    tree = {"bn0": perturbed_bn(rng, 64, mean=-40.0, var=100.0), "blocks": []}
    for cin, cout in channels:
        tree["blocks"].append({
            "conv1": {"w": uniform((3, 3, cin, cout), np.sqrt(conv_gain / (9 * cin)))},
            "bn1": perturbed_bn(rng, cout),
            "conv2": {"w": uniform((3, 3, cout, cout), np.sqrt(conv_gain / (9 * cout)))},
            "bn2": perturbed_bn(rng, cout),
        })
    width = channels[-1][1]
    bound = 1.0 / np.sqrt(width)
    tree["fc1"] = {"w": uniform((width, width), bound), "b": uniform((width,), bound)}
    return tree


def _module(state, channels=NARROW):
    model = PANN(channels)
    model.load_state_dict(state)
    return model.eval()


def _logmel(b, t_grid, n_valid, seed):
    """[b, t_grid, 64] dB-like values with rows >= n_valid[i] zeroed."""
    x = (np.random.default_rng(seed).standard_normal((b, t_grid, 64)) * 10.0 - 40.0).astype(np.float32)
    for i, nv in enumerate(n_valid):
        x[i, nv:] = 0.0
    return x


@pytest.fixture(scope="module")
def tree():
    return cnn14_tree()


@pytest.mark.parametrize("t_grid", [40, 72, 232])
def test_forward_matches_jax(tree, t_grid):
    x = _logmel(3, t_grid, [t_grid, t_grid - 9, t_grid // 2], seed=t_grid)
    ref = np.asarray(pann_forward(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x)))
    with torch.inference_mode():
        ours = _module(weights.params_from_jax(tree))(torch.from_numpy(x)).numpy()
    assert ours.shape == (3, 256)
    assert (ours >= 0).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("field", ["gamma", "beta", "mean", "var"])
@pytest.mark.parametrize("where", ["bn0", "bn1", "bn2"])
def test_every_batch_norm_field_reaches_the_output(tree, field, where):
    """Changing one field of one BN must move the port's output exactly as it
    moves the JAX output, so a swapped or dropped field cannot hide."""
    changed = jax.tree_util.tree_map(lambda a: a, tree)
    bn = changed["bn0"] if where == "bn0" else changed["blocks"][2][where]
    bn[field] = (bn[field] * 1.5 + 0.1).astype(np.float32)
    x = _logmel(2, 72, [72, 60], seed=5)
    with torch.inference_mode():
        base = _module(weights.params_from_jax(tree))(torch.from_numpy(x)).numpy()
        ours = _module(weights.params_from_jax(changed))(torch.from_numpy(x)).numpy()
    ref = np.asarray(pann_forward(jax.tree_util.tree_map(jnp.asarray, changed), jnp.asarray(x)))
    assert np.abs(ours - base).max() > 1e-2  # 100x the bound below
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_npz_bundle_loads_to_the_same_outputs(tree, tmp_path):
    path = tmp_path / "pann_cnn14_16k_tpu.npz"
    save_weights(str(path), tree)
    loaded = weights.load_weights(str(path), "pann")
    bridged = weights.params_from_jax(tree)
    assert loaded.keys() == bridged.keys()
    x = torch.from_numpy(_logmel(2, 40, [40, 33], seed=9))
    with torch.inference_mode():
        assert torch.equal(_module(loaded)(x), _module(bridged)(x))
    with pytest.raises(ValueError, match="holds pann weights, not vggish"):
        weights.load_weights(str(path), "vggish")


def test_wrong_input_layout_raises(tree):
    model = _module(weights.params_from_jax(tree))
    with pytest.raises(ValueError, match="64"):
        model(torch.zeros((2, 64, 72)))
    with pytest.raises(ValueError, match="blocks"):
        PANN(NARROW[:5])


def test_random_init_fits_the_full_width_module_and_is_deterministic():
    a = weights.init_random_params("pann-16k", seed=3)
    b = weights.init_random_params("pann-8k", seed=3)
    with torch.device("meta"):
        expected = {k: tuple(v.shape) for k, v in PANN().state_dict().items()}
    assert {k: tuple(v.shape) for k, v in a.items()} == expected
    assert all(torch.equal(a[k], b[k]) for k in a)  # one CNN14 serves every rate
    assert PANN().fc1.out_features == 2048 == BLOCK_CHANNELS[-1][1]
    # BatchNorm starts as the identity, like the JAX initializer.
    assert torch.equal(a["bn0.weight"], torch.ones(64))
    assert torch.equal(a["blocks.3.bn2.running_var"], torch.ones(512))
    assert not a["blocks.5.bn1.running_mean"].any() and not a["blocks.0.bn1.bias"].any()
    ulp = 1.0 + 2.0**-23  # the float32 product may round just past the bound
    assert float(a["blocks.5.conv2.weight"].abs().max()) <= ulp / np.sqrt(9 * 2048)
    assert float(a["fc1.weight"].abs().max()) <= ulp / np.sqrt(2048)


def test_get_params_checks_the_family(tree, tmp_path):
    vggish_like = {
        "features": [{"w": np.zeros((3, 3, 1, 2), np.float32), "b": np.zeros(2, np.float32)}],
        "embeddings": [{"w": np.zeros((2, 2), np.float32), "b": np.zeros(2, np.float32)}],
    }
    save_weights(str(tmp_path / "pann_cnn14_32k_tpu.npz"), vggish_like)
    with pytest.raises(RuntimeError, match="failed to load"):
        weights.get_params("pann-32k", str(tmp_path), weights="auto")
    save_weights(str(tmp_path / "pann_cnn14_32k_tpu.npz"), tree)
    state = weights.get_params("pann-32k", str(tmp_path), weights="auto")
    assert torch.equal(state["bn0.running_var"], torch.from_numpy(tree["bn0"]["var"]))
    assert state["blocks.1.conv1.weight"].shape == (16, 8, 3, 3)
