"""The port's CLAP module (HTSAT-tiny at full width) against the JAX forward.

Both run the same numpy parameter tree: the JAX initializer's weights with
every LayerNorm gamma and beta, every bias and bn0's four statistics
perturbed in numpy (the initializer makes them 1 or 0, so a dropped or
swapped field could not show otherwise), and each block's qkv, proj, fc1 and
fc2 weights and relative-position table scaled by 5. At the initializer's
std of 0.02 a block adds about 1e-2 to a unit residual stream, too little
for a wrong window layout to show on the embedding; at 5x the blocks'
terms are of order 1, and planted faults (a wrong roll sign, a wrong
window order) leave the bound by far. The JAX side runs
clap_forward(attn="xla"), the assembly that the JAX package's tests run on
the CPU; the port runs its plain window versions, which its wrappers take
for CPU tensors.

Bound: embeddings atol 5e-5. Float32 on both sides, through 12 Swin blocks
and 3 patch mergings with different summation orders, on 512-d unit vectors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frechet_audio_distance_exported_tpu.models import clap as jclap  # noqa: E402
from frechet_audio_distance_exported_tpu.utils.weights import save_weights  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.models import clap  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import frontends as fe  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import weights  # noqa: E402

ATOL = 5e-5
BLOCK_SCALE = 5.0  # on each block's qkv, proj, fc1, fc2 weights and rel_bias


def clap_tree(seed=0):
    """A JAX-layout CLAP tree (numpy) with perturbed norms, biases and bn0."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, jclap.init_clap_params(jax.random.PRNGKey(seed)))

    def perturb(node):
        for key, value in node.items():
            if isinstance(value, dict):
                perturb(value)
            elif isinstance(value, list):
                for item in value:
                    perturb(item)
            elif key == "gamma":
                node[key] = (1.0 + 0.1 * rng.standard_normal(value.shape)).astype(np.float32)
            elif key in ("beta", "b"):
                node[key] = (0.05 * rng.standard_normal(value.shape)).astype(np.float32)

    perturb(tree)
    for stage in tree["stages"]:
        for block in stage["blocks"]:
            block["rel_bias"] = block["rel_bias"] * np.float32(BLOCK_SCALE)
            for layer in (block["qkv"], block["proj"], block["mlp"]["fc1"], block["mlp"]["fc2"]):
                layer["w"] = layer["w"] * np.float32(BLOCK_SCALE)
    # bn0 over log-mel bins (dB): mean about -30, variance about 100.
    tree["bn0"]["mean"] = (-30.0 + 3.0 * rng.standard_normal(64)).astype(np.float32)
    tree["bn0"]["var"] = (100.0 * (0.5 + rng.random(64))).astype(np.float32)
    return tree


def module(state) -> clap.CLAP:
    model = clap.CLAP()
    model.load_state_dict(state)
    return model.eval()


def log_mel(b, seed):
    return (np.random.default_rng(seed).standard_normal((b, 1001, 64)) * 10.0 - 30.0).astype(
        np.float32
    )


@pytest.fixture(scope="module")
def tree():
    return clap_tree()


@pytest.fixture(scope="module")
def model(tree):
    return module(weights.params_from_jax(tree))


def jax_forward(tree, x):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return np.asarray(jclap.clap_forward(params, jnp.asarray(x), attn="xla"))


@pytest.fixture(scope="module")
def jax_pair(tree):
    """(log-mel [2, 1001, 64], the JAX embeddings of it)."""
    x = log_mel(2, seed=1)
    return x, jax_forward(tree, x)


def test_forward_matches_jax(jax_pair, model):
    x, ref = jax_pair
    with torch.inference_mode():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == (2, 512)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=1), 1.0, rtol=1e-5)
    assert np.abs(ours[0] - ours[1]).max() > 20 * ATOL  # the inputs move the embedding
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def _window_reverse_swapped(x, ws, h, w):
    """_window_reverse with the two window-grid axes swapped."""
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 2, 3, 1, 4, 5)
    return x.reshape(b, h, w, -1)


@pytest.mark.parametrize("fault", ["roll_sign", "window_order"])
def test_planted_layout_fault_leaves_the_bound(jax_pair, model, monkeypatch, fault):
    """The bound of test_forward_matches_jax catches a wrong window layout:
    with every shifted block's roll turned the other way, or the windows put
    back in the wrong order, the embedding leaves the ATOL band by far (by
    about 19 and 56 times ATOL on this tree and input)."""
    if fault == "roll_sign":
        for stage in model.stages:
            for block in stage.blocks:
                monkeypatch.setattr(block, "shift", -block.shift)
    else:
        monkeypatch.setattr(clap, "_window_reverse", _window_reverse_swapped)
    x, ref = jax_pair
    with torch.inference_mode():
        ours = model(torch.from_numpy(x)).numpy()
    assert np.isfinite(ours).all()
    assert np.abs(ours - ref).max() > 10 * ATOL


def test_stages_dispatch_to_the_window_kernels(model, monkeypatch):
    """Stages 1-3 run swin_block_fused (2 + 2 + 6 blocks), stage 4 runs
    window_attention_fused (2 blocks) with its MLP in torch."""
    calls = {"swin_block_fused": [], "window_attention_fused": []}
    for name in calls:
        inner = getattr(clap, name)

        def spy(*args, _name=name, _inner=inner, **kwargs):
            calls[_name].append((args[0].shape[2], kwargs["heads"], kwargs["num_windows"],
                                 args[6].shape[0]))
            return _inner(*args, **kwargs)

        monkeypatch.setattr(clap, name, spy)
    with torch.inference_mode():
        model(torch.from_numpy(log_mel(1, seed=2)))
    # (C, heads, windows per image, mask windows): shifted on odd blocks above 8x8
    assert calls["swin_block_fused"] == [
        (96, 4, 64, 1), (96, 4, 64, 64), (192, 8, 16, 1), (192, 8, 16, 16),
        (384, 16, 4, 1), (384, 16, 4, 4), (384, 16, 4, 1), (384, 16, 4, 4),
        (384, 16, 4, 1), (384, 16, 4, 4),
    ]
    assert calls["window_attention_fused"] == [(768, 32, 1, 1), (768, 32, 1, 1)]


def test_host_constants_equal_jax():
    assert np.array_equal(clap._bicubic_time_matrix(1001, 1024),
                          jclap._bicubic_time_matrix(1001, 1024))
    for ours, ref in zip(clap._bicubic_taps(1001, 1024), jclap._bicubic_taps(1001, 1024)):
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    assert np.array_equal(clap._relative_position_index(8), jclap._relative_position_index(8))
    for res in (64, 32, 16):
        assert np.array_equal(clap._shift_attn_mask(res, 8, 4), jclap._shift_attn_mask(res, 8, 4))
    assert clap.STAGE_DIMS == jclap._STAGE_DIMS and clap.STAGE_RES == jclap._STAGE_RES
    assert (clap.DEPTHS, clap.NUM_HEADS, clap.WINDOW_SIZE) == (
        jclap.DEPTHS, jclap.NUM_HEADS, jclap.WINDOW_SIZE)
    assert (fe.CLAP_SAMPLE_RATE, fe.CLAP_MAX_SAMPLES, fe.CLAP_TIME_FRAMES) == (48000, 480000, 1001)


def test_gathered_bias_is_refreshed_on_load(tree, model):
    table = jnp.asarray(tree["stages"][2]["blocks"][3]["rel_bias"])
    ref = np.asarray(jclap._gathered_rel_bias(table, 8, 16))
    assert np.array_equal(model.stages[2].blocks[3].attn_bias.numpy(), ref)
    changed = weights.params_from_jax(tree)
    changed["stages.2.blocks.3.rel_bias"] = changed["stages.2.blocks.3.rel_bias"] + 1.0
    other = module(changed)
    assert np.allclose(other.stages[2].blocks[3].attn_bias.numpy(), ref + 1.0)


def test_patch_merging_order_matches_jax(tree):
    p = tree["stages"][0]["downsample"]
    x = np.random.default_rng(3).standard_normal((2, 64 * 64, 96)).astype(np.float32)
    jax_p = jax.tree_util.tree_map(jnp.asarray, p)
    ref = np.asarray(jclap._patch_merging(jax_p, jnp.asarray(x), 64))
    merge = clap.PatchMerging(96)
    merge.load_state_dict({"norm.gamma": torch.tensor(p["norm"]["gamma"]),
                           "norm.beta": torch.tensor(p["norm"]["beta"]),
                           "reduction.w": torch.tensor(p["reduction"]["w"])})
    with torch.inference_mode():
        ours = merge(torch.from_numpy(x), 64).numpy()
    assert ours.shape == (2, 32 * 32, 192)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_zero_log_mel_gives_a_finite_embedding():
    """With zero biases and identity norms a zero input embeds to exactly zero;
    the 1e-12 clamp of the norm keeps it finite (0, not NaN), as in JAX."""
    tree = jax.tree_util.tree_map(np.asarray, jclap.init_clap_params(jax.random.PRNGKey(0)))
    zero = np.zeros((1, 1001, 64), np.float32)
    with torch.inference_mode():
        ours = module(weights.params_from_jax(tree))(torch.from_numpy(zero)).numpy()
    assert np.isfinite(ours).all() and not ours.any()
    assert np.array_equal(ours, jax_forward(tree, zero))


def test_npz_bundle_loads_to_the_same_state(tree, tmp_path):
    path = tmp_path / "clap_tpu.npz"
    save_weights(str(path), tree)
    loaded = weights.load_weights(str(path), "clap")
    bridged = weights.params_from_jax(tree)
    assert loaded.keys() == bridged.keys() == clap.CLAP().state_dict().keys()
    assert all(torch.equal(loaded[k], bridged[k]) for k in loaded)
    assert loaded["patch_embed.conv.w"].shape == (96, 1, 4, 4)  # HWIO -> OIHW
    assert torch.equal(loaded["stages.2.blocks.5.mlp.fc1.w"],
                       torch.tensor(tree["stages"][2]["blocks"][5]["mlp"]["fc1"]["w"]))
    with pytest.raises(ValueError, match="holds clap weights, not pann"):
        weights.load_weights(str(path), "pann")


def test_random_init_fits_the_module_and_follows_the_jax_initializer():
    a = weights.init_random_params("clap", seed=3)
    b = weights.init_random_params("clap", seed=3)
    expected = {k: tuple(v.shape) for k, v in clap.CLAP().state_dict().items()}
    assert {k: tuple(v.shape) for k, v in a.items()} == expected
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["stages.3.blocks.1.mlp.fc2.w"]
    assert float(w.abs().max()) <= 0.04 and 0.015 < float(w.std()) < 0.02  # cut at 2 std
    assert float(a["stages.1.blocks.0.rel_bias"].abs().max()) <= 0.04
    assert torch.equal(a["bn0.var"], torch.ones(64)) and not a["bn0.mean"].any()
    assert torch.equal(a["norm.gamma"], torch.ones(768)) and not a["stages.0.blocks.1.qkv.b"].any()
    assert "stages.3.downsample.norm.gamma" not in a and "stages.2.downsample.reduction.b" not in a


def test_wrong_input_layout_raises(model):
    with pytest.raises(ValueError, match="1001"):
        model(torch.zeros((1, 64, 1001)))
