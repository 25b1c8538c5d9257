"""The port's Encodec encoder (SEANet, full width) against the JAX forward.

Both sides run one numpy parameter tree: the JAX initializer's weights with
every convolution weight scaled by 2, every convolution bias and
GroupNorm beta drawn from N(0, 0.05^2) and every GroupNorm gamma from
1 + N(0, 0.1^2). The initializer's uniform(±1/sqrt(fan_in)) shrinks the
signal through the 24 kHz model's 14 convolutions until its output hardly
depends on the input (0.001 of spread over time on noise); at 2x the output
is of order 1 and padding on the wrong side leaves the bound by far
(test_swapped_padding_leaves_the_bound). The JAX side runs on the CPU, where
its LSTM operands and convolutions are float32.

Bound: atol 1e-4 (PERF.md §2) on frame embeddings of order 1, float32 on
both sides with different summation orders, the 48 kHz GroupNorm with
one-pass moments in JAX (models/common.py:100-129) and torch's own
reduction in the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frechet_audio_distance_exported_tpu.models import common as jcommon  # noqa: E402
from frechet_audio_distance_exported_tpu.models import encodec as jenc  # noqa: E402
from frechet_audio_distance_exported_tpu.ops import frontends as jax_fe  # noqa: E402
from frechet_audio_distance_exported_tpu import pipeline as jax_pipeline  # noqa: E402
from frechet_audio_distance_exported_tpu.utils.weights import save_weights  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import pipeline  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.models import encodec  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import frontends as fe  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import weights  # noqa: E402

ATOL = 1e-4
CONV_SCALE = 2.0
RATES = (24000, 48000)


def encodec_tree(sample_rate, seed=0):
    """A JAX-layout Encodec tree (numpy) of one rate, perturbed as above."""
    variant = encodec.VARIANTS[sample_rate]
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, jenc.init_encodec_params(
        jax.random.PRNGKey(seed), causal=variant["causal"], channels=variant["channels"]))

    def perturb(node):
        for key, value in node.items():
            if isinstance(value, dict):
                perturb(value)
            elif isinstance(value, list):
                for item in value:
                    perturb(item)
            elif key == "w":
                node[key] = value * np.float32(CONV_SCALE)
            elif key in ("b", "beta"):
                node[key] = (0.05 * rng.standard_normal(value.shape)).astype(np.float32)
            elif key == "gamma":
                node[key] = (1.0 + 0.1 * rng.standard_normal(value.shape)).astype(np.float32)

    perturb(tree)  # the LSTM's leaves (w_ih, w_hh, b_ih, b_hh) keep the initializer's
    return tree


def module(sample_rate, state):
    model = encodec.encodec_for_rate(sample_rate)
    model.load_state_dict(state)
    return model.eval()


def causal(sample_rate):
    return encodec.VARIANTS[sample_rate]["causal"]


def channels(sample_rate):
    return encodec.VARIANTS[sample_rate]["channels"]


def noise(shape, seed, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module", params=RATES, ids=["24k", "48k"])
def variant(request):
    """(sample rate, JAX tree, port module)."""
    sr = request.param
    tree = encodec_tree(sr, seed=1)
    return sr, tree, module(sr, weights.params_from_jax(tree))


def sconv_pairs(sr):
    """(length, kernel, stride) of every convolution of one 10 s forward."""
    length = 10 * sr
    pairs = [(length, 7, 1)]
    for ratio in encodec.RATIOS:
        pairs += [(length, 3, 1), (length, 1, 1), (length, 1, 1), (length, 2 * ratio, ratio)]
        length = -(-length // ratio)
    return pairs + [(length, 7, 1)]


@pytest.mark.parametrize("sr", RATES)
def test_pad_amounts_match_jax_for_every_conv(sr):
    rng = np.random.default_rng(3)
    cases = sconv_pairs(sr) + [
        (int(n), k, s) for n in rng.integers(20, 5000, 40) for k, s in ((4, 2), (16, 8), (10, 5))
    ]
    for length, kernel, stride in cases:
        ours = encodec._pad_amounts(length, kernel, stride, causal(sr))
        assert ours == jenc._pad_amounts(length, kernel, stride, causal(sr)), (length, kernel)
    # The frame count of a 10 s buffer: 750 (24 kHz) or 1500 (48 kHz).
    assert sconv_pairs(sr)[-1][0] == 10 * sr // 320


@pytest.mark.parametrize("group_norm", [False, True], ids=["plain", "groupnorm"])
@pytest.mark.parametrize("kernel,stride", [(7, 1), (3, 1), (1, 1), (4, 2), (16, 8), (10, 5)])
def test_sconv_matches_jax(group_norm, kernel, stride):
    """SConv with and without GroupNorm against JAX _sconv, causal and
    centred. GroupNorm's inputs get a mean offset of 3 so that the moments'
    summation orders are put to the test."""
    rng = np.random.default_rng(kernel * 10 + stride)
    cin, cout, t = 24, 40, 997
    p = {"w": noise((kernel, cin, cout), 1) * 0.5, "b": noise((cout,), 2)}
    if group_norm:
        p["gn"] = {"gamma": (1 + 0.1 * rng.standard_normal(cout)).astype(np.float32),
                   "beta": (0.1 * rng.standard_normal(cout)).astype(np.float32)}
    x = noise((2, t, cin), 3, 1.0) + np.float32(3.0)
    for is_causal in (True, False):
        ref = np.asarray(jenc._sconv(p, jnp.asarray(x), kernel, stride, is_causal))
        conv = encodec.SConv(cin, cout, kernel, stride, causal=is_causal, group_norm=group_norm)
        state = {"conv.weight": torch.from_numpy(p["w"].transpose(2, 1, 0).copy()),
                 "conv.bias": torch.from_numpy(p["b"])}
        if group_norm:
            state["gn.weight"] = torch.from_numpy(p["gn"]["gamma"])
            state["gn.bias"] = torch.from_numpy(p["gn"]["beta"])
        conv.load_state_dict(state)
        with torch.inference_mode():
            ours = conv(torch.from_numpy(x.transpose(0, 2, 1).copy())).numpy().transpose(0, 2, 1)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_group_norm_moments_agree_far_below_the_bound():
    """nn.GroupNorm(1, C) against the JAX one-pass group_norm_full on a
    stage-1-like activation (32 channels, 48,000 frames, mean offset 2):
    the difference is what the two reductions leave, about 1e-6."""
    x = noise((2, 48000, 32), 4, 1.0) + np.float32(2.0)
    gamma = (1 + 0.1 * np.random.default_rng(5).standard_normal(32)).astype(np.float32)
    beta = (0.1 * np.random.default_rng(6).standard_normal(32)).astype(np.float32)
    ref = np.asarray(jcommon.group_norm_full(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta)))
    gn = torch.nn.GroupNorm(1, 32, eps=1e-5)
    gn.load_state_dict({"weight": torch.from_numpy(gamma), "bias": torch.from_numpy(beta)})
    with torch.inference_mode():
        ours = gn(torch.from_numpy(x.transpose(0, 2, 1).copy())).numpy().transpose(0, 2, 1)
    assert np.abs(ours - ref).max() <= 1e-5


def test_res_block_matches_jax(variant):
    sr, tree, model = variant
    stage = 1  # dim 64
    x = noise((2, 1203, 64), 7, 1.0)
    ref = np.asarray(jenc._res_block(tree["stages"][stage]["res"], jnp.asarray(x), causal(sr)))
    with torch.inference_mode():
        ours = model.stages[stage].res(torch.from_numpy(x.transpose(0, 2, 1).copy()))
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 1), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("t", [1, 150])
def test_slstm_matches_jax(variant, t):
    """The 2-layer LSTM with its skip against JAX _slstm (float32 operands,
    the wavefront scan): the same recurrence, gates i, f, g, o."""
    _, tree, model = variant
    x = noise((3, t, encodec.HIDDEN), 8 + t, 1.0)
    ref = np.asarray(jenc._slstm(tree["lstm"], jnp.asarray(x), op_dtype=jnp.float32))
    with torch.inference_mode():
        ours = model.lstm(torch.from_numpy(x.transpose(0, 2, 1).copy()))
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 1), ref, rtol=0, atol=ATOL)


def jax_forward(sr, tree, x):
    return np.asarray(jenc.encodec_forward(tree, x, causal=causal(sr)))


@pytest.mark.parametrize("samples", [3200, 3333])
def test_encoder_matches_jax_short(variant, samples):
    sr, tree, model = variant
    x = noise((2, channels(sr), samples), samples)
    ref = jax_forward(sr, tree, x)
    with torch.inference_mode():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (2, -(-samples // 320), 128)
    assert ours[0].std(axis=0).mean() > 0.1  # the frames depend on the input
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def full_length(variant):
    """A 10 s buffer on the PCM16 grid (the int16 wire) and the JAX frames of it."""
    sr, tree, model = variant
    q = np.clip(np.round(noise((1, channels(sr), 10 * sr), 9) * 32768.0), -32768, 32767)
    wave_i16 = q.astype(np.int16)
    ref = jax_forward(sr, tree, jnp.asarray(wave_i16))
    return sr, model, wave_i16, ref


def test_encoder_matches_jax_full_length(full_length):
    """The whole encoder at its published width on a 10 s buffer: 750 frames
    at 24 kHz mono, 1500 at 48 kHz stereo."""
    sr, model, wave_i16, ref = full_length
    x = wave_i16.astype(np.float32) / 32768.0
    with torch.inference_mode():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (1, 10 * sr // 320, 128)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_int16_input_is_divided_by_32768(full_length):
    """The int16 wire dequantises by 32768 (JAX models/encodec.py:232-233),
    not by CLAP's 32767: the same frames as the float32 buffer, bit for bit."""
    sr, model, wave_i16, ref = full_length
    with torch.inference_mode():
        from_i16 = model(torch.from_numpy(wave_i16)).numpy()
        from_f32 = model(torch.from_numpy(wave_i16.astype(np.float32) / 32768.0)).numpy()
    np.testing.assert_array_equal(from_i16, from_f32)
    np.testing.assert_allclose(from_i16, ref, rtol=0, atol=ATOL)


def test_swapped_padding_leaves_the_bound(variant, monkeypatch):
    """A planted fault: the other variant's padding (centred at 24 kHz, causal
    at 48 kHz), which keeps T and shifts what each frame reads. The frames
    stay finite and of the same shape; only the parity bound catches it."""
    sr, tree, model = variant
    x = noise((1, channels(sr), 6400), 11)
    ref = jax_forward(sr, tree, x)
    true_pads = encodec._pad_amounts
    monkeypatch.setattr(encodec, "_pad_amounts",
                        lambda length, kernel, stride, is_causal:
                        true_pads(length, kernel, stride, not is_causal))
    with torch.inference_mode():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    assert np.abs(ours - ref).max() > 100 * ATOL


def test_wrong_input_layout_raises(variant):
    sr, _, model = variant
    with pytest.raises(ValueError, match=f"{channels(sr)}, S"):
        model(torch.zeros((1, 3, 3200)))
    with pytest.raises(ValueError):
        model(torch.zeros((channels(sr), 3200)))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def test_params_from_jax_layouts(variant):
    sr, tree, model = variant
    state = weights.params_from_jax(tree)
    assert weights.family_of_tree(tree) == "encodec"
    assert state.keys() == model.state_dict().keys()
    assert state["conv_in.conv.weight"].shape == (32, channels(sr), 7)  # [k, in, out] -> [out, in, k]
    np.testing.assert_array_equal(
        state["stages.3.down.conv.weight"].numpy(),
        tree["stages"][3]["down"]["w"].transpose(2, 1, 0))
    np.testing.assert_array_equal(state["lstm.weight_hh_l1"].numpy(), tree["lstm"]["l1"]["w_hh"].T)
    assert state["lstm.weight_ih_l0"].shape == (4 * 512, 512)
    np.testing.assert_array_equal(state["lstm.bias_ih_l1"].numpy(), tree["lstm"]["l1"]["b_ih"])
    has_gn = any(".gn." in k for k in state)
    assert has_gn == (sr == 48000)
    if has_gn:
        np.testing.assert_array_equal(
            state["stages.2.res.shortcut.gn.weight"].numpy(),
            tree["stages"][2]["res"]["shortcut"]["gn"]["gamma"])


def test_encodec_is_told_apart_from_clap_before_its_rule():
    """Both trees have "stages"; the Encodec rule is checked first."""
    tree = {"conv_in": {}, "stages": [], "lstm": {}, "conv_out": {}, "projection": {},
            "patch_embed": {}}
    assert weights.family_of_tree(tree) == "encodec"


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    """encodec_24k_tpu.npz and encodec_48k_tpu.npz as the JAX package writes them."""
    root = tmp_path_factory.mktemp("encodec_bundles")
    for sr in RATES:
        save_weights(str(root / f"encodec_{sr // 1000}k_tpu.npz"), encodec_tree(sr, seed=2))
    return root


@pytest.mark.parametrize("sr", RATES)
def test_bundle_loads_to_the_bridged_state(bundle_dir, sr):
    name = f"encodec-{sr // 1000}k"
    loaded = weights.get_params(name, str(bundle_dir), weights="auto")
    bridged = weights.params_from_jax(encodec_tree(sr, seed=2))
    assert loaded.keys() == bridged.keys()
    assert all(torch.equal(loaded[k], bridged[k]) for k in loaded)


def test_a_24k_bundle_is_refused_by_the_48k_loader(bundle_dir, tmp_path):
    (tmp_path / "encodec_48k_tpu.npz").write_bytes((bundle_dir / "encodec_24k_tpu.npz").read_bytes())
    with pytest.raises(ValueError, match="encodec_48k_tpu.npz.*1 input channel"):
        weights.get_params("encodec-48k", str(tmp_path), weights="auto")
    with pytest.raises(ValueError, match="encodec_48k_tpu.npz"):
        FrechetAudioDistance(model_name="encodec-48k", weights="auto", ckpt_dir=str(tmp_path),
                             device="cpu")
    (tmp_path / "encodec_24k_tpu.npz").write_bytes((bundle_dir / "encodec_48k_tpu.npz").read_bytes())
    with pytest.raises(ValueError, match="encodec_24k_tpu.npz.*2 input channel"):
        weights.get_params("encodec-24k", str(tmp_path), weights="auto")


@pytest.mark.parametrize("sr", RATES)
def test_random_init_fits_the_module_and_is_deterministic(sr):
    name = f"encodec-{sr // 1000}k"
    a = weights.init_random_params(name, seed=3)
    b = weights.init_random_params(name, seed=3)
    c = weights.init_random_params(name, seed=4)
    with torch.device("meta"):
        expected = {k: tuple(v.shape) for k, v in encodec.encodec_for_rate(sr).state_dict().items()}
    assert {k: tuple(v.shape) for k, v in a.items()} == expected
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_out.conv.weight"], c["conv_out.conv.weight"])
    ulp = 1.0 + 2.0**-23
    assert float(a["conv_in.conv.weight"].abs().max()) <= ulp / np.sqrt(7 * channels(sr))
    assert float(a["stages.3.down.conv.bias"].abs().max()) <= ulp / np.sqrt(16 * 256)
    assert float(a["lstm.weight_hh_l1"].abs().max()) <= ulp / np.sqrt(512)
    assert float(a["lstm.weight_hh_l1"].abs().max()) > 0.9 / np.sqrt(512)
    if sr == 48000:  # GroupNorm starts as the identity, like the JAX initializer
        assert torch.equal(a["stages.0.res.conv1.gn.weight"], torch.ones(16))
        assert not a["conv_out.gn.bias"].any()


# ---------------------------------------------------------------------------
# Host preprocessing and packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target_sr,target_channels", [(24000, 1), (48000, 2)])
@pytest.mark.parametrize("source", ["mono", "stereo", "mono_2d"])
@pytest.mark.parametrize("sr", [16000, 24000, 48000])
def test_preprocess_for_encodec_matches_jax(target_sr, target_channels, source, sr):
    rng = np.random.default_rng(12)
    n = sr // 4
    audio = {"mono": rng.standard_normal(n), "stereo": rng.standard_normal((n, 2)),
             "mono_2d": rng.standard_normal((n, 1))}[source].astype(np.float32) * 0.2
    ours = fe.preprocess_for_encodec(audio, sr, target_sr, target_channels, return_tensor=False)
    ref = jax_fe.preprocess_for_encodec(audio, sr, target_sr, target_channels, return_tensor=False)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    assert ours.shape[0] == target_channels
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    tensor = fe.preprocess_for_encodec(audio, sr, target_sr, target_channels)
    assert isinstance(tensor, torch.Tensor) and tensor.shape == (1,) + ours.shape
    np.testing.assert_array_equal(tensor[0].numpy(), ours)


def test_preprocess_and_pad_errors():
    with pytest.raises(ValueError, match="Unsupported target sample rate"):
        fe.preprocess_for_encodec(np.zeros(10, np.float32), 16000, 16000, 1)
    with pytest.raises(ValueError, match="1D or 2D"):
        fe.preprocess_for_encodec(np.zeros((2, 2, 2), np.float32), 24000, 24000, 1)
    assert fe.pad_to_fixed_length(np.zeros((1, 2, 1000), np.float32), 48000).shape == (1, 2, 480000)
    assert fe.pad_to_fixed_length(torch.ones((1, 1, 1000)), 24000).shape == (1, 1, 240000)
    with pytest.raises(ValueError, match="Audio too long"):
        fe.pad_to_fixed_length(np.zeros((1, 1, 240001), np.float32), 24000)
    assert fe.ENCODEC_CONFIGS == jax_fe.ENCODEC_CONFIGS
    assert fe.ENCODEC_MAX_AUDIO_SECONDS == jax_fe.ENCODEC_MAX_AUDIO_SECONDS


@pytest.mark.parametrize("rows_kind", ["1d", "stereo", "mixed"])
def test_pack_wave_matches_jax(rows_kind):
    """[b, *row_dims, length]: 1-D rows as before (VGGish, PANN, CLAP) and
    [2, S] rows (encodec-48k), int16 only when every row is."""
    rng = np.random.default_rng(13)
    shape = (lambda n: (n,)) if rows_kind == "1d" else (lambda n: (2, n))
    rows = [np.round(rng.standard_normal(shape(n)) * 3000).astype(np.int16) for n in (50, 97, 64)]
    if rows_kind == "mixed":
        rows[1] = rows[1].astype(np.float32) / np.float32(32768.0) + np.float32(1e-6)
    ours = pipeline._pack_wave(rows, 4, 100)
    ref = jax_pipeline._pack_wave(rows, 4, 100)
    assert ours.dtype == ref.dtype == (np.float32 if rows_kind == "mixed" else np.int16)
    assert ours.shape == (4,) + shape(100)
    np.testing.assert_array_equal(ours, ref)


def report() -> None:
    """Print the largest port-vs-JAX errors of the checks above at full
    length: JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_encodec_model.py."""
    for sr in RATES:
        tree = encodec_tree(sr, seed=1)
        model = module(sr, weights.params_from_jax(tree))
        x = noise((1, channels(sr), 10 * sr), 9)
        t = 10 * sr // 320
        h = noise((1, t, encodec.HIDDEN), 10, 1.0)
        with torch.inference_mode():
            enc = model(torch.from_numpy(x)).numpy()
            lstm = model.lstm(torch.from_numpy(h.transpose(0, 2, 1).copy())).numpy()
        enc_err = np.abs(enc - jax_forward(sr, tree, x)).max()
        ref = np.asarray(jenc._slstm(tree["lstm"], jnp.asarray(h), op_dtype=jnp.float32))
        lstm_err = np.abs(lstm.transpose(0, 2, 1) - ref).max()
        print(f"encodec-{sr // 1000}k: encoder on 10 s {enc_err:.3e} (mean |x| "
              f"{np.abs(enc).mean():.3f}), LSTM alone at T={t} {lstm_err:.3e}")


if __name__ == "__main__":
    report()
