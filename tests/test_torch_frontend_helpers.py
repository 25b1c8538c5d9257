"""The port's reference-compatible single-file helpers against the JAX package's.

ops/frontends.py (and their re-exports in models/__init__.py): the same
NumPy clips, made from a seed, go through both packages on the CPU.
- Host-only arithmetic is equal bit for bit: pad_audio_to_max_length,
  pad_to_valid_encodec_length (NumPy and torch input), the constants; and
  clap_quantize (NumPy's float -> int16 cast, wrapping modulo 2^16 past full
  scale, on values in and out of range) equals that NumPy arithmetic bit for
  bit, where JAX's jitted version is within one float32 ulp of it (XLA
  divides by 32767 otherwise than NumPy: 31 of 1012 values differ).
- Helpers that compute a log-mel (waveform_to_examples, waveform_to_logmel,
  preprocess_for_clap) run the log-mel kernels' plain float32 versions here,
  against JAX's XLA frontends (both float32; the DFT summation orders
  differ): VGGish's log(mel + 0.01) within atol 1e-4; the Slaney log-mels in
  linear power within 1e-6 of each clip's largest, the bar of
  tests/test_torch_pann_frontend.py (in dB, a near-empty bin above an
  upsampled clip's band moves by some 1e-2).
- The helpers take device="cuda" by default and raise without CUDA.
- models/__init__.py exports every name of the JAX package's, the forward
  functions and parameter initialisers standing as the nn.Module classes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import frechet_audio_distance_exported_tpu.models as jax_models  # noqa: E402
from frechet_audio_distance_exported_tpu.ops import frontends as jfe  # noqa: E402
import frechet_audio_distance_exported_tpu_torch.models as port_models  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import frontends as fe  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import launches  # noqa: E402
from test_torch_pann_frontend import assert_power_close  # noqa: E402

ATOL = 1e-4


def noise(n, seed, channels=1, scale=0.1):
    shape = (n,) if channels == 1 else (n, channels)
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_clap_quantize_wraps_like_numpy():
    """In range it is the int16 round trip; past full scale (legal in float
    WAVs) NumPy's cast wraps modulo 2^16, and so do both packages."""
    x = np.concatenate([
        noise(1000, 1, scale=0.5),
        np.array([1.0, -1.0, 1.5, -1.5, 2.0, -2.0, 3.7, -3.7, 0.99999, 1e-6, -1e-6, 0.0],
                 np.float32),
    ])
    q = (x * np.float32(32767.0)).astype(np.int32)
    numpy_ref = (((q + 32768) % 65536) - 32768).astype(np.float32) / np.float32(32767.0)
    in_range = np.abs(x) <= 1.0
    np.testing.assert_array_equal(  # the reference's own cast, in range
        numpy_ref[in_range],
        (x[in_range] * 32767.0).astype(np.int16).astype(np.float32) / 32767.0)
    ours = fe.clap_quantize(x)
    assert isinstance(ours, torch.Tensor) and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), numpy_ref)
    np.testing.assert_array_equal(fe.clap_quantize(torch.from_numpy(x)).numpy(), numpy_ref)
    ref = np.asarray(jfe.clap_quantize(jnp.asarray(x)))
    np.testing.assert_array_max_ulp(ours.numpy(), ref, maxulp=1)
    # Past full scale the sign flips, as NumPy's wrapping cast does.
    assert ref[x == 1.5][0] < 0 and ref[x == -1.5][0] > 0
    assert ours.numpy()[x == 1.5][0] < 0 and ours.numpy()[x == -1.5][0] > 0


@pytest.mark.parametrize("sr,seconds,channels", [(16000, 3.0, 1), (16000, 0.5, 1),
                                                 (8000, 2.5, 2)])
def test_waveform_to_examples_matches_jax(sr, seconds, channels):
    x = noise(int(sr * seconds), 2, channels)
    ref = jfe.waveform_to_examples(x, sr, return_tensor=False)
    before = launches.read()
    ours = fe.waveform_to_examples(x, sr, return_tensor=False, device="cpu")
    assert launches.read() == before
    assert isinstance(ours, np.ndarray) and ours.shape == ref.shape
    assert ours.shape == (int(seconds / 0.96), 96, 64)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)
    tensor = fe.waveform_to_examples(x, sr, device="cpu")
    jax_tensor = jfe.waveform_to_examples(x, sr)
    assert isinstance(tensor, torch.Tensor) and tuple(tensor.shape) == jax_tensor.shape
    np.testing.assert_array_equal(tensor.numpy()[:, 0], ours)


@pytest.mark.parametrize("sr,target", [(16000, 16000), (8000, 8000), (32000, 32000),
                                       (8000, 16000)])
def test_waveform_to_logmel_matches_jax(sr, target):
    x = noise(int(sr * 1.3), 3, channels=2)
    ref = jfe.waveform_to_logmel(x, sr, target_sample_rate=target, return_tensor=False)
    ours = fe.waveform_to_logmel(x, sr, target_sample_rate=target, return_tensor=False,
                                 device="cpu")
    assert isinstance(ours, np.ndarray) and ours.shape == ref.shape
    assert ours.shape == (1 + int(target * 1.3) // fe.PANN_CONFIGS[target]["hop_size"], 64)
    assert_power_close(ours[None], ref[None], [ours.shape[0]])
    tensor = fe.waveform_to_logmel(x, sr, target_sample_rate=target, device="cpu")
    assert tuple(tensor.shape) == jfe.waveform_to_logmel(x, sr, target).shape
    np.testing.assert_array_equal(tensor.numpy()[0, 0], ours)
    with pytest.raises(ValueError, match="target_sample_rate"):
        fe.waveform_to_logmel(x, sr, target_sample_rate=22050, device="cpu")


@pytest.mark.parametrize("quantize", [True, False])
def test_preprocess_for_clap_matches_jax(quantize):
    x = noise(48000 * 2, 4, channels=2, scale=0.3)
    ref = np.asarray(jfe.preprocess_for_clap(x, 48000, apply_quantization=quantize))
    ours = fe.preprocess_for_clap(x, 48000, apply_quantization=quantize, device="cpu")
    assert isinstance(ours, torch.Tensor) and tuple(ours.shape) == ref.shape == (1, 1, 201, 64)
    assert_power_close(ours.numpy()[0], ref[0], [201])
    host = fe.preprocess_for_clap(x, 48000, return_tensor=False, apply_quantization=quantize,
                                  device="cpu")
    np.testing.assert_array_equal(host, ours.numpy()[0, 0])


def test_quantization_reaches_the_clap_log_mel():
    x = noise(48000, 5, scale=1e-4)  # a few int16 steps: the round trip moves the mel
    a = fe.preprocess_for_clap(x, 48000, apply_quantization=True, device="cpu")
    b = fe.preprocess_for_clap(x, 48000, apply_quantization=False, device="cpu")
    assert float((a - b).abs().max()) > 0.1  # dB


@pytest.mark.parametrize("seconds", [0.0, 3.3, 10.0])
def test_pad_audio_to_max_length_matches_jax(seconds):
    x = noise(int(48000 * seconds), 6)
    ours = fe.pad_audio_to_max_length(x, 48000)
    np.testing.assert_array_equal(ours, jfe.pad_audio_to_max_length(x, 48000))
    assert ours.shape == (fe.CLAP_MAX_SAMPLES,)


def test_pad_audio_to_max_length_refuses_longer_audio():
    x = noise(48000 * 10 + 1, 7)
    for module in (fe, jfe):
        with pytest.raises(ValueError, match="too long"):
            module.pad_audio_to_max_length(x, 48000)


@pytest.mark.parametrize("samples", [320, 321, 959, 24000])
def test_pad_to_valid_encodec_length_matches_jax(samples):
    x = noise(2 * samples, 8).reshape(1, 2, samples)
    ref = np.asarray(jfe.pad_to_valid_encodec_length(x))
    np.testing.assert_array_equal(fe.pad_to_valid_encodec_length(x), ref)
    ours = fe.pad_to_valid_encodec_length(torch.from_numpy(x))
    assert isinstance(ours, torch.Tensor)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert ref.shape[-1] % 320 == 0


@pytest.mark.parametrize("helper", ["waveform_to_examples", "waveform_to_logmel",
                                    "preprocess_for_clap"])
def test_helpers_default_to_the_card_and_raise_without_it(monkeypatch, helper):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(fe, helper)(noise(48000, 9), 48000)


def test_models_package_exports_the_jax_names():
    """Every name of the JAX models/__init__.py is exported, but the forward
    functions and parameter initialisers, whose place the nn.Module classes
    take; the constants are equal."""
    module_of = {"vggish": "VGGish", "pann": "PANN", "clap": "CLAP", "encodec": "Encodec"}
    for name in jax_models.__all__:
        family = name.split("_")[0] if name.endswith("_forward") else (
            name[len("init_"):-len("_params")] if name.startswith("init_") else None)
        if family is not None:
            assert module_of[family] in port_models.__all__
            continue
        assert name in port_models.__all__, name
        ours, ref = getattr(port_models, name), getattr(jax_models, name)
        if not callable(ref):
            assert ours == ref, name
    assert set(port_models.__all__) <= {n for n in dir(port_models) if not n.startswith("_")}
    assert port_models.encodec_for_rate(48000).channels == 2
    assert fe.CLAP_MAX_AUDIO_SECONDS == jfe.CLAP_MAX_AUDIO_SECONDS == 10
