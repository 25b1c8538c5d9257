"""The benchmark's plain reference (fadbench/reference/) held to the port's
CPU path: the log-mels, the Swin layers at small widths, whole models at
their published widths on a few clips, the statistics and the epilogue.

Both sides compute in float32 from the same int16 clips and the same
weights, in different summation orders (one windowed-DFT product against
hop-sized chunks, torch's LayerNorm against a one-pass one, a bicubic
matrix against four gathered taps), so each tolerance is a few float32
rounding steps of the quantity compared."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import ROOT

from fadbench.reference import clap as ref_clap
from fadbench.reference import dsp, stats
from fadbench.reference import vggish as ref_vggish


def config(name):
    return json.loads((ROOT / "fadbench" / "configs" / f"{name}.json").read_text())


def pcm_clips(n, samples, seed=0):
    rng = np.random.default_rng(seed)
    return np.round(rng.standard_normal((n, samples)) * 3000).clip(-32768, 32767).astype(np.int16)


def port_calculator(model_name, state):
    from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance

    fad = FrechetAudioDistance(model_name=model_name, weights="random", device="cpu")
    fad.model.load_state_dict(state)
    return fad


def test_vggish_logmel_matches_the_ports_plain_version():
    from frechet_audio_distance_exported_tpu_torch.ops.cuda_frontend import (
        fused_vggish_logmel_reference,
    )

    cfg = config("vggish")
    wave = torch.from_numpy(pcm_clips(2, 32000)).float() / 32768.0
    got = dsp.vggish_logmel(wave, 192, cfg)
    want = fused_vggish_logmel_reference(wave, 192)
    assert got.shape == want.shape == (2, 192, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_clap_logmel_matches_the_ports_host_steps_and_plain_version():
    from frechet_audio_distance_exported_tpu_torch.ops.cuda_pann_frontend import (
        fused_pann_logmel_reference,
    )
    from frechet_audio_distance_exported_tpu_torch.ops.frontends import dequant_i16
    from frechet_audio_distance_exported_tpu_torch.pipeline import EmbeddingPipeline

    cfg = config("clap")
    pcm = pcm_clips(2, 480000, seed=1)
    got = ref_clap.logmel_input(torch.from_numpy(pcm), cfg)
    pipe = EmbeddingPipeline.__new__(EmbeddingPipeline)
    rows, frames = zip(*(pipe._clap_prep(c.astype(np.float32) / 32768.0, 48000) for c in pcm))
    wave = dequant_i16(torch.from_numpy(np.stack(rows)), 32767.0)
    want = fused_pann_logmel_reference(wave, torch.tensor(frames), 48000, 1001)
    assert got.shape == want.shape == (2, 1001, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("dim,heads,res,shift", [(48, 2, 16, 0), (48, 2, 16, 4), (96, 4, 8, 0)])
def test_swin_block_at_small_widths_matches_the_ports_plain_kernels(dim, heads, res, shift):
    from frechet_audio_distance_exported_tpu_torch.models import clap as port_clap

    torch.manual_seed(dim + shift)
    port = port_clap.SwinBlock(dim, heads, res, shift)
    state = {k: torch.randn(v.shape) * (0.02 if k.endswith((".w", "rel_bias")) else 0.1)
             + (1.0 if k.endswith("gamma") else 0.0) for k, v in port.state_dict().items()}
    port.load_state_dict(state)
    port.fused_block = True
    ref = ref_clap.SwinBlock(dim, heads, res, shift, 8, 4)
    ref.load_state_dict(state)
    x = torch.randn(2, res * res, dim)
    torch.testing.assert_close(ref(x), port(x), rtol=0, atol=2e-6)


def test_vggish_embeddings_match_the_ports_cpu_path():
    cfg = config("vggish")
    state = ref_vggish.init_state(cfg, torch.Generator().manual_seed(3), "cpu")
    pcm = pcm_clips(2, 32000, seed=2)
    model = ref_vggish.build(cfg, "cpu")
    model.load_state_dict(state)
    with torch.inference_mode():
        got = ref_vggish.embed(model, torch.from_numpy(pcm)).reshape(-1, 128)
    want = port_calculator("vggish", state).get_embeddings(
        [c.astype(np.float32) / 32768.0 for c in pcm], 16000)
    assert got.shape == want.shape == (4, 128)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)


def test_clap_embeddings_match_the_ports_cpu_path():
    cfg = config("clap")
    state = ref_clap.init_state(cfg, torch.Generator().manual_seed(4), "cpu")
    pcm = pcm_clips(2, 480000, seed=3)
    model = ref_clap.build(cfg, "cpu")
    model.load_state_dict(state)
    with torch.inference_mode():
        got = ref_clap.embed(model, torch.from_numpy(pcm)).reshape(-1, 512)
    want = port_calculator("clap", state).get_embeddings(
        [c.astype(np.float32) / 32768.0 for c in pcm], 48000)
    assert got.shape == want.shape == (2, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_init_state_fills_every_parameter_of_the_ports_models():
    from frechet_audio_distance_exported_tpu_torch.models.clap import CLAP
    from frechet_audio_distance_exported_tpu_torch.models.vggish import VGGish

    for name, ref, port in (("vggish", ref_vggish, VGGish), ("clap", ref_clap, CLAP)):
        state = ref.init_state(config(name), torch.Generator().manual_seed(0), "cpu")
        with torch.device("meta"):
            want = {k: tuple(v.shape) for k, v in port().state_dict().items()}
        assert {k: tuple(v.shape) for k, v in state.items()} == want
        again = ref.init_state(config(name), torch.Generator().manual_seed(0), "cpu")
        assert all(torch.equal(state[k], again[k]) for k in state)


def test_statistics_and_distance_match_numpy_and_the_ports_scipy_epilogue():
    from frechet_audio_distance_exported_tpu_torch.ops.stats import frechet_distance_np

    rng = np.random.default_rng(5)
    a = rng.standard_normal((300, 16)) @ rng.standard_normal((16, 16))
    b = rng.standard_normal((250, 16)) * 1.5 + 0.3
    mu1, s1 = stats.mean_cov(torch.from_numpy(a).float())
    mu2, s2 = stats.mean_cov(torch.from_numpy(b).float())
    np.testing.assert_allclose(mu1, a.astype(np.float32).mean(0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s1, np.cov(a.astype(np.float32).astype(np.float64), rowvar=False),
                               rtol=1e-9, atol=1e-9)
    got = stats.frechet_distance(mu1, s1, mu2, s2)
    assert got == pytest.approx(frechet_distance_np(mu1, s1, mu2, s2), rel=1e-8)
