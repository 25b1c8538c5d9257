"""The port's 48 kHz Encodec encoder against the benchmark's plain reference
(fadbench/reference/encodec.py), on the CPU at the published widths.

The reference is written from EnCodec's SEANet description with none of the
port: F.conv1d after EnCodec's non-causal reflect padding, GroupNorm(1, C)
from explicit float32 moments, and the LSTM as an explicit step loop. One
state_dict serves both. Inputs are the benchmark's own kind of clip (noise
falling as 1/f^tilt, -36 to -18 dBFS) at 48 kHz, duplicated to two channels,
at most 0.5 s and two clips.

The bar on the whole encoder is 2e-5 of the largest output: float32 reads
0.9e-6 to 1.3e-6 here (the two sides sum in other orders: Welford against
two-pass moments, ATen's fused LSTM cell against the loop), and each
planted fault reads 1.2e-3 or more.
"""

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fadbench import corpus
from fadbench.reference import encodec as ref
from frechet_audio_distance_exported_tpu_torch.models.encodec import Encodec

REPO_ROOT = Path(__file__).resolve().parent.parent

CFG = json.loads((REPO_ROOT / "fadbench" / "configs" / "encodec-48k.json").read_text())
# 15 times the 1.3e-6 that float32 reads at most, 60 times below the 1.2e-3
# of TF32 convolutions (the closest fault).
BAR = 2e-5


def clips(samples: int, seed: int = 5) -> torch.Tensor:
    """[2, 2, samples]: one background-like and one eval-like clip of the
    benchmark's traffic, each duplicated to two channels."""
    traffic = json.loads((REPO_ROOT / "fadbench" / "traffic" / "corpus512_48k.json").read_text())
    traffic = dict(traffic, clip_seconds=samples / 48000,
                   pools={s: dict(v, clips=1) for s, v in traffic["pools"].items()})
    pools = corpus.make_pools(traffic, seed, "cpu")
    pcm = torch.from_numpy(np.concatenate([pools["background"], pools["eval"]]))
    return (pcm.to(torch.float32) / 32768.0)[:, None].expand(-1, 2, -1)


def random_state(seed: int = 11) -> dict:
    """The benchmark's law, then every bias and GroupNorm's affine drawn too,
    so that each parameter shows in the output."""
    gen = torch.Generator().manual_seed(seed)
    state = ref.init_state(CFG, gen, "cpu")
    for key, value in state.items():
        if key.endswith("bias") and not key.startswith("lstm."):
            state[key] = 0.1 * torch.randn(value.shape, generator=gen)
        elif key.endswith("gn.weight"):
            state[key] = 1.0 + 0.2 * torch.randn(value.shape, generator=gen)
    return state


def models(state):
    port = Encodec(channels=2, causal=False).eval()
    port.load_state_dict(state)
    plain = ref.build(CFG, "cpu")
    plain.load_state_dict(state)
    return port, plain


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.fixture(scope="module")
def port_out():
    """The port's output on 0.5 s clips, and its state."""
    state = random_state()
    port, _ = models(state)
    x = clips(24000)
    with torch.inference_mode():
        return state, x, port(x)


def reference_out(state, x, cfg=CFG):
    plain = ref.build(cfg, "cpu")
    plain.load_state_dict(state)
    with torch.inference_mode():
        return plain(x)


@pytest.mark.parametrize("samples", [24000, 7777])
def test_port_matches_the_reference_at_published_widths(samples):
    """0.5 s, and a length that needs EnCodec's extra right padding at every
    stride."""
    state = random_state(samples)
    port, plain = models(state)
    x = clips(samples, seed=samples)
    with torch.inference_mode():
        want, got = plain(x), port(x)
    assert got.shape == want.shape == (2, -(-samples // 320), 128)
    assert rel_err(got, want) < BAR


def test_reference_group_norm_matches_torch():
    """Explicit float32 moments against nn.GroupNorm(1, C) on an offset, scaled
    signal: within 2e-6 of the largest output (float32 reads 2e-7)."""
    gen = torch.Generator().manual_seed(3)
    x = 0.3 + 0.05 * torch.randn((2, 64, 6000), generator=gen)
    norm = torch.nn.GroupNorm(1, 64, eps=CFG["group_norm_eps"])
    plain = ref.GroupNorm1(64, CFG["group_norm_eps"])
    with torch.no_grad():
        for p in (norm.weight, norm.bias):
            p.copy_(torch.randn(p.shape, generator=gen))
        plain.weight.copy_(norm.weight)
        plain.bias.copy_(norm.bias)
        assert rel_err(plain(x), norm(x)) < 2e-6


def test_reference_lstm_loop_matches_torch():
    """The step loop, with its skip, against nn.LSTM(x) + x over 150 steps:
    within 2e-6 of the largest output (float32 reads 5e-8)."""
    gen = torch.Generator().manual_seed(4)
    lstm = torch.nn.LSTM(512, 512, num_layers=2)
    plain = ref.LSTM(512, 2)
    with torch.no_grad():
        for name, p in lstm.named_parameters():
            p.copy_(torch.rand(p.shape, generator=gen) * 0.088 - 0.044)
            getattr(plain, name).copy_(p)
        x = torch.randn((2, 512, 150), generator=gen)
        seq = x.permute(2, 0, 1)
        want = (lstm(seq)[0] + seq).permute(1, 2, 0)
        assert rel_err(plain(x), want) < 2e-6


def _causal(self, x):
    total = self.kernel - self.stride
    extra = ref.extra_padding(x.shape[-1], self.kernel, self.stride, total)
    x = F.pad(x, (total, extra), mode="reflect")
    return self.gn(F.conv1d(x, self.conv.weight, self.conv.bias, stride=self.stride))


def _no_skip(self, x):
    y = x.permute(2, 0, 1)
    for layer in range(self.layers):
        y = self.layer(y, layer)
    return y.permute(1, 2, 0)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, as the card's TF32 products
    take their operands."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Functional(types.SimpleNamespace):
    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def conv1d(x, w, b=None, **kwargs):
        return F.conv1d(_tf32(x), _tf32(w), b, **kwargs)


@pytest.mark.parametrize("fault", ["causal_padding", "group_norm_eps", "lstm_skip_dropped",
                                   "tf32_on"])
def test_planted_faults_fail_the_bar(port_out, monkeypatch, fault):
    """Each fault, planted in the reference, puts it ten bars or more past
    the port: causal padding (all left) in place of centred shifts every
    frame (0.51); eps 1e-4 in place of 1e-5 rescales the quiet clips'
    norms (1.7e-3); the LSTM without its skip loses the encoder's main path
    (1.3); TF32 operands in the convolutions (1.2e-3)."""
    state, x, want = port_out
    cfg = CFG
    if fault == "causal_padding":
        monkeypatch.setattr(ref.SConv, "forward", _causal)
    elif fault == "group_norm_eps":
        cfg = dict(CFG, group_norm_eps=1e-4)
    elif fault == "lstm_skip_dropped":
        monkeypatch.setattr(ref.LSTM, "forward", _no_skip)
    else:
        monkeypatch.setattr(ref, "F", _TF32Functional())
    assert rel_err(reference_out(state, x, cfg), want) > 10 * BAR


def test_reference_embed_duplicates_pads_and_keeps_whole_hops():
    """embed(): a mono int16 clip as k / 32768 on both channels, zero-padded
    to 10 s, the encoder over all of it, and S // 320 rows kept."""
    state = random_state(6)
    plain = ref.build(CFG, "cpu")
    plain.load_state_dict(state)
    pcm = (clips(16000)[:1, 0] * 32768.0).round().to(torch.int16)
    with torch.inference_mode():
        got = ref.embed(plain, pcm)
        x = F.pad(pcm.to(torch.float32) / 32768.0, (0, CFG["clip_max_samples"] - 16000))
        want = plain(x[:, None].expand(-1, 2, -1))[:, : 16000 // 320]
    assert got.shape == (1, 50, 128)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        ref.embed(plain, torch.zeros((1, CFG["clip_max_samples"] + 1), dtype=torch.int16))


def test_reference_imports_neither_jax_nor_the_port():
    source = REPO_ROOT / "fadbench" / "reference" / "encodec.py"
    tops = set()
    for node in ast.walk(ast.parse(source.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    assert tops == {"__future__", "math", "typing", "torch"}
    forbidden = {"jax", "jaxlib", "flax", "frechet_audio_distance_exported_tpu",
                 "frechet_audio_distance_exported_tpu_torch"}
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import fadbench.reference.encodec\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))") % (
        str(REPO_ROOT), forbidden)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
