"""The Encodec encoder's forward against its unfused chain, and the launch
counts of GroupNorm's forms.

At 48 kHz the port folds each conv's bias, ELU, the residual add and the
next conv's reflect pad into the GroupNorm pair's passes
(models/encodec.py, ops/group_norm.py). chain_forward composes the same
encoder from the module's parameters the way it was first written: pad,
conv with its bias, the norm, ELU, +. The forward is that chain to the bit
with the port's own norm (group_norm): on the CPU for both variants, on the
card for 48 kHz (the 24 kHz encoder has no norm and keeps the chain). On
the card a 48 kHz forward counts 18 ``group_norm`` and 4 split, 4 elu, 4
residual and 2 plain applies; the 24 kHz encoder, VGGish and CLAP count no
GroupNorm at all. This file imports no JAX, so that its card cases run on a
machine without it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.nn.functional as F  # noqa: E402

from frechet_audio_distance_exported_tpu_torch import pipeline  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.models import encodec  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import group_norm as gn  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import launches  # noqa: E402

FORM_COUNTS = {"split": 4, "elu": 4, "residual": 4, "plain": 2}  # a 48 kHz forward


def pair(y, norm):
    """The port's GroupNorm alone, on a conv output that holds its bias."""
    return gn.group_norm(y, norm.weight, norm.bias, norm.eps)


def chain_forward(model, x, norm):
    """model's encoder as a chain of ATen ops on its parameters: each conv
    reflect-padded, run with its bias, then norm(y, module.gn) where the
    variant has a norm; ELU and + between them; the LSTM as the model runs it."""

    def sconv(m, h):
        left, right = encodec._pad_amounts(h.shape[-1], m.conv.kernel_size[0],
                                           m.conv.stride[0], m.causal)
        if left or right:
            h = F.pad(h, (left, right), mode="reflect")
        y = F.conv1d(h, m.conv.weight, m.conv.bias, m.conv.stride)
        return y if m.gn is None else norm(y, m.gn)

    if x.dtype == torch.int16:
        x = x.to(torch.float32) / 32768.0
    h = sconv(model.conv_in, x.to(model.conv_in.conv.weight.dtype))
    for stage in model.stages:
        res = stage.res
        h = h.to(res.conv1.conv.weight.dtype)
        branch = sconv(res.conv2, F.elu(sconv(res.conv1, F.elu(h))))
        h = sconv(stage.down, F.elu(sconv(res.shortcut, h) + branch))
    return sconv(model.conv_out, F.elu(model.lstm(h))).transpose(1, 2)


def drawn(rate: int, seed: int):
    """The encoder at rate with every parameter drawn (biases and the norms'
    affines away from 0 and 1), in eval mode."""
    model = encodec.encodec_for_rate(rate).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, param in model.named_parameters():
            scale = 0.1 if name.endswith("bias") or name.endswith("gn.weight") else 0.0
            param.add_(scale * torch.randn(param.shape, generator=gen))
    return model


def waves(rate: int, batch: int, samples: int, seed: int) -> torch.Tensor:
    channels = encodec.VARIANTS[rate]["channels"]
    rng = np.random.default_rng(seed)
    return torch.from_numpy((0.3 * rng.standard_normal((batch, channels, samples)))
                            .astype(np.float32))


@pytest.mark.parametrize("rate,samples", [(48000, 9631), (48000, 4800), (24000, 9631)])
def test_cpu_forward_is_the_chain_to_the_bit(rate, samples):
    model = drawn(rate, seed=samples)
    x = waves(rate, 2, samples, seed=samples)
    before = launches.read()
    with torch.inference_mode():
        ours = model(x)
        chain = chain_forward(model, x, pair)
    assert launches.read() == before
    assert ours.shape == chain.shape == (2, -(-samples // 320), 128)
    assert torch.equal(ours, chain)


@pytest.fixture
def cuda_device():
    """Decided per test, not at import: every xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernels have no CPU mode)")
    return torch.device("cuda")


def counted(fn) -> dict:
    """The launches fn() adds, by key, those it adds at all."""
    before = launches.read()
    fn()
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in launches.read().items() if v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [48000, 24000])
def test_card_forward_is_the_chain_to_the_bit(cuda_device, rate, monkeypatch):
    """Four clips of 10 s on the card, TF32 off: the forward against the
    chain with the same norm, bit for bit (48 kHz: its 18 norms fused with
    their neighbours; 24 kHz: the chain itself)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    model = drawn(rate, seed=rate).to(cuda_device)
    model.lstm.flatten_parameters()
    x = waves(rate, 4, 10 * rate, seed=rate).to(cuda_device)
    with torch.inference_mode():
        ours = model(x)
        chain = chain_forward(model, x, pair)
    assert ours.shape == chain.shape == (4, 10 * rate // 320, 128)
    assert torch.equal(ours, chain)


@pytest.mark.cuda
def test_card_forward_counts_each_form(cuda_device):
    """A 48 kHz forward: 18 norms, 4 split, 4 elu, 4 residual, 2 plain; in
    a bf16 model (conv_out float32) the same forms under [bf16] but conv_out's
    plain; the 24 kHz encoder: nothing."""
    x = waves(48000, 2, 48000, seed=3).to(cuda_device)
    model = drawn(48000, seed=3).to(cuda_device)
    with torch.inference_mode():
        counts = counted(lambda: model(x))
        assert counts == {"group_norm": 18, **{f"group_norm_apply.{k}": v
                                                for k, v in FORM_COUNTS.items()}}
        pipeline.cast_model("encodec", model, torch.bfloat16)
        counts = counted(lambda: model(x))
        assert counts == {"group_norm[bf16]": 17, "group_norm": 1,
                          **{f"group_norm_apply.{k}[bf16]": v for k, v in FORM_COUNTS.items()
                             if k != "plain"},
                          "group_norm_apply.plain[bf16]": 1, "group_norm_apply.plain": 1}
        small = drawn(24000, seed=4).to(cuda_device)
        assert counted(lambda: small(waves(24000, 2, 24000, seed=4).to(cuda_device))) == {}


@pytest.mark.cuda
@pytest.mark.parametrize("model_name,rate", [("vggish", 16000), ("clap", 48000)])
def test_other_families_count_no_group_norm(cuda_device, model_name, rate):
    from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance

    fad = FrechetAudioDistance(model_name=model_name, weights="random", device="cuda")
    audio = (0.3 * np.random.default_rng(5).standard_normal(2 * rate)).astype(np.float32)
    counts = counted(lambda: fad.get_embeddings([audio, audio[: rate]], rate))
    assert counts and not any(k.startswith("group_norm") for k in counts), counts
