"""WavLM-Large's encoder as a torch module: raw 16 kHz audio -> its last
hidden state, one 1024-wide row a 20 ms frame.

Follows HF transformers' WavLMModel with do_stable_layer_norm true and
feat_extract_norm "layer" (microsoft/wavlm-large's config.json; Chen et al.
2022, arXiv:2110.13900), for inference:

- each clip normalised over its own samples, (x - mean) / sqrt(var + 1e-7)
  with the population variance (Wav2Vec2FeatureExtractor's do_normalize);
- the feature extractor: 7 x [Conv1d without bias -> LayerNorm(512) over the
  channels of each frame (eps 1e-5) -> erf GELU], kernels 10-3-3-3-3-2-2,
  strides 5-2-2-2-2-2-2 (160,000 samples -> 499 frames), on cuDNN;
- the feature projection: LayerNorm(512) -> Linear(512, 1024);
- the positional embedding: x + GELU(Conv1d(1024, 1024, k=128, padding=64,
  groups=16)(x) without its last frame), the weight g * v / |v| (the norm over
  the output and input channels of each tap) folded once a load;
- 24 pre-LN layers, x += Wo attn(LN1(x)), x += fc2(GELU(fc1(LN2(x)))), then a
  final LayerNorm.

Attention, per head h of 64 columns: softmax(q k^T / 8 + gate[b, h, t] *
bias[h, t, s]) v with q, k and v biased. bias[h, t, s] = E[bucket(s - t), h]
(relative_bucket), E layer 0's [320, 16] table, which every layer reuses.
gate = a * (b * c_h - 1) + 2, where (a, b) is the sigmoid of the layer's
Linear(64, 8) on head h's 64 columns of LN1(x), viewed (2, 4) and summed over
the 4, and c_h the layer's gru_rel_pos_const.

On the card, in float32: the encoder's five products (the feature projection,
and each layer's qkv, proj, fc1 and fc2) run on ops/window_attn.gemm_tf32
(3xTF32 wgmma; the LayerNorm or GELU applied on load, the bias and the
residual in the epilogue). Each layer's gate projection rides as 128
block-diagonal columns after qkv's 3072 (N = 3200, LN on load: the gate reads
the same LN1(x)), for 4 % more of qkv's FLOPs and no pass of its own. The
attention is one launch of ops/wavlm_attn.wavlm_attention a layer (3xTF32
wgmma, the gate, the gated bias and an online softmax on chip), which reads
q, k, v and the gate's logits from the qkvg rows, the bias as the [16, 2T - 1]
relative table (Encoder.relative_table, gathered once a forward), and writes
the heads' outputs where proj reads them. On the CPU the products run
gemm_tf32's plain version and the attention runs in ATen with TF32 off:
baddbmm, the gated bias added in place by addcmul_ from the [16, T, T] table
(no [B, H, T, T] bias beside the scores), softmax, bmm. In a bf16 model
(pipeline.cast_model) the clip is normalised in float32 and cast to the
weights' dtype, and every product and the attention run in ATen, as on the
CPU.

State: linear weights [in, out] (``w``, ``b``), LayerNorms ``weight`` and
``bias``, the positional convolution's ``weight_g`` [1, 1, 128] and
``weight_v`` [1024, 64, 128]; fadbench/reference/wavlm.py has the same keys.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import launches
from ..ops.wavlm_attn import wavlm_attention
from ..ops.window_attn import gemm_tf32
from ..utils import profiling

EMBEDDING_SIZE = 1024
NORM_EPS = 1e-7  # Wav2Vec2FeatureExtractor's per-clip normalisation
LN_EPS = 1e-5  # every LayerNorm (config layer_norm_eps; gemm_tf32's LayerNorm)


@dataclass(frozen=True)
class WavLMConfig:
    """The published widths (microsoft/wavlm-large config.json); tests build
    smaller ones."""

    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    intermediate: int = 4096
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    num_buckets: int = 320
    max_distance: int = 800
    gate_dim: int = 8


WAVLM_LARGE = WavLMConfig()


def num_frames(samples: int, cfg: WavLMConfig = WAVLM_LARGE) -> int:
    """Frames the convolution chain makes of ``samples`` (0 where it makes none)."""
    t = samples
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        t = (t - k) // s + 1 if t >= k else 0
    return t


def relative_bucket(rel: torch.Tensor, num_buckets: int = 320,
                    max_distance: int = 800) -> torch.Tensor:
    """HF's _relative_positions_bucket of relative positions s - t: half the
    buckets for s > t, exact below a quarter of them (80), logarithmic up to
    max_distance and clamped at the half's last (float32 as HF computes it)."""
    half = num_buckets // 2
    exact = half // 2
    mag = rel.abs()
    large = torch.log(mag.clamp_min(1).float() / exact)
    large = large / math.log(max_distance / exact) * (half - exact)
    large = torch.clamp_max((exact + large).to(torch.long), half - 1)
    return (rel > 0).to(torch.long) * half + torch.where(mag < exact, mag, large)


def _hand_attention(x: torch.Tensor) -> bool:
    """Whether the attention of a model whose tensors are like x runs the
    hand kernel: float32 on the card. Elsewhere it runs in ATen."""
    return x.is_cuda and x.dtype == torch.float32


def _param(*shape) -> nn.Parameter:
    # Uninitialised: every parameter comes from a state_dict (utils.weights
    # or the benchmark's reference).
    return nn.Parameter(torch.empty(shape), requires_grad=False)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = _param(dim)
        self.bias = _param(dim)

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, LN_EPS)


class Dense(nn.Module):
    """Holds w [in, out] and b [out]."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.w = _param(din, dout)
        self.b = _param(dout)


def _linear(x, w, b, *, ln: LayerNorm = None, gelu: bool = False, residual=None):
    """op(x) @ w + b (+ residual) over rows x [M, K], op the LayerNorm ``ln``
    or the GELU applied first: float32 on gemm_tf32 (on the card, one
    ``wavlm_gemm`` launch), a reduced dtype in ATen."""
    if x.dtype == torch.float32:
        return gemm_tf32(x, w, b, key="wavlm_gemm", gelu=gelu, residual=residual,
                         ln=None if ln is None else (ln.weight, ln.bias))
    if ln is not None:
        x = ln(x)
    elif gelu:
        x = F.gelu(x)
    y = torch.addmm(b, x, w)
    return y if residual is None else residual + y


class ConvLayer(nn.Module):
    """Conv1d without bias, LayerNorm over the channels of each frame, GELU:
    [B, C_in, T] -> [B, T', C] (contiguous; the next layer reads its transpose)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int):
        super().__init__()
        self.conv = nn.Module()
        self.conv.weight = _param(cout, cin, kernel)
        self.layer_norm = LayerNorm(cout)
        self.stride = stride

    def forward(self, x):
        return F.gelu(self.layer_norm(F.conv1d(x, self.conv.weight, stride=self.stride)
                                      .transpose(1, 2)))


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        cins = (1,) + cfg.conv_dim[:-1]
        self.conv_layers = nn.ModuleList(
            ConvLayer(*args) for args in zip(cins, cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride))

    def forward(self, x):
        """[B, 1, S] -> [B, T, C]."""
        for i, layer in enumerate(self.conv_layers):
            x = layer(x if i == 0 else x.transpose(1, 2))
        return x


class PositionalConv(nn.Module):
    """x + GELU(grouped Conv1d(x) without its last frame), the weight-normed
    weight g * v / |v| folded into the ``weight`` buffer each time a state is
    loaded (as torch's weight_norm with dim=2 forms it)."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        c, k = cfg.hidden, cfg.pos_conv_kernel
        self.groups = cfg.pos_conv_groups
        self.weight_g = _param(1, 1, k)
        self.weight_v = _param(c, c // self.groups, k)
        self.bias = _param(c)
        self.register_buffer("weight", torch.empty((c, c // self.groups, k)), persistent=False)
        self.register_load_state_dict_post_hook(PositionalConv._after_load)

    @staticmethod
    def _after_load(module: "PositionalConv", incompatible_keys) -> None:
        v = module.weight_v.detach()
        module.weight = v * (module.weight_g.detach() / v.square().sum(dim=(0, 1), keepdim=True)
                             .sqrt())

    def forward(self, x, b: int, t: int):
        """x [B * T, C] -> the same, the embedding added."""
        k = self.weight.shape[-1]
        y = F.conv1d(x.view(b, t, -1).transpose(1, 2), self.weight, self.bias, padding=k // 2,
                     groups=self.groups)
        if k % 2 == 0:
            y = y[..., :-1]  # SamePad
        return x + F.gelu(y).transpose(1, 2).reshape(b * t, -1)


class Attention(nn.Module):
    """The gated relative-position self-attention (module docstring). The
    load hook folds the gate's Linear(64, 8) into 8 * heads block-diagonal
    columns after qkv's (the ``qkvg_w``, ``qkvg_b`` buffers)."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        c, h = cfg.hidden, cfg.heads
        self.heads, self.gate_dim = h, cfg.gate_dim
        self.qkv = Dense(c, 3 * c)
        self.gate = Dense(c // h, cfg.gate_dim)
        self.gate_const = _param(h)  # gru_rel_pos_const
        self.out = Dense(c, c)
        n = 3 * c + h * cfg.gate_dim
        self.register_buffer("qkvg_w", torch.empty((c, n)), persistent=False)
        self.register_buffer("qkvg_b", torch.empty((n,)), persistent=False)
        self.register_load_state_dict_post_hook(Attention._after_load)

    @staticmethod
    def _after_load(module: "Attention", incompatible_keys) -> None:
        gate_w, gate_b = module.gate.w.detach(), module.gate.b.detach()
        module.qkvg_w = torch.cat(
            [module.qkv.w.detach(), torch.block_diag(*[gate_w] * module.heads)], dim=1)
        module.qkvg_b = torch.cat([module.qkv.b.detach(), gate_b.repeat(module.heads)])

    def forward(self, qkvg: torch.Tensor, b: int, t: int, bias: torch.Tensor) -> torch.Tensor:
        """qkvg [B * T, 3C + 8H] (q, k, v, the gate's projection) and the
        position bias as Encoder.position_bias gives it (the [H, 2T - 1]
        relative table for the hand kernel, else [H, T, T]) -> the heads'
        outputs [B * T, C]."""
        if _hand_attention(qkvg):
            return wavlm_attention(qkvg, bias, self.gate_const, b, t)
        if qkvg.is_cuda:
            launches.count("wavlm_attention[bf16]")
        return self.aten_forward(qkvg, b, t, bias)

    def aten_forward(self, qkvg: torch.Tensor, b: int, t: int, bias: torch.Tensor) -> torch.Tensor:
        """The attention in ATen (the CPU's and a bf16 model's; on a float32
        card, what the hand kernel replaced): bias [H, T, T]."""
        h = self.heads
        c = self.qkv.w.shape[1] // 3
        d = c // h
        half = self.gate_dim // 2
        ga, gb = torch.sigmoid(qkvg[:, 3 * c:].view(b, t, h, 2, half).sum(-1)).unbind(-1)
        gate = ga * (gb * self.gate_const - 1.0) + 2.0  # [B, T, H]
        q, k, v = qkvg[:, : 3 * c].view(b, t, 3, h, d).permute(2, 0, 3, 1, 4).reshape(
            3, b * h, t, d).unbind(0)
        scores = q.new_empty((b * h, t, t)).baddbmm_(q, k.transpose(1, 2), beta=0.0,
                                                     alpha=d ** -0.5)
        scores.view(b, h, t, t).addcmul_(gate.transpose(1, 2)[..., None], bias)
        probs = torch.softmax(scores, dim=-1)
        del scores
        return torch.bmm(probs, v).view(b, h, t, d).transpose(1, 2).reshape(b * t, c)


class Layer(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.layer_norm = LayerNorm(cfg.hidden)
        self.attention = Attention(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden)
        self.fc1 = Dense(cfg.hidden, cfg.intermediate)
        self.fc2 = Dense(cfg.intermediate, cfg.hidden)

    def forward(self, x, b: int, t: int, bias: torch.Tensor) -> torch.Tensor:
        a = self.attention
        qkvg = _linear(x, a.qkvg_w, a.qkvg_b, ln=self.layer_norm)
        x = _linear(a(qkvg, b, t, bias), a.out.w, a.out.b, residual=x)
        hidden = _linear(x, self.fc1.w, self.fc1.b, ln=self.final_layer_norm)
        return _linear(hidden, self.fc2.w, self.fc2.b, gelu=True, residual=x)


class Encoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        self.pos_conv = PositionalConv(cfg)
        self.rel_attn_embed = _param(cfg.num_buckets, cfg.heads)  # layer 0's table
        self.layers = nn.ModuleList(Layer(cfg) for _ in range(cfg.layers))
        self.layer_norm = LayerNorm(cfg.hidden)

    def relative_table(self, t: int) -> torch.Tensor:
        """[H, 2T - 1]: E[bucket(r), h] at column r + T - 1, for r = s - t
        from 1 - T to T - 1."""
        rel = torch.arange(1 - t, t, device=self.rel_attn_embed.device)
        buckets = relative_bucket(rel, self.cfg.num_buckets, self.cfg.max_distance)
        return self.rel_attn_embed[buckets].t().contiguous()

    def position_bias(self, t: int) -> torch.Tensor:
        """The bias Attention.forward takes on this model's device and dtype:
        the relative table where the hand kernel runs, else [H, T, T]:
        E[bucket(s - t), h]."""
        if _hand_attention(self.rel_attn_embed):
            return self.relative_table(t)
        pos = torch.arange(t, device=self.rel_attn_embed.device)
        buckets = relative_bucket(pos[None, :] - pos[:, None], self.cfg.num_buckets,
                                  self.cfg.max_distance)
        return self.rel_attn_embed[buckets].permute(2, 0, 1).contiguous()

    def forward(self, x, b: int, t: int) -> torch.Tensor:
        """x [B * T, C] -> the final LayerNorm's rows [B * T, C]."""
        with profiling.annotate("wavlm.pos_conv"):
            x = self.pos_conv(x, b, t)
        bias = self.position_bias(t)
        with profiling.annotate("wavlm.layers"):
            for layer in self.layers:
                x = layer(x, b, t, bias)
        return self.layer_norm(x)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.layer_norm = LayerNorm(cfg.conv_dim[-1])
        self.projection = Dense(cfg.conv_dim[-1], cfg.hidden)


class WavLM(nn.Module):
    """[B, S] float32 audio at 16 kHz -> [B, T, hidden] rows, T = num_frames(S)."""

    def __init__(self, cfg: WavLMConfig = WAVLM_LARGE):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        if wave.dim() != 2:
            raise ValueError(f"expected [B, S] audio, got {tuple(wave.shape)}")
        wave = wave.to(torch.float32)
        var, mean = torch.var_mean(wave, dim=-1, correction=0, keepdim=True)
        x = ((wave - mean) / torch.sqrt(var + NORM_EPS)).to(self.encoder.layer_norm.weight.dtype)
        with profiling.annotate("wavlm.features"):
            feats = self.feature_extractor(x[:, None])
        b, t, _ = feats.shape
        proj = self.feature_projection
        x = _linear(feats.reshape(b * t, -1), proj.projection.w, proj.projection.b,
                    ln=proj.layer_norm)
        del feats
        return self.encoder(x, b, t).view(b, t, -1)
