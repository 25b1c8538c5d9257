"""Plain WavLM-Large encoder of the benchmark's reference: int16 PCM at
16 kHz -> each clip normalised -> the convolutional feature extractor -> the
feature projection -> the positional convolution -> 24 pre-LN transformer
layers with gated relative-position attention -> the final LayerNorm's rows,
[B, T, 1024], in float32 torch.

Written from HF transformers' WavLMModel with do_stable_layer_norm true and
feat_extract_norm "layer" (modeling_wavlm.py: WavLMLayerNormConvLayer,
WavLMFeatureProjection, WavLMPositionalConvEmbedding, WavLMSamePadLayer,
WavLMAttention, WavLMEncoderLayerStableLayerNorm,
WavLMEncoderStableLayerNorm; Chen et al. 2022, arXiv:2110.13900), with
none of the port. Every size comes from fadbench/configs/wavlm-large.json.
Departures from HF, none of which changes the arithmetic of inference:

- no dropout, no SpecAugment masking and no attention mask: the clips of one
  call have one length, so nothing is padded;
- Wav2Vec2FeatureExtractor's per-clip normalisation, (x - mean) /
  sqrt(var + 1e-7) with the population variance, runs here in torch on the
  rows the benchmark generated, not in numpy on the host;
- the positional convolution's weight_norm is written out, g * v / |v| with
  the norm over the output and input channels of each tap, each forward;
- linear weights are stored [in, out] (x @ w + b), and q, k and v are one
  [1024, 3072] product, the port's layout: the same three products;
- the attention is written out as F.multi_head_attention_forward computes
  it with the gated bias as its float attn_mask: q scaled by head_dim^-1/2,
  baddbmm of the gated bias [B * H, T, T] and q k^T, softmax, bmm, the out
  projection;
- the row is the last hidden state (which layer a FAD toolkit scores varies).

Parameter names are the port's state_dict keys, so one state serves both
sides.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn


def _p(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape), requires_grad=False)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight, self.bias = _p(dim), _p(dim)
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


class Dense(nn.Module):
    """x @ w + b, w stored [in, out]."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.w, self.b = _p(din, dout), _p(dout)

    def forward(self, x):
        return torch.matmul(x, self.w) + self.b


class ConvLayer(nn.Module):
    """WavLMLayerNormConvLayer: conv (no bias), LayerNorm over channels, GELU."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, eps: float):
        super().__init__()
        self.conv = nn.Module()
        self.conv.weight = _p(cout, cin, kernel)
        self.layer_norm = LayerNorm(cout, eps)
        self.stride = stride

    def forward(self, x):
        """[B, C_in, T] -> [B, C, T']."""
        x = F.conv1d(x, self.conv.weight, stride=self.stride)
        x = self.layer_norm(x.transpose(-2, -1)).transpose(-2, -1)
        return F.gelu(x)


class FeatureProjection(nn.Module):
    def __init__(self, din: int, dout: int, eps: float):
        super().__init__()
        self.layer_norm = LayerNorm(din, eps)
        self.projection = Dense(din, dout)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PositionalConv(nn.Module):
    """WavLMPositionalConvEmbedding: the weight-normed grouped convolution,
    SamePad (the last frame dropped for an even kernel), GELU."""

    def __init__(self, c: int, kernel: int, groups: int):
        super().__init__()
        self.weight_g = _p(1, 1, kernel)
        self.weight_v = _p(c, c // groups, kernel)
        self.bias = _p(c)
        self.kernel, self.groups = kernel, groups

    def forward(self, x):
        """[B, T, C] -> the embedding [B, T, C]."""
        norm = torch.sqrt(torch.sum(self.weight_v ** 2, dim=(0, 1), keepdim=True))
        weight = self.weight_g * self.weight_v / norm
        y = F.conv1d(x.transpose(1, 2), weight, self.bias, padding=self.kernel // 2,
                     groups=self.groups)
        if self.kernel % 2 == 0:
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class Attention(nn.Module):
    """WavLMAttention with its gated relative-position bias."""

    def __init__(self, c: int, heads: int, gate_out: int):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(c, 3 * c)
        self.gate = Dense(c // heads, gate_out)  # gru_rel_pos_linear
        self.gate_const = _p(heads)  # gru_rel_pos_const
        self.out = Dense(c, c)

    def forward(self, h, position_bias):
        """h = LN1(x) [B, T, C], position_bias [H, T, T] -> [B, T, C]."""
        b, t, c = h.shape
        heads, d = self.heads, c // self.heads
        # The gate, from the layer's normalised input: [B, H, T, 1].
        gated = h.view(b, t, heads, d).permute(0, 2, 1, 3)
        proj = self.gate(gated)
        gate = proj.view(b, heads, t, 2, proj.shape[-1] // 2).sum(-1)
        gate_a, gate_b = torch.sigmoid(gate).chunk(2, dim=-1)
        gate = gate_a * (gate_b * self.gate_const.view(1, heads, 1, 1) - 1.0) + 2.0
        bias = position_bias.unsqueeze(0).repeat(b, 1, 1, 1).view(b * heads, t, t)
        bias = gate.view(b * heads, t, 1) * bias
        q, k, v = self.qkv(h).split(c, dim=-1)

        def split_heads(z):
            return z.view(b, t, heads, d).transpose(1, 2).reshape(b * heads, t, d)

        q = split_heads(q) * d ** -0.5
        probs = torch.softmax(torch.baddbmm(bias, q, split_heads(k).transpose(1, 2)), dim=-1)
        ctx = torch.bmm(probs, split_heads(v))
        return self.out(ctx.view(b, heads, t, d).transpose(1, 2).reshape(b, t, c))


class Layer(nn.Module):
    """WavLMEncoderLayerStableLayerNorm."""

    def __init__(self, cfg: dict):
        super().__init__()
        c, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.layer_norm = LayerNorm(c, eps)
        self.attention = Attention(c, cfg["num_attention_heads"], cfg["gru_rel_pos_linear_out"])
        self.final_layer_norm = LayerNorm(c, eps)
        self.fc1 = Dense(c, cfg["intermediate_size"])
        self.fc2 = Dense(cfg["intermediate_size"], c)

    def forward(self, x, position_bias):
        x = x + self.attention(self.layer_norm(x), position_bias)
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


def relative_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """WavLMAttention._relative_positions_bucket, as HF writes it."""
    num_buckets = num_buckets // 2
    buckets = (rel > 0).to(torch.long) * num_buckets
    rel = torch.abs(rel)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    if_large = torch.log(rel.float() / max_exact)
    if_large = if_large / math.log(max_distance / max_exact)
    if_large = if_large * (num_buckets - max_exact)
    if_large = (max_exact + if_large).to(torch.long)
    if_large = torch.min(if_large, torch.full_like(if_large, num_buckets - 1))
    return buckets + torch.where(is_small, rel, if_large)


class Encoder(nn.Module):
    """WavLMEncoderStableLayerNorm; layer 0's relative-position table serves
    every layer (HF computes the bias in layer 0 and hands it on)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        c = cfg["hidden_size"]
        self.pos_conv = PositionalConv(c, cfg["num_conv_pos_embeddings"],
                                       cfg["num_conv_pos_embedding_groups"])
        self.rel_attn_embed = _p(cfg["num_buckets"], cfg["num_attention_heads"])
        self.layers = nn.ModuleList(Layer(cfg) for _ in range(cfg["num_hidden_layers"]))
        self.layer_norm = LayerNorm(c, cfg["layer_norm_eps"])

    def forward(self, x):
        x = x + self.pos_conv(x)
        t = x.shape[1]
        context = torch.arange(t, device=x.device)[:, None]
        memory = torch.arange(t, device=x.device)[None, :]
        buckets = relative_bucket(memory - context, self.cfg["num_buckets"],
                                  self.cfg["max_bucket_distance"])
        position_bias = F.embedding(buckets, self.rel_attn_embed).permute(2, 0, 1)
        for layer in self.layers:
            x = layer(x, position_bias)
        return self.layer_norm(x)


class WavLMLarge(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        eps = cfg["layer_norm_eps"]
        self.feature_extractor = nn.Module()
        cins = [1] + list(cfg["conv_dim"][:-1])
        self.feature_extractor.conv_layers = nn.ModuleList(
            ConvLayer(cin, cout, k, s, eps) for cin, cout, k, s in
            zip(cins, cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"]))
        self.feature_projection = FeatureProjection(cfg["conv_dim"][-1], cfg["hidden_size"], eps)
        self.encoder = Encoder(cfg)

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        """[B, S] float32 audio -> [B, T, hidden]."""
        mean = wave.mean(dim=-1, keepdim=True)
        var = ((wave - mean) ** 2).mean(dim=-1, keepdim=True)
        x = ((wave - mean) / torch.sqrt(var + self.cfg["feature_normalize_eps"]))[:, None]
        for layer in self.feature_extractor.conv_layers:
            x = layer(x)
        x = self.feature_projection(x.transpose(1, 2))
        return self.encoder(x)


def build(cfg: dict, device) -> WavLMLarge:
    with torch.device(device):
        return WavLMLarge(cfg).eval()


def init_state(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The weight law, PyTorch's default initialisation of the modules HF
    builds WavLM from, drawn from ``gen`` on ``device`` (one uniform draw for
    every weight and bias, then one normal draw for the relative-position
    table): convolution and linear weights and biases uniform in
    +-1/sqrt(fan_in), LayerNorms the identity, the relative-position table
    N(0, 1) (nn.Embedding's), gru_rel_pos_const 1, and the positional
    convolution's weight_g the norm of weight_v at each tap (weight_norm's
    start). Under it the gated bias and every residual branch are of the
    stream's order, and the rows follow each clip's spectrum."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in WavLMLarge(cfg).state_dict().items()}
    drawn = [k for k in shapes if k.rsplit(".", 1)[-1] in ("w", "b", "weight", "weight_v")
             and "layer_norm" not in k or k == "encoder.pos_conv.bias"]
    total = sum(torch.Size(shapes[k]).numel() for k in drawn)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    state, at = {}, 0
    for key in drawn:
        shape = shapes[key]
        n = torch.Size(shape).numel()
        u = flat[at : at + n].view(shape)
        at += n
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "w":
            fan_in = shape[0]
        elif leaf == "b":
            fan_in = shapes[key[:-1] + "w"][0]
        else:  # a convolution's weight [out, in / groups, k], or the positional conv's bias
            w = shapes["encoder.pos_conv.weight_v"] if leaf == "bias" else shape
            fan_in = w[1] * w[2]
        state[key] = u * fan_in ** -0.5
    v = state["encoder.pos_conv.weight_v"]
    state["encoder.pos_conv.weight_g"] = torch.sqrt(torch.sum(v ** 2, dim=(0, 1), keepdim=True))
    state["encoder.rel_attn_embed"] = torch.randn(shapes["encoder.rel_attn_embed"],
                                                  generator=gen, device=device)
    for key, shape in shapes.items():
        if key.endswith("layer_norm.weight") or key.endswith("gate_const"):
            state[key] = torch.ones(shape, device=device)
        elif key.endswith("layer_norm.bias"):
            state[key] = torch.zeros(shape, device=device)
    return {k: state[k] for k in shapes}


def embed(model: WavLMLarge, pcm: torch.Tensor) -> torch.Tensor:
    """int16 [B, S] at 16 kHz -> [B, T, hidden] float32 rows (PCM16 decodes
    to k / 32768; each clip is normalised over its own samples)."""
    return model(pcm.to(torch.float32) / 32768.0)
