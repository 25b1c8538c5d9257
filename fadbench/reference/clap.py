"""Plain CLAP audio branch of the benchmark's reference: int16 PCM at 48 kHz
-> the int16 round trip -> log-mel -> bicubic 1001 -> 1024 interpolation ->
HTSAT-tiny Swin -> projection -> unit 512-d rows, in float32 torch.

Frozen from frechet_audio_distance_exported_tpu_torch/models/clap.py (the
network, its parameter names and its constants: the bicubic matrix, the
relative-position index, the shift masks), the plain window attention of
ops/window_attn.py, and pipeline.EmbeddingPipeline._clap_prep (the host
steps). LayerNorms here are torch's own; the interpolation is one product
with the bicubic matrix. Every size comes from fadbench/configs/clap.json.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import dsp


def bicubic_matrix(in_t: int, out_t: int) -> np.ndarray:
    """[out_t, in_t] bicubic interpolation, align_corners=True, A = -0.75,
    edge taps clamped (torch's F.interpolate(mode='bicubic'))."""
    a = -0.75

    def cc1(x):
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def cc2(x):
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    m = np.zeros((out_t, in_t), dtype=np.float64)
    scale = (in_t - 1) / (out_t - 1)
    for j in range(out_t):
        src = j * scale
        i0 = int(np.floor(src))
        t = src - i0
        for k, wk in enumerate((cc2(t + 1.0), cc1(t), cc1(1.0 - t), cc2(2.0 - t))):
            m[j, min(max(i0 - 1 + k, 0), in_t - 1)] += wk
    return m.astype(np.float32)


def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def shift_mask(res: int, ws: int, shift: int) -> np.ndarray:
    """[windows, N, N] additive mask: -100 between tokens of different regions."""
    img = np.zeros((res, res), dtype=np.int64)
    cnt = 0
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for hs in slices:
        for wsl in slices:
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(res // ws, ws, res // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(win[:, None, :] != win[:, :, None], -100.0, 0.0).astype(np.float32)


def _p(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape), requires_grad=False)


class LayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma, self.beta = _p(dim), _p(dim)

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.gamma, self.beta, 1e-5)


class Dense(nn.Module):
    """x @ w (+ b), w stored [in, out]."""

    def __init__(self, din, dout, bias=True):
        super().__init__()
        self.w = _p(din, dout)
        self.b = _p(dout) if bias else None

    def forward(self, x):
        y = torch.matmul(x, self.w)
        return y if self.b is None else y + self.b


class BatchNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma, self.beta, self.mean, self.var = _p(dim), _p(dim), _p(dim), _p(dim)

    def forward(self, x):
        return (x - self.mean) * torch.rsqrt(self.var + 1e-5) * self.gamma + self.beta


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1, self.fc2 = Dense(dim, hidden), Dense(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, res, shift, ws, mlp_ratio):
        super().__init__()
        self.heads, self.res, self.shift, self.ws = heads, res, shift, ws
        self.norm1 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim)
        self.rel_bias = _p((2 * ws - 1) ** 2, heads)
        self.proj = Dense(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, mlp_ratio * dim)
        n = ws * ws
        mask = shift_mask(res, ws, shift) if shift else np.zeros((1, n, n), np.float32)
        self.register_buffer("mask", torch.from_numpy(mask), persistent=False)
        index = torch.from_numpy(relative_position_index(ws).reshape(-1))
        self.register_buffer("rel_index", index, persistent=False)

    def attention(self, x):
        """[BW, N, C] windows -> attention output [BW, N, C]."""
        bw, n, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).reshape(bw, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        bias = self.rel_bias[self.rel_index].reshape(n, n, self.heads).permute(2, 0, 1)
        logits = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5 + bias
        nw = self.mask.shape[0]
        logits = (logits.reshape(bw // nw, nw, self.heads, n, n) + self.mask[None, :, None])
        attn = torch.matmul(torch.softmax(logits.reshape(bw, self.heads, n, n), -1), v)
        return self.proj(attn.transpose(1, 2).reshape(bw, n, c))

    def forward(self, x):
        b, l, c = x.shape
        res, ws, s = self.res, self.ws, self.shift
        h = self.norm1(x).reshape(b, res, res, c)
        if s:
            h = torch.roll(h, (-s, -s), dims=(1, 2))
        h = h.reshape(b, res // ws, ws, res // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        h = self.attention(h.reshape(-1, ws * ws, c))
        h = h.reshape(b, res // ws, res // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        h = h.reshape(b, res, res, c)
        if s:
            h = torch.roll(h, (s, s), dims=(1, 2))
        x = x + h.reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x, res):
        b, _, c = x.shape
        x = x.reshape(b, res, res, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.reshape(b, (res // 2) ** 2, 4 * c)))


class Stage(nn.Module):
    def __init__(self, cfg, i):
        super().__init__()
        ws = cfg["window_size"]
        dim = cfg["embed_dim"] * 2 ** i
        self.res = cfg["spec_size"] // cfg["patch_size"] // 2 ** i
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg["num_heads"][i], self.res,
                      0 if (j % 2 == 0 or self.res <= ws) else ws // 2, ws, cfg["mlp_ratio"])
            for j in range(cfg["depths"][i])
        )
        self.downsample = PatchMerging(dim) if i < len(cfg["depths"]) - 1 else None

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x if self.downsample is None else self.downsample(x, self.res)


class PatchEmbed(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        p, dim = cfg["patch_size"], cfg["embed_dim"]
        self.stride = p
        self.conv = nn.Module()
        self.conv.w, self.conv.b = _p(dim, 1, p, p), _p(dim)
        self.norm = LayerNorm(dim)

    def forward(self, img):
        x = F.conv2d(img[:, None], self.conv.w, self.conv.b, stride=self.stride)
        return self.norm(x.flatten(2).transpose(1, 2))


class Projection(nn.Module):
    def __init__(self, din, dims):
        super().__init__()
        self.fc1, self.fc2 = Dense(din, dims[0]), Dense(dims[0], dims[1])

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class CLAP(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        interp = bicubic_matrix(cfg["time_frames"], cfg["target_frames"])
        self.register_buffer("interp", torch.from_numpy(interp), persistent=False)
        self.bn0 = BatchNorm(cfg["mel_bands"])
        self.patch_embed = PatchEmbed(cfg)
        self.stages = nn.ModuleList(Stage(cfg, i) for i in range(len(cfg["depths"])))
        width = cfg["embed_dim"] * 2 ** (len(cfg["depths"]) - 1)
        self.norm = LayerNorm(width)
        self.projection = Projection(width, cfg["projection_dims"])

    def forward(self, log_mel):
        """[B, time_frames, bands] -> [B, d] unit rows."""
        cfg = self.cfg
        b, size, ratio = log_mel.shape[0], cfg["spec_size"], cfg["freq_ratio"]
        x = self.bn0(torch.matmul(self.interp, log_mel))
        x = x.reshape(b, ratio, cfg["target_frames"] // ratio, cfg["mel_bands"]).transpose(2, 3)
        x = self.patch_embed(x.reshape(b, size, size))
        for stage in self.stages:
            x = stage(x)
        emb = self.projection(self.norm(x).mean(dim=1))
        return emb / torch.clamp_min(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), 1e-12)


def build(cfg: dict, device) -> CLAP:
    with torch.device(device):
        model = CLAP(cfg)
    # The constant buffers come from NumPy, on the host.
    return model.to(device).eval()


def init_state(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The JAX initializer's law: weights and relative-position tables
    trunc-normal (std 0.02, cut at 2 std), drawn in one call; biases zero;
    LayerNorms and bn0 the identity."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in CLAP(cfg).state_dict().items()}
    drawn = [k for k in shapes if k.rsplit(".", 1)[-1] in ("w", "rel_bias")]
    flat = torch.empty(sum(torch.Size(shapes[k]).numel() for k in drawn), device=device)
    torch.nn.init.trunc_normal_(flat, std=0.02, a=-0.04, b=0.04, generator=gen)
    state, at = {}, 0
    for key, shape in shapes.items():
        leaf = key.rsplit(".", 1)[-1]
        if key in drawn:
            n = torch.Size(shape).numel()
            state[key] = flat[at : at + n].view(shape)
            at += n
        else:
            fill = 1.0 if leaf in ("gamma", "var") else 0.0
            state[key] = torch.full(shape, fill, device=device)
    return state


def rows_per_clip(cfg: dict, samples: int) -> int:
    return 1


def logmel_input(pcm: torch.Tensor, cfg: dict) -> torch.Tensor:
    """int16 [B, S] -> [B, time_frames, bands]: decode (k / 32768), cut at
    the frames' read window or zero-pad to clip_max_samples, the int16
    round trip (truncation toward zero), the centred log-mel. After the pad
    every clip has all time_frames frames."""
    hop, t = cfg["stft_hop_samples"], cfg["time_frames"]
    wave = pcm.to(torch.float32) / 32768.0
    need = (t + 2) * hop
    wave = wave[:, :need]
    if wave.shape[-1] < cfg["clip_max_samples"]:
        wave = F.pad(wave, (0, cfg["clip_max_samples"] - wave.shape[-1]))
    wave = (wave * 32767.0).to(torch.int16).to(torch.float32) / 32767.0
    return dsp.pann_logmel(wave, t, cfg)


def embed(model: CLAP, pcm: torch.Tensor) -> torch.Tensor:
    """int16 [B, S] -> [B, 1, d] float32 rows."""
    return model(logmel_input(pcm, model.cfg))[:, None]
