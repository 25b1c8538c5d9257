"""Plain EnCodec 48 kHz encoder of the benchmark's reference: int16 PCM at
48 kHz -> the mono clip duplicated to two channels -> zero-padded to 10 s ->
the SEANet encoder -> 128-d rows, one a 320 samples, in float32 torch.

Written from the published description (Défossez et al. 2022, arXiv:2210.13438;
facebookresearch/encodec, encodec/model.py ``encodec_model_48khz`` and
encodec/modules/seanet.py, conv.py, lstm.py), with none of the port:

- every convolution is padded by EnCodec's non-causal reflect rule
  (conv.get_extra_padding_for_conv1d, pad1d in 'reflect' mode; every input
  here is longer than its pad), applied with F.conv1d and
  followed by GroupNorm(1, C) ("time_group_norm"), whose moments are taken
  here explicitly in float32;
- conv_in (k 7 to n_filters), then per ratio of the encoder's reversed list
  (2, 4, 5, 8) one residual block (ELU, conv k 3 to dim / compress, ELU,
  conv k 1 back to dim, plus a k 1 convolution shortcut: true_skip is
  false) and ELU and a strided conv k 2r, s r that doubles the width;
- a 2-layer LSTM of 512 as an explicit step loop (addmm, gates i, f, g, o,
  sigmoid and tanh) with the skip y = lstm(x) + x;
- ELU and conv_out (k 7 to 128).

Parameter names are the port's state_dict keys, so one state serves both
sides. Every size comes from fadbench/configs/encodec-48k.json.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn


def _p(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape), requires_grad=False)


def extra_padding(length: int, kernel: int, stride: int, padding_total: int) -> int:
    """EnCodec's get_extra_padding_for_conv1d: what makes the last window whole."""
    n_frames = (length - kernel + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel - padding_total)
    return ideal_length - length


class GroupNorm1(nn.Module):
    """GroupNorm(1, C): each clip normalised over all channels and all time."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.weight, self.bias = _p(channels), _p(channels)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(1, 2), keepdim=True)
        d = x - mean
        var = (d * d).mean(dim=(1, 2), keepdim=True)
        return d * torch.rsqrt(var + self.eps) * self.weight[:, None] + self.bias[:, None]


class Conv(nn.Module):
    """Holds a convolution's weight [out, in, k] and bias."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.weight, self.bias = _p(cout, cin, kernel), _p(cout)


class SConv(nn.Module):
    """Non-causal reflect padding, the convolution, GroupNorm(1, C)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, eps: float):
        super().__init__()
        self.conv = Conv(cin, cout, kernel)
        self.gn = GroupNorm1(cout, eps)
        self.kernel, self.stride = kernel, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        total = self.kernel - self.stride  # (kernel - 1) * dilation - (stride - 1), dilation 1
        extra = extra_padding(x.shape[-1], self.kernel, self.stride, total)
        right = total // 2
        x = F.pad(x, (total - right, right + extra), mode="reflect")
        return self.gn(F.conv1d(x, self.conv.weight, self.conv.bias, stride=self.stride))


class ResBlock(nn.Module):
    def __init__(self, dim: int, cfg: dict):
        super().__init__()
        eps, hidden = cfg["group_norm_eps"], dim // cfg["compress"]
        self.conv1 = SConv(dim, hidden, cfg["residual_kernel_size"], 1, eps)
        self.conv2 = SConv(hidden, dim, 1, 1, eps)
        self.shortcut = SConv(dim, dim, 1, 1, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.shortcut(x) + self.conv2(F.elu(self.conv1(F.elu(x))))


class Stage(nn.Module):
    def __init__(self, dim: int, ratio: int, cfg: dict):
        super().__init__()
        self.res = ResBlock(dim, cfg)
        self.down = SConv(dim, 2 * dim, 2 * ratio, ratio, cfg["group_norm_eps"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.elu(self.res(x)))


class LSTM(nn.Module):
    """Layers of h' = o * tanh(c'), c' = f * c + i * g, gates i, f, g, o of
    x W_ih^T + b_ih + h W_hh^T + b_hh, as an explicit loop over time; the
    input products of a layer are taken for all steps at once."""

    def __init__(self, hidden: int, layers: int):
        super().__init__()
        self.hidden, self.layers = hidden, layers
        for l in range(layers):
            for name, shape in (("weight_ih", (4 * hidden, hidden)),
                                ("weight_hh", (4 * hidden, hidden)),
                                ("bias_ih", (4 * hidden,)), ("bias_hh", (4 * hidden,))):
                setattr(self, f"{name}_l{l}", _p(*shape))

    def layer(self, seq: torch.Tensor, l: int) -> torch.Tensor:
        """[T, B, H] -> [T, B, H]."""
        t, b, h = seq.shape
        w_hh = getattr(self, f"weight_hh_l{l}").t()
        bias = getattr(self, f"bias_ih_l{l}") + getattr(self, f"bias_hh_l{l}")
        gx = torch.addmm(bias, seq.reshape(t * b, h), getattr(self, f"weight_ih_l{l}").t())
        gx = gx.view(t, b, 4 * h)
        hs = torch.zeros((b, h), dtype=seq.dtype, device=seq.device)
        cs = torch.zeros_like(hs)
        out = torch.empty_like(seq)
        for i in range(t):
            gates = torch.addmm(gx[i], hs, w_hh)
            ig, fg, gg, og = gates.chunk(4, dim=1)
            cs = torch.sigmoid(fg) * cs + torch.sigmoid(ig) * torch.tanh(gg)
            hs = torch.sigmoid(og) * torch.tanh(cs)
            out[i] = hs
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T] -> lstm(x) + x, [B, C, T]."""
        seq = x.permute(2, 0, 1)
        y = seq
        for l in range(self.layers):
            y = self.layer(y, l)
        return (y + seq).permute(1, 2, 0)


class Encodec48k(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        eps, nf = cfg["group_norm_eps"], cfg["n_filters"]
        self.conv_in = SConv(cfg["channels"], nf, cfg["kernel_size"], 1, eps)
        ratios = list(reversed(cfg["ratios"]))
        self.stages = nn.ModuleList(Stage(nf * 2 ** i, r, cfg) for i, r in enumerate(ratios))
        hidden = nf * 2 ** len(ratios)
        self.lstm = LSTM(hidden, cfg["lstm_layers"])
        self.conv_out = SConv(hidden, cfg["dimension"], cfg["last_kernel_size"], 1, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, channels, S] float32 -> [B, ceil(S / hop), dimension]."""
        h = self.conv_in(x)
        for stage in self.stages:
            h = stage(h)
        return self.conv_out(F.elu(self.lstm(h))).transpose(1, 2)


def build(cfg: dict, device) -> Encodec48k:
    with torch.device(device):
        return Encodec48k(cfg).eval()


def init_state(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The weight law, drawn in one call from ``gen`` on ``device``: conv
    weights uniform in +-1/sqrt(fan_in), conv biases zero, GroupNorm's scale
    1 and shift 0, every LSTM tensor uniform in +-1/sqrt(hidden). With zero
    biases each GroupNorm sees the signal alone, not a constant per channel
    that drowns a quiet clip, so the rows follow the clip's spectrum and,
    through GroupNorm's eps, its level."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in Encodec48k(cfg).state_dict().items()}
    total = sum(torch.Size(s).numel() for s in shapes.values())
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    hidden = cfg["n_filters"] * 2 ** len(cfg["ratios"])
    state, at = {}, 0
    for key, shape in shapes.items():
        n = torch.Size(shape).numel()
        u = flat[at : at + n].view(shape)
        at += n
        if key.startswith("lstm."):
            state[key] = u * hidden ** -0.5
        elif key.endswith("conv.weight"):
            state[key] = u * torch.Size(shape[1:]).numel() ** -0.5
        elif key.endswith("gn.weight"):
            state[key] = torch.ones(shape, device=device)
        else:  # conv and GroupNorm biases
            state[key] = torch.zeros(shape, device=device)
    return state


def rows_per_clip(cfg: dict, samples: int) -> int:
    """The frames a clip keeps: one per whole hop of its own samples."""
    return samples // cfg["hop_length"]


def embed(model: Encodec48k, pcm: torch.Tensor) -> torch.Tensor:
    """int16 mono [B, S] -> [B, S // hop, d] float32 rows (PCM16 decodes to
    k / 32768; the clip is duplicated to two channels and zero-padded to
    10 s, and the encoder runs over the whole padded clip)."""
    cfg = model.cfg
    s = pcm.shape[-1]
    if s > cfg["clip_max_samples"]:
        raise ValueError(f"a clip of {s} samples is longer than {cfg['clip_max_samples']}")
    wave = pcm.to(torch.float32) / 32768.0
    wave = F.pad(wave, (0, cfg["clip_max_samples"] - s))
    x = wave[:, None, :].expand(-1, cfg["channels"], -1)
    return model(x)[:, : rows_per_clip(cfg, s)]
