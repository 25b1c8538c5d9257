"""Encodec SEANet encoder as a torch module, in NCW layout.

Port of frechet_audio_distance_exported_tpu/models/encodec.py (L54-311):
- input conv k=7 (channels -> 32);
- 4 stages with downsample ratios (2, 4, 5, 8), a hop of 320 in all: each a
  residual block (ELU -> conv k=3 dim->dim/2 -> ELU -> conv k=1 dim/2->dim,
  plus a k=1 shortcut conv), then ELU and a strided conv k=2r, s=r that
  doubles the width (32 -> 64 -> 128 -> 256 -> 512);
- a 2-layer LSTM(512) with the residual skip y = lstm(x) + x;
- ELU -> output conv k=7 (512 -> 128).

The two variants: 24 kHz is mono and causal (weight norm folded into the
weights); 48 kHz is stereo, centred, with GroupNorm(1, C) after every conv
(JAX models/common.group_norm_full L100-129, as nn.GroupNorm).

Every conv reflect-pads by Encodec's math.ceil-based amounts first
(_pad_amounts). The JAX package's TPU choices (bf16 convolutions, bf16 LSTM
operands, the fused two-layer scan) are not carried over: the LSTM is
nn.LSTM in float32, which computes the same recurrence, gate order i, f, g, o.

Input:  [B, C, S] float32 waveform, or PCM16-exact int16 (k/32768)
Output: [B, T, 128] frame embeddings, T = ceil(S / 320)
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

EMBEDDING_SIZE = 128
N_FILTERS = 32
DIMENSION = 128
RATIOS = (2, 4, 5, 8)  # encoder order
HIDDEN = N_FILTERS * 2 ** len(RATIOS)  # 512
LSTM_LAYERS = 2
# The two published variants, by sample rate (JAX pipeline.py:414: causal at 24 kHz).
VARIANTS = {24000: {"channels": 1, "causal": True}, 48000: {"channels": 2, "causal": False}}


# Copied from frechet_audio_distance_exported_tpu/models/encodec.py:54.
def _pad_amounts(length: int, kernel: int, stride: int, causal: bool):
    padding_total = kernel - stride
    n_frames = (length - kernel + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel - padding_total)
    extra = ideal_length - length
    if causal:
        return padding_total, extra
    right = padding_total // 2
    return padding_total - right, right + extra


class SConv(nn.Module):
    """Reflect pad, conv, then GroupNorm(1, C) where the variant has it (JAX
    _sconv L65-73)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 causal: bool = True, group_norm: bool = False):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, stride)
        self.gn = nn.GroupNorm(1, cout, eps=1e-5) if group_norm else None
        self.causal = causal

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        left, right = _pad_amounts(
            x.shape[-1], self.conv.kernel_size[0], self.conv.stride[0], self.causal
        )
        if left or right:
            x = F.pad(x, (left, right), mode="reflect")
        y = self.conv(x)
        return y if self.gn is None else self.gn(y)


class ResBlock(nn.Module):
    """shortcut(x) + conv2(elu(conv1(elu(x)))) (JAX _res_block L76-87)."""

    def __init__(self, dim: int, causal: bool, group_norm: bool):
        super().__init__()
        self.conv1 = SConv(dim, dim // 2, 3, causal=causal, group_norm=group_norm)
        self.conv2 = SConv(dim // 2, dim, 1, causal=causal, group_norm=group_norm)
        self.shortcut = SConv(dim, dim, 1, causal=causal, group_norm=group_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(F.elu(self.conv1(F.elu(x))))
        return self.shortcut(x) + h


class Stage(nn.Module):
    """ResBlock, ELU, then the strided conv that doubles the width."""

    def __init__(self, dim: int, ratio: int, causal: bool, group_norm: bool):
        super().__init__()
        self.res = ResBlock(dim, causal, group_norm)
        self.down = SConv(dim, 2 * dim, 2 * ratio, ratio, causal=causal, group_norm=group_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.elu(self.res(x)))


class SLSTM(nn.LSTM):
    """The 2-layer LSTM with the SEANet residual skip, on [B, C, T] (JAX
    _slstm L102-183). Its state_dict is nn.LSTM's (weight_ih_l0, ...)."""

    def __init__(self, dim: int = HIDDEN, num_layers: int = LSTM_LAYERS):
        super().__init__(dim, dim, num_layers=num_layers, batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = x.transpose(1, 2)  # [B, T, C]
        y, _ = super().forward(seq)
        return (y + seq).transpose(1, 2)


class Encodec(nn.Module):
    """The SEANet encoder. causal=True is the 24 kHz variant, causal=False
    the 48 kHz one, which has GroupNorm after every conv (JAX
    init_encodec_params L276-311)."""

    def __init__(self, channels: int = 1, causal: bool = True):
        super().__init__()
        gn = not causal
        self.channels = channels
        self.conv_in = SConv(channels, N_FILTERS, 7, causal=causal, group_norm=gn)
        self.stages = nn.ModuleList(
            Stage(N_FILTERS * 2 ** i, ratio, causal, gn) for i, ratio in enumerate(RATIOS)
        )
        self.lstm = SLSTM()
        self.conv_out = SConv(HIDDEN, DIMENSION, 7, causal=causal, group_norm=gn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 3 or x.shape[1] != self.channels:
            raise ValueError(f"expected a [B, {self.channels}, S] waveform, got {tuple(x.shape)}")
        if x.dtype == torch.int16:
            x = x.to(torch.float32) / 32768.0  # JAX L232-233: not CLAP's 32767
        h = self.conv_in(x)
        for stage in self.stages:
            h = stage(h)
        h = self.conv_out(F.elu(self.lstm(h)))
        return h.transpose(1, 2)  # [B, T, 128]


def encodec_for_rate(sample_rate: int) -> Encodec:
    """The 24 kHz (mono, causal) or the 48 kHz (stereo, GroupNorm) encoder."""
    return Encodec(**VARIANTS[sample_rate])
