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
(JAX models/common.group_norm_full L100-129; GroupNorm1, an nn.GroupNorm
that holds its weight and bias).

At 48 kHz each norm is ops/group_norm.py's: on the card csrc/group_norm.cu's
kernel pair, whose moments add the conv's bias as they read (cuDNN runs
without it) and whose apply writes what the next conv reads, in the form
that the module structure gives:
- split: conv_in's norm and the strided convs' of stages 0-2 write the next
  stage's input as it is (the shortcut's) and as conv1's padded ELU;
- elu: conv1's norm writes its ELU, which conv2 (k=1, no pad) reads;
- residual: conv2's and the shortcut's norms, after both moments, write
  the padded ELU of their sum for the strided conv;
- plain: stage 3's strided conv (the LSTM's input) and conv_out.
Between two convs a tensor is then read by the moments and read and written
by the apply: 112 GB a 64-clip chunk of float32, which bounds the pair. In
float32 the result is ATen's chain (pad, conv with bias, the norm, ELU, +)
to the bit. On the CPU the same ATen ops compose as they always have. Both
variants run one topology (ResBlock, Stage): each SConv writes its output
through the epilogue its consumer reads, and an SConv without a norm
composes that epilogue of ATen's pad, ELU and + as the chain does. So the
24 kHz encoder, which has no norm, runs that chain: with no norm's passes
to fold them into, its pads, bias adds, ELUs and adds would need kernels
of their own.

Every conv reflect-pads by Encodec's math.ceil-based amounts first
(_pad_amounts). The LSTM is nn.LSTM in float32 (cuDNN's on the card), which
computes the same recurrence, gate order i, f, g, o.

Mixed precision (JAX L232-260, pipeline.cast_model): in a bf16 model the
input is cast to conv_in's dtype, which every stage's convs share (JAX
casts each stage's input to its weights' dtype: the same), so the
convolution stages run in bf16 (GroupNorm at 48 kHz takes float64 moments inside and rounds
to bf16 where ATen's bf16 ops would), while the LSTM and conv_out keep
float32 weights and the LSTM re-enters float32. FAD_TPU_LSTM_MATMUL=bfloat16
(config.lstm_op_dtype, read at each forward) runs the recurrence as JAX
_slstm(op_dtype=bfloat16) does (L100-183) instead of cuDNN's: layer 0's
input projection hoisted, the carry, the gates and their sums in float32,
only the in-scan recurrent operands rounded to bf16, and layer 1's input
and recurrent products fused as [2H, 4H]. A product of two bf16 values is
exact in float32, so the operands are rounded to bf16 and multiplied in
float32 (TF32 keeps a bf16 value exact too). On the card the step loop is
captured once per input shape in a CUDA graph and replayed: its 19
small launches a step would otherwise be bound by the host.

Input:  [B, C, S] float32 waveform, or PCM16-exact int16 (k/32768)
Output: [B, T, 128] frame embeddings, T = ceil(S / 320)
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import config
from ..ops import group_norm as group_norm_ops

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


class GroupNorm1(nn.GroupNorm):
    """nn.GroupNorm(1, C), with its weight and bias. The encoder hands them
    to ops/group_norm.py's forms with its conv's output (SConv.convolve);
    the module's own forward, called alone, is ops.group_norm: the
    hand-written kernel pair on the card, its plain version on the CPU."""

    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__(1, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_ops.group_norm(x, self.weight, self.bias, self.eps)


class SConv(nn.Module):
    """Reflect pad, conv, then GroupNorm(1, C) where the variant has it (JAX
    _sconv L65-73). Called alone it runs all three. Inside the encoder the
    conv before it writes its input already padded, and one of its
    epilogues (plain, elu_pad, split, residual) writes convolve()'s output
    as the conv after it reads it: where it has a norm, in one apply of
    ops/group_norm.py's pair; without one, with ATen's ops."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 causal: bool = True, group_norm: bool = False):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, stride)
        self.gn = GroupNorm1(cout) if group_norm else None
        self.causal = causal

    def pad_amounts(self, length: int) -> tuple:
        """(left, right): the reflect pad of an input of length samples."""
        return _pad_amounts(length, self.conv.kernel_size[0], self.conv.stride[0], self.causal)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        left, right = self.pad_amounts(x.shape[-1])
        return F.pad(x, (left, right), mode="reflect") if left or right else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.plain(self.convolve(self.pad(x)))

    def convolve(self, x):
        """The conv of x, already padded, as the epilogues take it: without
        a norm the conv's output; with one the norm's input, a
        group_norm_ops.Norm. On the card cuDNN then runs without the bias,
        which the norm's kernels add as they read (ATen would add it in a
        pass of its own, rounding the same); on the CPU the conv adds it, as
        it always has."""
        if self.gn is None:
            return self.conv(x)
        if x.is_cuda:
            y, conv_bias = F.conv1d(x, self.conv.weight, None, self.conv.stride), self.conv.bias
        else:
            y, conv_bias = self.conv(x), None
        return group_norm_ops.Norm(y, conv_bias, self.gn.weight, self.gn.bias, self.gn.eps)

    def plain(self, out) -> torch.Tensor:
        """The output itself: what the LSTM and the encoder's output take."""
        return out if self.gn is None else group_norm_ops.plain(out)

    def elu_pad(self, out, after: "SConv") -> torch.Tensor:
        """after.pad(elu(output)): what a conv after an ELU reads."""
        if self.gn is None:
            return after.pad(F.elu(out))
        return group_norm_ops.elu_pad(out, *after.pad_amounts(out.y.shape[-1]))

    def split(self, out, after: "SConv") -> list:
        """[output, after.pad(elu(output))]: a stage's input, as its
        shortcut and its conv1 (after) read it."""
        if self.gn is None:
            return [out, after.pad(F.elu(out))]
        return list(group_norm_ops.split(out, *after.pad_amounts(out.y.shape[-1])))

    def residual(self, out, other, after: "SConv") -> torch.Tensor:
        """after.pad(elu(output + other)), other being convolve()'s output of
        an SConv of the same variant (the shortcut's, each norm with its own
        moments and affine)."""
        if self.gn is None:
            return after.pad(F.elu(out + other))
        return group_norm_ops.residual(out, other, *after.pad_amounts(out.y.shape[-1]))


class ResBlock(nn.Module):
    """shortcut(x) + conv2(elu(conv1(elu(x)))) (JAX _res_block L76-87)."""

    def __init__(self, dim: int, causal: bool, group_norm: bool):
        super().__init__()
        self.conv1 = SConv(dim, dim // 2, 3, causal=causal, group_norm=group_norm)
        self.conv2 = SConv(dim // 2, dim, 1, causal=causal, group_norm=group_norm)
        self.shortcut = SConv(dim, dim, 1, causal=causal, group_norm=group_norm)

    def forward(self, held: list, after: SConv) -> torch.Tensor:
        """The block's sum, ELU'd and padded for the conv after it (the
        stage's strided conv). held is [x, conv1.pad(elu(x))], as the conv
        before the block wrote them. The block empties it and drops each
        tensor once its last reader has run, so that at most three of a
        stage's largest are alive at once."""
        x, act = held
        held.clear()
        out = self.conv1.convolve(act)
        del act
        h = self.conv1.elu_pad(out, self.conv2)
        del out
        branch = self.conv2.convolve(h)
        del h
        shortcut = self.shortcut.convolve(x)
        del x
        return self.conv2.residual(branch, shortcut, after)


class Stage(nn.Module):
    """ResBlock, ELU, then the strided conv that doubles the width."""

    def __init__(self, dim: int, ratio: int, causal: bool, group_norm: bool):
        super().__init__()
        self.res = ResBlock(dim, causal, group_norm)
        self.down = SConv(dim, 2 * dim, 2 * ratio, ratio, causal=causal, group_norm=group_norm)

    def forward(self, held: list, after: Optional[SConv]):
        """The stage on held (ResBlock's, which it empties): the strided
        conv's output split for the next stage's conv1 (after), or, where
        no stage follows (after None), the output itself."""
        h = self.res(held, self.down)
        out = self.down.convolve(h)
        del h
        return self.down.plain(out) if after is None else self.down.split(out, after)


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bf16 (to nearest even) and back."""
    return t.to(torch.bfloat16).to(torch.float32)


def _lstm_cell(gates: torch.Tensor, c_prev: torch.Tensor):
    """torch gate order i, f, g, o (JAX _lstm_cell L93-97), in six launches:
    one sigmoid over all four gates (g's goes unused)."""
    h = c_prev.shape[-1]
    i, f, _, o = torch.sigmoid(gates).chunk(4, dim=-1)
    c = torch.addcmul(f * c_prev, i, torch.tanh(gates[:, 2 * h : 3 * h]))
    return o * torch.tanh(c), c


def recurrence_bf16_operands(gx0, w0, w1, b1) -> torch.Tensor:
    """The two layers' steps of JAX _slstm with op_dtype=bfloat16
    (L158-183): gx0 [T, B, 4H] is layer 0's hoisted input projection with
    both its biases, w0 [H, 4H] and w1 [2H, 4H] the bf16-rounded recurrent
    and fused layer-1 weights, b1 = b_ih + b_hh of layer 1. Returns layer
    1's outputs [B, T, H], float32."""
    t, b, _ = gx0.shape
    h = w0.shape[0]
    zeros = torch.zeros((b, h), dtype=torch.float32, device=gx0.device)
    h0, c0, h1, c1 = zeros, zeros, zeros, zeros
    ys = []
    for i in range(t):
        h0, c0 = _lstm_cell(torch.addmm(gx0[i], _bf16_round(h0), w0), c0)
        h1, c1 = _lstm_cell(torch.addmm(b1, _bf16_round(torch.cat([h0, h1], dim=-1)), w1), c1)
        ys.append(h1)
    return torch.stack(ys, dim=1)


class SLSTM(nn.LSTM):
    """The 2-layer LSTM with the SEANet residual skip, on [B, C, T] (JAX
    _slstm L102-183), in float32 whatever the input's dtype. Its state_dict
    is nn.LSTM's (weight_ih_l0, ...)."""

    def __init__(self, dim: int = HIDDEN, num_layers: int = LSTM_LAYERS):
        super().__init__(dim, dim, num_layers=num_layers, batch_first=True)
        # One CUDA graph of the bf16-operand step loop per input shape and
        # device: (graph, its static inputs gx0, w0, w1, b1, its output).
        self._graphs = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = x.transpose(1, 2).to(torch.float32)  # [B, T, C]
        if config.lstm_op_dtype() == torch.float32:
            y, _ = super().forward(seq)
        else:
            y = self.forward_bf16_operands(seq)
        return (y + seq).transpose(1, 2)

    def bf16_operands(self, seq: torch.Tensor) -> tuple:
        """(gx0, w0, w1, b1) of recurrence_bf16_operands for seq [B, T, H]:
        layer 0's input projection, time-major, takes both of its biases
        (JAX adds b_hh inside the step: the same sum, in another order)."""
        b, t, h = seq.shape
        gx0 = torch.addmm(self.bias_ih_l0 + self.bias_hh_l0, seq.transpose(0, 1).reshape(t * b, h),
                          self.weight_ih_l0.t())
        w0 = _bf16_round(self.weight_hh_l0).t().contiguous()  # [H, 4H]
        w1 = _bf16_round(torch.cat([self.weight_ih_l1, self.weight_hh_l1], dim=1)).t().contiguous()
        return gx0.reshape(t, b, 4 * h), w0, w1, self.bias_ih_l1 + self.bias_hh_l1

    @torch.inference_mode()
    def forward_bf16_operands(self, seq: torch.Tensor) -> torch.Tensor:
        """Layer 1's outputs [B, T, H] with bf16 recurrent operands: eagerly on
        the CPU, by replaying the CUDA graph of this shape on the card."""
        args = self.bf16_operands(seq)
        if not seq.is_cuda:
            return recurrence_bf16_operands(*args)
        key = (tuple(seq.shape), seq.device)
        if key not in self._graphs:
            static = [a.clone() for a in args]
            side = torch.cuda.Stream(seq.device)
            side.wait_stream(torch.cuda.current_stream(seq.device))
            with torch.cuda.stream(side):  # warm-up before the capture, as CUDA graphs need
                recurrence_bf16_operands(*static)
            torch.cuda.current_stream(seq.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = recurrence_bf16_operands(*static)
            self._graphs[key] = (graph, static, out)
        graph, static, out = self._graphs[key]
        for dst, src in zip(static, args):
            dst.copy_(src)
        graph.replay()
        return out.clone()


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
        # The stages run in conv_in's dtype: cast_model gives every conv of
        # them one dtype, and cuDNN refuses weights of another.
        h = x.to(self.conv_in.conv.weight.dtype)
        conv1s = [stage.res.conv1 for stage in self.stages]
        h = self.conv_in.split(self.conv_in.convolve(self.conv_in.pad(h)), conv1s[0])
        for stage, after in zip(self.stages, conv1s[1:] + [None]):
            h = stage(h, after)
        h = self.conv_out(F.elu(self.lstm(h)))  # the LSTM returns float32
        return h.transpose(1, 2)  # [B, T, 128]


def group_norm_shapes(samples: int) -> list:
    """(C, T) of the input of each of the 48 kHz encoder's 18 GroupNorms, in
    order, on a waveform of samples samples: conv_in; per stage the
    residual block's conv1, conv2 and shortcut, then the strided conv
    (T -> ceil(T / ratio)); conv_out."""
    shapes, t = [(N_FILTERS, samples)], samples
    for i, ratio in enumerate(RATIOS):
        dim = N_FILTERS * 2 ** i
        shapes += [(dim // 2, t), (dim, t), (dim, t)]
        t = -(-t // ratio)
        shapes.append((2 * dim, t))
    return shapes + [(DIMENSION, t)]


def encodec_for_rate(sample_rate: int) -> Encodec:
    """The 24 kHz (mono, causal) or the 48 kHz (stereo, GroupNorm) encoder."""
    return Encodec(**VARIANTS[sample_rate])
