"""CLAP audio encoder (HTSAT-tiny Swin + projection head) as a torch module.

Port of frechet_audio_distance_exported_tpu/models/clap.py (_clap_forward_jit
L366-416), on the same parameter tree: the module's state_dict keys are the
JAX bundle's flat keys with "." for "/" (stages.2.blocks.5.mlp.fc1.w), linear
weights stay [in, out], and only the patch-embed convolution is stored OIHW.

- bicubic 1001 -> 1024 time interpolation as four index_select gathers,
  weighted and summed in tap order (L376-383; F.interpolate differs by
  about 1e-4);
- bn0 over the 64 mel bins (common.batch_norm L90-97);
- reshape_wav2img: [B, 1024, 64] -> [B, 256, 256] (L387-389);
- patch embed: 4x4 stride-4 convolution to 96 channels, tokens in row-major
  (h, w) order, LayerNorm;
- four Swin stages (depths 2, 2, 6, 2; widths 96-768; heads 4-32; window 8),
  shifted windows on odd blocks while the resolution exceeds the window
  (L401), patch merging between stages (L334-343, reduction without bias);
- final LayerNorm, float32 token mean, fc1 -> ReLU -> fc2, then
  emb / max(|emb|, 1e-12) (L408-416).

The window layers go through ops/window_attn.py, as the JAX package
dispatches them on a TPU (_swin_block L295-331): stages 1-3 through
swin_block_fused, stage 4 (C = 768) through window_attention_fused with its
MLP here in torch; with FAD_TPU_FUSED_BLOCK=0 (config.fused_block, read at
each forward) every stage runs window_attention_fused and the MLP in torch
(JAX L86-97, L310-312). The wrappers run the hand-written CUDA kernels for
CUDA tensors and their plain versions for CPU tensors. LayerNorms outside
the kernels are one-pass, (sum x, sum x^2) with the variance clamped at 0,
like common.layer_norm (L132-148).

In a bf16 model (pipeline.cast_model) the forward follows the JAX package's
dtypes: the interpolation and bn0 run in float32 on the bf16 log-mel and
re-enter the weights' dtype before the patch embedding (L389-393);
LayerNorms take float32 moments and return x.dtype; products return
x.dtype with float32 sums; the shift masks and the interpolation taps stay
float32 while the gathered position bias follows the weights; the tail
(final norm's output, token mean, projection, L2 norm) runs in float32
(L404-417).

Input:  [B, 1001, 64] log-mel (dB)
Output: [B, 512] L2-normalized embeddings
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import config
from ..ops.window_attn import swin_block_fused, window_attention_fused

EMBEDDING_SIZE = 512
TIME_FRAMES = 1001
SPEC_SIZE = 256
FREQ_RATIO = 4
PATCH_SIZE = 4
EMBED_DIM = 96
DEPTHS = (2, 2, 6, 2)
NUM_HEADS = (4, 8, 16, 32)
WINDOW_SIZE = 8
MLP_RATIO = 4
TARGET_T = SPEC_SIZE * FREQ_RATIO  # 1024
MEL_BINS = 64
STAGE_DIMS = tuple(EMBED_DIM * (2 ** i) for i in range(4))  # 96, 192, 384, 768
STAGE_RES = tuple((SPEC_SIZE // PATCH_SIZE) // (2 ** i) for i in range(4))  # 64, 32, 16, 8
# The widest stage whose blocks run whole in swin_block_fused; wider ones run
# window_attention_fused and their MLP in torch (JAX models/clap.py:308-309).
FUSED_BLOCK_MAX_DIM = 384


# ---------------------------------------------------------------------------
# Host-built constants (numpy copies of the JAX package's)
# ---------------------------------------------------------------------------


# Copied from frechet_audio_distance_exported_tpu/models/clap.py:120-142.
@functools.lru_cache(maxsize=4)
def _bicubic_time_matrix(in_t: int, out_t: int) -> np.ndarray:
    """[out_t, in_t] bicubic interpolation matrix, align_corners=True,
    torch's A=-0.75 kernel."""
    a = -0.75

    def cc1(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def cc2(x):  # 1 < |x| < 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    m = np.zeros((out_t, in_t), dtype=np.float64)
    scale = (in_t - 1) / (out_t - 1) if out_t > 1 else 0.0
    for j in range(out_t):
        src = j * scale
        i0 = int(np.floor(src))
        t = src - i0
        w = (cc2(t + 1.0), cc1(t), cc1(1.0 - t), cc2(2.0 - t))
        for k, wk in enumerate(w):
            idx = min(max(i0 - 1 + k, 0), in_t - 1)
            m[j, idx] += wk
    return m.astype(np.float32)


# Copied from frechet_audio_distance_exported_tpu/models/clap.py:145-162.
@functools.lru_cache(maxsize=4)
def _bicubic_taps(in_t: int, out_t: int):
    """(idx [out_t, 4] int32, w [out_t, 4] f32): the <=4 nonzero columns of
    each _bicubic_time_matrix row (edge-clamped taps merged, zero-padded)."""
    m = _bicubic_time_matrix(in_t, out_t)
    idx = np.zeros((out_t, 4), np.int32)
    w = np.zeros((out_t, 4), np.float32)
    for j in range(out_t):
        nz = np.nonzero(m[j])[0]
        idx[j, : len(nz)] = nz
        w[j, : len(nz)] = m[j, nz]
    return idx, w


# Copied from frechet_audio_distance_exported_tpu/models/clap.py:165-172.
@functools.lru_cache(maxsize=8)
def _relative_position_index(ws: int) -> np.ndarray:
    """[N, N] index into the (2*ws-1)^2 relative position bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


# Copied from frechet_audio_distance_exported_tpu/models/clap.py:175-187.
@functools.lru_cache(maxsize=8)
def _shift_attn_mask(res: int, ws: int, shift: int) -> np.ndarray:
    """[num_windows, N, N] additive mask for shifted-window attention."""
    img = np.zeros((res, res), dtype=np.int32)
    cnt = 0
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for hs in slices:
        for wsl in slices:
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(res // ws, ws, res // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Building blocks, named like the JAX parameter tree
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5):
    """One-pass LayerNorm over the last axis, in float32, returning x.dtype
    (JAX models/common.py:132-148)."""
    xf = x.to(torch.float32)
    n = x.shape[-1]
    mean = xf.sum(dim=-1, keepdim=True) / n
    var = torch.clamp_min((xf * xf).sum(dim=-1, keepdim=True) / n - mean * mean, 0.0)
    out = (xf - mean) * torch.rsqrt(var + eps) * gamma.to(torch.float32) + beta.to(torch.float32)
    return out.to(x.dtype)


def _param(*shape) -> nn.Parameter:
    # Uninitialised: every parameter comes from a state_dict (a bundle, or
    # utils.weights.init_random_params).
    return nn.Parameter(torch.empty(shape), requires_grad=False)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = _param(dim)
        self.beta = _param(dim)

    def forward(self, x):
        return layer_norm(x, self.gamma, self.beta)


class Dense(nn.Module):
    """x @ w (+ b) with w [in, out], as JAX common.linear: in x.dtype (a
    float32 x takes bf16 weights as float32, as the JAX package promotes)."""

    def __init__(self, din: int, dout: int, bias: bool = True):
        super().__init__()
        self.w = _param(din, dout)
        self.b = _param(dout) if bias else None

    def forward(self, x):
        y = torch.matmul(x, self.w.to(x.dtype))
        return y if self.b is None else y + self.b


class BatchNorm(nn.Module):
    """Inference batch norm over the last axis (JAX common.batch_norm L90-97)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = _param(dim)
        self.beta = _param(dim)
        self.mean = _param(dim)
        self.var = _param(dim)

    def forward(self, x):
        scale = self.gamma * torch.rsqrt(self.var + 1e-5)
        return x * scale + (self.beta - self.mean * scale)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> contiguous [B * nW, ws*ws, C] (JAX models/clap.py:203-208)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """[B * nW, ws*ws, C] -> [B, H, W, C] (JAX models/clap.py:211-215)."""
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


class SwinBlock(nn.Module):
    """Pre-norm (S)W-MSA + MLP over a [B, res*res, C] token grid, in window
    space (JAX _fused_call L244-292): roll by -shift, partition, the window
    kernel, reverse, roll by +shift. The MLP is per token, so running it in
    window space is exact."""

    def __init__(self, dim: int, heads: int, res: int, shift: int):
        super().__init__()
        self.heads, self.res, self.shift = heads, res, shift
        self.num_windows = (res // WINDOW_SIZE) ** 2
        # Whether the width admits the whole block in swin_block_fused;
        # otherwise (or under FAD_TPU_FUSED_BLOCK=0) the attention half runs
        # in window_attention_fused and the MLP here.
        self.fused_block = dim <= FUSED_BLOCK_MAX_DIM
        self.norm1 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim)
        self.rel_bias = _param((2 * WINDOW_SIZE - 1) ** 2, heads)
        self.proj = Dense(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, MLP_RATIO * dim)
        n = WINDOW_SIZE * WINDOW_SIZE
        if shift:
            mask = torch.from_numpy(_shift_attn_mask(res, WINDOW_SIZE, shift))
        else:
            mask = torch.from_numpy(np.zeros((1, n, n), np.float32))
        # Constants of the layer, kept beside the weights (not in the
        # state_dict): the shift mask, and the [H, N, N] bias gathered from
        # rel_bias once each time a state_dict is loaded.
        self.register_buffer("attn_mask", mask, persistent=False)
        self.register_buffer("attn_bias", self._gathered_bias(), persistent=False)
        self.register_load_state_dict_post_hook(SwinBlock._after_load)

    def _gathered_bias(self) -> torch.Tensor:
        """[(2ws-1)^2, H] table -> [H, N, N] (JAX _gathered_rel_bias L195-200)."""
        n = WINDOW_SIZE * WINDOW_SIZE
        table = self.rel_bias.detach()
        index = torch.from_numpy(_relative_position_index(WINDOW_SIZE).reshape(-1)).long()
        bias = table[index.to(table.device)].reshape(n, n, self.heads)
        return bias.permute(2, 0, 1).contiguous()

    @staticmethod
    def _after_load(module: "SwinBlock", incompatible_keys) -> None:
        module.attn_bias = module._gathered_bias()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        res, shift = self.res, self.shift
        whole_block = self.fused_block and config.fused_block()
        h = x.reshape(b, res, res, c)
        if shift:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        windows = _window_partition(h, WINDOW_SIZE)
        attention = (
            windows, self.qkv.w, self.qkv.b, self.proj.w, self.proj.b, self.attn_bias,
            self.attn_mask, self.norm1.gamma, self.norm1.beta,
        )
        if whole_block:
            out = swin_block_fused(
                *attention, self.norm2.gamma, self.norm2.beta, self.mlp.fc1.w, self.mlp.fc1.b,
                self.mlp.fc2.w, self.mlp.fc2.b, heads=self.heads, num_windows=self.num_windows,
            )
        else:
            out = window_attention_fused(*attention, heads=self.heads, num_windows=self.num_windows)
        h = _window_reverse(out, WINDOW_SIZE, res, res)
        if shift:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = h.reshape(b, l, c)
        if not whole_block:
            x = x + self.mlp(self.norm2(x))
        return x


class PatchMerging(nn.Module):
    """[B, res*res, C] -> [B, (res/2)^2, 2C] (JAX models/clap.py:334-343)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, res: int) -> torch.Tensor:
        b, _, c = x.shape
        x = x.reshape(b, res, res, c)
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
        )
        x = x.reshape(b, (res // 2) * (res // 2), 4 * c)
        return self.reduction(self.norm(x))


class Stage(nn.Module):
    def __init__(self, i: int):
        super().__init__()
        dim, res, heads = STAGE_DIMS[i], STAGE_RES[i], NUM_HEADS[i]
        self.res = res
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, res,
                      0 if (j % 2 == 0 or res <= WINDOW_SIZE) else WINDOW_SIZE // 2)
            for j in range(DEPTHS[i])
        )
        self.downsample = PatchMerging(dim) if i < len(DEPTHS) - 1 else None

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        if self.downsample is not None:
            x = self.downsample(x, self.res)
        return x


class PatchEmbed(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Module()
        self.conv.w = _param(EMBED_DIM, 1, PATCH_SIZE, PATCH_SIZE)  # OIHW
        self.conv.b = _param(EMBED_DIM)
        self.norm = LayerNorm(EMBED_DIM)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """[B, 256, 256] -> [B, 4096, 96] tokens in row-major (h, w) order."""
        x = F.conv2d(img[:, None], self.conv.w, self.conv.b, stride=PATCH_SIZE)
        return self.norm(x.flatten(2).transpose(1, 2))


class Projection(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = Dense(STAGE_DIMS[-1], EMBEDDING_SIZE)
        self.fc2 = Dense(EMBEDDING_SIZE, EMBEDDING_SIZE)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class CLAP(nn.Module):
    """HTSAT-tiny + projection: [B, 1001, 64] log-mel -> [B, 512] unit vectors."""

    def __init__(self):
        super().__init__()
        idx, w = _bicubic_taps(TIME_FRAMES, TARGET_T)
        self.register_buffer("interp_idx", torch.from_numpy(idx.astype(np.int64)), persistent=False)
        self.register_buffer("interp_w", torch.from_numpy(w.copy()), persistent=False)
        self.bn0 = BatchNorm(MEL_BINS)
        self.patch_embed = PatchEmbed()
        self.stages = nn.ModuleList(Stage(i) for i in range(len(DEPTHS)))
        self.norm = LayerNorm(STAGE_DIMS[-1])
        self.projection = Projection()

    def forward(self, log_mel: torch.Tensor) -> torch.Tensor:
        if log_mel.dim() != 3 or tuple(log_mel.shape[1:]) != (TIME_FRAMES, MEL_BINS):
            raise ValueError(
                f"expected [B, {TIME_FRAMES}, {MEL_BINS}] log-mel, got {tuple(log_mel.shape)}"
            )
        b = log_mel.shape[0]
        x = None
        for k in range(4):
            taps = log_mel.index_select(1, self.interp_idx[:, k])
            term = self.interp_w[:, k][None, :, None] * taps
            x = term if x is None else x + term
        x = self.bn0(x).to(self.patch_embed.conv.w.dtype)
        x = x.reshape(b, FREQ_RATIO, TARGET_T // FREQ_RATIO, MEL_BINS).transpose(2, 3)
        x = self.patch_embed(x.reshape(b, SPEC_SIZE, SPEC_SIZE))
        for stage in self.stages:
            x = stage(x)
        emb = self.norm(x).to(torch.float32).mean(dim=1)
        emb = self.projection(emb)
        return emb / torch.clamp_min(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), 1e-12)
