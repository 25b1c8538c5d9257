"""PANN CNN14 embedding network as a torch module.

Port of frechet_audio_distance_exported_tpu/models/pann.py (L32-89), with
the building blocks of its models/common.py in torch idiom: a 3x3 SAME
convolution without bias is nn.Conv2d(padding=1, bias=False) (common.py:29),
the inference batch norm is BatchNorm in eval mode with eps 1e-5
(common.py:90), and the 2x2 average pool is F.avg_pool2d with floor
semantics (common.py:79).

- bn0: a per-mel-bin affine over the 64 bins of the log-mel;
- six ConvBlocks (conv, BN, ReLU, conv, BN, ReLU); blocks 1-5 average-pool
  2x2, block 6 does not pool;
- the pooling tail: mean over frequency, then max plus mean over time;
- fc1 followed by ReLU.

The same weights serve all three sample-rate variants; only the frontend
differs. In a bf16 model (pipeline.cast_model) the convolutions, batch norms
and fc1 take bf16 and return bf16 with float32 sums inside, and the pooling
tail runs in float32 (JAX L82-89).

Input:  [B, T, 64] log-mel (T on the 32k-24 grid, zero rows included: they
        are part of the reference numerics, see frontends.pann_valid_time)
Output: [B, 2048] embeddings
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

EMBEDDING_SIZE = 2048
MEL_BINS = 64

# (in_channels, out_channels) per ConvBlock (JAX models/pann.py:32).
BLOCK_CHANNELS = ((1, 64), (64, 128), (128, 256), (256, 512), (512, 1024), (1024, 2048))


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, kernel_size=3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout, eps=1e-5)
        self.conv2 = nn.Conv2d(cout, cout, kernel_size=3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor, pool: bool) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        if pool:
            x = F.avg_pool2d(x, kernel_size=2, stride=2)
        return x


class PANN(nn.Module):
    """CNN14. ``block_channels`` defaults to the published widths; a narrower
    plan (same length, chained in/out, last width = the embedding size) lets
    tests run a small CNN14."""

    def __init__(self, block_channels: Sequence[Tuple[int, int]] = BLOCK_CHANNELS):
        super().__init__()
        if len(block_channels) != len(BLOCK_CHANNELS):
            raise ValueError(f"CNN14 has {len(BLOCK_CHANNELS)} blocks, got {len(block_channels)}")
        self.bn0 = nn.BatchNorm1d(MEL_BINS, eps=1e-5)
        self.blocks = nn.ModuleList(ConvBlock(cin, cout) for cin, cout in block_channels)
        width = block_channels[-1][1]
        self.fc1 = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 3 or x.shape[-1] != MEL_BINS:
            raise ValueError(f"expected [B, T, {MEL_BINS}] log-mel, got {tuple(x.shape)}")
        # bn0 over the mel bins: BatchNorm1d on [B, 64, T] is the reference's
        # transpose sandwich, a per-bin affine.
        h = self.bn0(x.transpose(1, 2)).transpose(1, 2)
        h = h.unsqueeze(1)  # [B, 1, T, 64] NCHW
        last = len(self.blocks) - 1
        for i, block in enumerate(self.blocks):
            h = block(h, pool=i != last)
        # [B, C, T/32, 2]: mean over frequency, then max + mean over time
        # (JAX models/pann.py:85-87, axes 2 and 1 of NHWC), in float32 in any
        # compute dtype: the time mean runs over up to some 8k pooled frames.
        h = h.to(torch.float32).mean(dim=3)
        h = (h.amax(dim=2) + h.mean(dim=2)).to(x.dtype)
        return F.relu(self.fc1(h))
