"""VGGish embedding network as a torch module.

Port of frechet_audio_distance_exported_tpu/models/vggish.py (L29-86): a VGG
stack [64, M, 128, M, 256, 256, M, 512, 512, M] of 3x3 convolutions with
padding 1 (equal to SAME at stride 1) + ReLU and 2x2/2 max pools, a
channel-last flatten, then FC 12288 -> 4096 -> ReLU -> 4096 -> ReLU -> 128
with no final ReLU.

In a bf16 model (pipeline.cast_model) every convolution and linear layer
takes bf16 and returns bf16 with float32 sums inside, as JAX common.conv2d
and common.linear do (L29-66, L151-154); the bias is added before the one
rounding, where JAX rounds the product and then adds it (a bf16 ulp apart
at most; tests/test_torch_precision.py measures it).

Input:  [B, 96, 64] log-mel patches (ops.frontends.vggish_patches_batch)
Output: [B, 128] embeddings
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

EMBEDDING_SIZE = 128
NUM_FRAMES = 96
NUM_BANDS = 64

# Conv channel plan; 'M' is a 2x2/2 max pool.
CONV_CFG = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M")
FC_DIMS = ((512 * 6 * 4, 4096), (4096, 4096), (4096, EMBEDDING_SIZE))


class VGGish(nn.Module):
    def __init__(self):
        super().__init__()
        convs = []
        cin = 1
        for v in CONV_CFG:
            if v != "M":
                convs.append(nn.Conv2d(cin, v, kernel_size=3, padding=1))
                cin = v
        self.features = nn.ModuleList(convs)
        self.embeddings = nn.ModuleList(nn.Linear(din, dout) for din, dout in FC_DIMS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # A transposed [B, 64, 96] input pools to the same 12288 features and
        # returns plausible garbage, so it must fail here (ValueError, not
        # assert: python -O must not strip the guard).
        if tuple(x.shape[-2:]) != (NUM_FRAMES, NUM_BANDS):
            raise ValueError(f"expected [..., 96, 64] patches, got {tuple(x.shape)}")
        h = x.reshape(-1, 1, NUM_FRAMES, NUM_BANDS)  # NCHW
        convs = iter(self.features)
        for v in CONV_CFG:
            if v == "M":
                h = F.max_pool2d(h, kernel_size=2, stride=2)
            else:
                h = F.relu(next(convs)(h))
        # [B, 512, 6, 4] -> NHWC flatten: the order the TF-VGGish weights
        # (and the JAX package's NHWC layout) expect.
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        fc1, fc2, fc3 = self.embeddings
        h = F.relu(fc1(h))
        h = F.relu(fc2(h))
        return fc3(h)
