"""Plain VGGish of the benchmark's reference: int16 PCM -> log-mel patches ->
the VGG network -> 128-d rows, in float32 torch.

Frozen from frechet_audio_distance_exported_tpu_torch/models/vggish.py (the
network, with its parameter names, so one state_dict serves both sides)
and ops/frontends.py (patching). Every size comes from the configuration
file (fadbench/configs/vggish.json).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from . import dsp


class VGGish(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        convs, cin = [], 1
        for v in cfg["conv_channels"]:
            if v != "M":
                convs.append(nn.Conv2d(cin, v, kernel_size=3, padding=1))
                cin = v
        self.features = nn.ModuleList(convs)
        pools = sum(v == "M" for v in cfg["conv_channels"])
        flat = cin * (cfg["patch_frames"] >> pools) * (cfg["mel_bands"] >> pools)
        dims = [flat] + list(cfg["fc_dims"])
        self.embeddings = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        """[N, frames, bands] -> [N, d]."""
        h = patches[:, None]
        convs = iter(self.features)
        for v in self.cfg["conv_channels"]:
            h = F.max_pool2d(h, 2, 2) if v == "M" else F.relu(next(convs)(h))
        # Channel-last flatten, the order of the released TF weights.
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        for i, fc in enumerate(self.embeddings):
            h = fc(h)
            if i < len(self.embeddings) - 1:
                h = F.relu(h)
        return h


def build(cfg: dict, device) -> VGGish:
    with torch.device(device):
        return VGGish(cfg).eval()


def init_state(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Weights and biases uniform in +-1/sqrt(fan_in), drawn in one call."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in VGGish(cfg).state_dict().items()}
    total = sum(torch.Size(s).numel() for s in shapes.values())
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    state, at = {}, 0
    for key, shape in shapes.items():
        n = torch.Size(shape).numel()
        module = key.rsplit(".", 1)[0]
        w_shape = shapes[f"{module}.weight"]
        fan_in = torch.Size(w_shape[1:]).numel()
        state[key] = flat[at : at + n].view(shape) * fan_in ** -0.5
        at += n
    return state


def rows_per_clip(cfg: dict, samples: int) -> int:
    """Complete patches of the uncentred STFT (the incomplete tail dropped)."""
    win, hop = cfg["stft_window_samples"], cfg["stft_hop_samples"]
    frames = 0 if samples < win else 1 + (samples - win) // hop
    return frames // cfg["patch_frames"]


def embed(model: VGGish, pcm: torch.Tensor) -> torch.Tensor:
    """int16 [B, S] -> [B, P, d] float32 rows (PCM16 decodes to k / 32768)."""
    cfg = model.cfg
    p = rows_per_clip(cfg, pcm.shape[-1])
    wave = pcm.to(torch.float32) / 32768.0
    mel = dsp.vggish_logmel(wave, p * cfg["patch_frames"], cfg)
    patches = mel.reshape(-1, cfg["patch_frames"], cfg["mel_bands"])
    return model(patches).reshape(pcm.shape[0], p, -1)
