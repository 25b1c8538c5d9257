"""FLOPs of VGGish's network, counted from the configuration's shapes.

A multiply-add counts 2. Convolutions are 3x3 with padding 1 at stride 1
(every output position of every channel: 2 * 9 * c_in per output), 2x2
pools halve both axes, and the fully connected layers take the
channel-last flatten. Pools, ReLUs and biases are left out: the sum is the
products' work, which is what a peak rate bounds.
"""

from __future__ import annotations

from typing import List, Tuple


def layers(cfg: dict) -> List[Tuple[str, int]]:
    """[(layer, FLOPs of one 96 x 64 patch)] in network order."""
    h, w, cin = cfg["patch_frames"], cfg["mel_bands"], 1
    out, conv = [], 0
    for v in cfg["conv_channels"]:
        if v == "M":
            h, w = h // 2, w // 2
            continue
        out.append((f"conv{conv + 1}", 2 * 9 * cin * v * h * w))
        cin, conv = v, conv + 1
    dims = [cin * h * w] + list(cfg["fc_dims"])
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out.append((f"fc{i + 1}", 2 * a * b))
    return out


def rows_per_clip(cfg: dict, samples: int) -> int:
    win, hop = cfg["stft_window_samples"], cfg["stft_hop_samples"]
    frames = 0 if samples < win else 1 + (samples - win) // hop
    return frames // cfg["patch_frames"]


def model_flops_per_clip(cfg: dict, samples: int) -> int:
    """The network's FLOPs for one clip of ``samples`` at the model's rate:
    one pass a complete 0.96 s patch."""
    return rows_per_clip(cfg, samples) * sum(f for _, f in layers(cfg))
