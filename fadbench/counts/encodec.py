"""FLOPs of EnCodec's 48 kHz SEANet encoder, counted from the configuration's
shapes.

A multiply-add counts 2. A convolution of kernel k and stride s from c_in to
c_out channels over T input frames writes ceil(T / s) frames (EnCodec's
padding makes the last window whole), each 2 * k * c_in * c_out. The LSTM
takes 2 * H * 4H for its input and again for its recurrent product, per
layer and frame. GroupNorm, ELU, the skip additions and biases are left
out: the sum is the products' work, which is what a peak rate bounds. The
port zero-pads every clip to 10 s and runs the encoder over all of it, so
the count does not depend on a clip's length.
"""

from __future__ import annotations

from typing import List, Tuple


def _conv(cin: int, cout: int, kernel: int, frames_out: int) -> int:
    return 2 * kernel * cin * cout * frames_out


def layers(cfg: dict) -> List[Tuple[str, int]]:
    """[(layer, FLOPs of one clip)] in network order."""
    t, dim = cfg["clip_max_samples"], cfg["n_filters"]
    out = [("conv_in", _conv(cfg["channels"], dim, cfg["kernel_size"], t))]
    for i, r in enumerate(reversed(cfg["ratios"])):
        hidden = dim // cfg["compress"]
        t_down = -(-t // r)
        out += [
            (f"stage{i + 1}.conv1", _conv(dim, hidden, cfg["residual_kernel_size"], t)),
            (f"stage{i + 1}.conv2", _conv(hidden, dim, 1, t)),
            (f"stage{i + 1}.shortcut", _conv(dim, dim, 1, t)),
            (f"stage{i + 1}.down", _conv(dim, 2 * dim, 2 * r, t_down)),
        ]
        t, dim = t_down, 2 * dim
    out.append(("lstm", cfg["lstm_layers"] * t * 2 * (2 * dim * 4 * dim)))
    out.append(("conv_out", _conv(dim, cfg["dimension"], cfg["last_kernel_size"], t)))
    return out


def model_flops_per_clip(cfg: dict, samples: int) -> int:
    return sum(f for _, f in layers(cfg))
