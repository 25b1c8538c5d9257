"""FLOPs of CLAP's audio branch (HTSAT-tiny and the projection), counted
from the configuration's shapes.

A multiply-add counts 2. Per Swin block over T tokens of width C in
windows of N = ws^2 tokens: qkv 2*T*C*3C, the scores q k^T and the
weighted sum p v 2*T*N*C each, proj 2*T*C*C, the MLP 2*T*C*rC twice; the
patch embedding is a p x p stride-p convolution to the first width; a
patch merging maps 4C to 2C at a quarter of the tokens. Norms, softmax,
GELU, the interpolation and biases are left out. Every clip is cut or
padded to the same 10 s input, so the count does not depend on its length.
"""

from __future__ import annotations

from typing import List, Tuple


def block_flops(tokens: int, c: int, window_tokens: int, mlp_ratio: int) -> dict:
    """One Swin block's products, by part."""
    return {
        "qkv": 2 * tokens * c * 3 * c,
        "scores": 2 * tokens * window_tokens * c,
        "weighted_sum": 2 * tokens * window_tokens * c,
        "proj": 2 * tokens * c * c,
        "fc1": 2 * tokens * c * mlp_ratio * c,
        "fc2": 2 * tokens * mlp_ratio * c * c,
    }


def stages(cfg: dict):
    """[(stage index, tokens, width, depth)]."""
    res = cfg["spec_size"] // cfg["patch_size"]
    return [
        (i, (res >> i) ** 2, cfg["embed_dim"] * 2 ** i, depth)
        for i, depth in enumerate(cfg["depths"])
    ]


def layers(cfg: dict) -> List[Tuple[str, int]]:
    """[(layer, FLOPs of one clip)] in network order."""
    p = cfg["patch_size"]
    n = cfg["window_size"] ** 2
    first = stages(cfg)[0]
    out = [("patch_embed", 2 * p * p * first[2] * first[1])]
    for i, tokens, c, depth in stages(cfg):
        block = sum(block_flops(tokens, c, n, cfg["mlp_ratio"]).values())
        out.append((f"stage{i + 1}_blocks", depth * block))
        if i < len(cfg["depths"]) - 1:
            out.append((f"merge{i + 1}", 2 * (tokens // 4) * 4 * c * 2 * c))
    width = stages(cfg)[-1][2]
    a, b = cfg["projection_dims"]
    out.append(("projection", 2 * width * a + 2 * a * b))
    return out


def model_flops_per_clip(cfg: dict, samples: int) -> int:
    return sum(f for _, f in layers(cfg))
