"""FLOPs of WavLM-Large's encoder, counted from the configuration's shapes.

A multiply-add counts 2. A convolution of kernel k and stride s from c_in
to c_out channels writes floor((T - k) / s) + 1 frames, each 2 * k * c_in *
c_out (over c_in / groups for the grouped positional convolution, which
writes T + 1 frames and keeps T). Per transformer layer over T frames of
width C with H heads of D: qkv 2 T C 3C, the scores q k^T and the weighted
sum p v 2 T T C each, proj 2 T C C, fc1 and fc2 2 T C F each, the gate's
Linear(D, 8) 2 T H D 8. LayerNorms, GELU, softmax, the biases and the gated
bias are left out: the sum is the products' work, which is what a peak rate
bounds. The count follows a clip's length (every clip of a traffic has one).
"""

from __future__ import annotations

from typing import List, Tuple


def frames(cfg: dict, samples: int) -> List[int]:
    """Frames after each convolution of the feature extractor."""
    out, t = [], samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        t = (t - k) // s + 1 if t >= k else 0
        out.append(t)
    return out


def layer_flops(cfg: dict, t: int) -> dict:
    """One transformer layer's products over t frames, by part."""
    c, f = cfg["hidden_size"], cfg["intermediate_size"]
    heads = cfg["num_attention_heads"]
    return {
        "qkv": 2 * t * c * 3 * c,
        "gate": 2 * t * heads * (c // heads) * cfg["gru_rel_pos_linear_out"],
        "scores": 2 * t * t * c,
        "weighted_sum": 2 * t * t * c,
        "proj": 2 * t * c * c,
        "fc1": 2 * t * c * f,
        "fc2": 2 * t * f * c,
    }


def layers(cfg: dict, samples: int) -> List[Tuple[str, int]]:
    """[(layer, FLOPs of one clip of ``samples``)] in network order."""
    ts = frames(cfg, samples)
    cins = [1] + cfg["conv_dim"][:-1]
    out = [(f"conv{i}", 2 * k * cin * cout * t) for i, (cin, cout, k, t) in
           enumerate(zip(cins, cfg["conv_dim"], cfg["conv_kernel"], ts))]
    t, c = ts[-1], cfg["hidden_size"]
    out.append(("projection", 2 * t * cfg["conv_dim"][-1] * c))
    out.append(("pos_conv", 2 * cfg["num_conv_pos_embeddings"]
                * (c // cfg["num_conv_pos_embedding_groups"]) * c * t))
    layer = sum(layer_flops(cfg, t).values())
    out += [(f"layer{i}", layer) for i in range(cfg["num_hidden_layers"])]
    return out


def gemm_work(cfg: dict, samples: int) -> Tuple[int, int, int]:
    """The GEMM path's (FLOPs of one clip, activation bytes of one clip,
    weight bytes): the feature projection and each layer's qkv with the
    gate, proj, fc1 and fc2. Bytes count each product's input and output
    rows once in float32 (and the residual, where the epilogue adds one),
    and each weight and bias once."""
    t = frames(cfg, samples)[-1]
    c, f, cin = cfg["hidden_size"], cfg["intermediate_size"], cfg["conv_dim"][-1]
    gate_cols = cfg["num_attention_heads"] * cfg["gru_rel_pos_linear_out"]
    parts = layer_flops(cfg, t)
    flops = 2 * t * cin * c + cfg["num_hidden_layers"] * sum(
        parts[k] for k in ("qkv", "gate", "proj", "fc1", "fc2"))
    # (in, out, residual) widths of each product's rows
    rows = [(c, 3 * c + gate_cols, 0), (c, c, c), (c, f, 0), (f, c, c)]
    act = 4 * t * (cin + c + cfg["num_hidden_layers"] * sum(sum(r) for r in rows))
    weights = 4 * ((cin + 1) * c + cfg["num_hidden_layers"] * (
        (c + 1) * (3 * c + gate_cols) + (c + 1) * c + (c + 1) * f + (f + 1) * c))
    return flops, act, weights


def model_flops_per_clip(cfg: dict, samples: int) -> int:
    return sum(f for _, f in layers(cfg, samples))
