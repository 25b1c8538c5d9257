"""The float32 Swin window kernels' share of their roofline: the least
time the card could take over the device time torch.profiler gives every
kernel that swin_block_fused and window_attention_fused launch (the
weights' 3xTF32 split, the LayerNorm statistics, the token-tile GEMMs and
the window attention).

The least time is the larger of the FLOPs over the TF32 peak (the highest
rate of any float32-input product; the kernels run 3xTF32 at a third of
it) and the bytes over the HBM bandwidth; the FLOPs bound it. The FLOPs
are the products of every Swin layer of the clips the window embedded:
whole blocks (qkv, scores, weighted sum, proj, fc1, fc2) at the widths
that swin_block_fused takes, the attention half (qkv, scores, weighted
sum, proj) of the wider stages, whose MLP runs outside these kernels.
The bytes are each layer's tokens read once and written once, in float32,
for every clip, and each layer's weights read once in the window.
"""

from fadbench import peaks

KERNELS = ("split_weights_kernel", "row_stats_kernel", "gemm_tf32_kernel",
           "attention_from_qkv_kernel")
# The widest stage whose whole block runs in swin_block_fused (the port's
# ops/window_attn.KERNEL_BLOCK_WIDTHS); wider stages run only their
# attention half in window_attention_fused.
BLOCK_MAX_WIDTH = 384


def work(cfg):
    """(FLOPs of one clip, activation bytes of one clip, weight bytes)."""
    from fadbench.counts.clap import block_flops, stages

    flops = act = weights = 0
    for _, tokens, c, depth in stages(cfg):
        parts = block_flops(tokens, c, cfg["window_size"] ** 2, cfg["mlp_ratio"])
        # qkv, proj and the two norms; fc1 and fc2 with the whole block.
        w = 3 * c * c + 3 * c + c * c + c + 4 * c
        if c > BLOCK_MAX_WIDTH:
            parts = {k: v for k, v in parts.items() if k not in ("fc1", "fc2")}
        else:
            w += 2 * cfg["mlp_ratio"] * c * c + cfg["mlp_ratio"] * c + c
        flops += depth * sum(parts.values())
        act += depth * 2 * 4 * tokens * c
        weights += depth * 4 * w
    return flops, act, weights


def read(run):
    if run.trace is None or not run.clips:
        return None
    measured = run.trace.kernel_time(KERNELS)
    if measured <= 0:
        return None
    flops, act, weights = work(run.cell.config)
    clips = run.clips
    least = max(flops * clips / peaks.TF32_FLOPS,
                (act * clips + weights) / peaks.HBM_BYTES_PER_S)
    return 100.0 * least / measured
