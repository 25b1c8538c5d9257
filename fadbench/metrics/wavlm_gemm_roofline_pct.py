"""WavLM's GEMM path's share of its roofline: the least time the card could
take over the device time torch.profiler gives every kernel of the path in
the window (the weights' 3xTF32 split, the LayerNorm statistics and the
token-tile GEMM of ops/window_attn.gemm_tf32; in WavLM's step nothing else
launches them).

The least time is the larger of the FLOPs over the TF32 peak (the highest
rate of any float32-input product; the kernel runs 3xTF32 at a third of it)
and the bytes over the HBM bandwidth; the FLOPs bound it. FLOPs and bytes
are fadbench/counts/wavlm.gemm_work's: the feature projection and each
layer's qkv with the gate, proj, fc1 and fc2 of every clip the window
embedded (the gate's useful products only, not its 120 block-diagonal zero
columns), each product's rows read and written once in float32, and each
layer's weights read once in the window.
"""

from fadbench import peaks

KERNELS = ("split_weights_kernel", "row_stats_kernel", "gemm_tf32_kernel")


def read(run):
    if run.trace is None or not run.clips:
        return None
    measured = run.trace.kernel_time(KERNELS)
    if measured <= 0:
        return None
    flops, act, weights = run.cell.counter().gemm_work(run.cell.config, run.clip_samples)
    least = max(flops * run.clips / peaks.TF32_FLOPS,
                (act * run.clips + weights) / peaks.HBM_BYTES_PER_S)
    return 100.0 * least / measured
