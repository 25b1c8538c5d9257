"""Device milliseconds of WavLM's attention per clip embedded: the device time
torch.profiler gives the attention's kernels in the window, over the clips
its completed calls embedded.

The names come from a trace of one layer's attention alone on an H100 (B =
64, T = 499, TF32 off): cuBLAS's float32 GEMMs for the scores q k^T
(sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_*) and the weighted sum p v
(sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_*), ATen's addcmul that adds the gated
bias, and the softmax (softmax_warp_forward; cunn_SoftMaxForward past 1024
keys); ``wavlm_attention`` holds a later hand kernel. In WavLM's step nothing
else runs these: the products run the hand GEMM, the convolutions cuDNN, and
the streamed statistics' product CUTLASS's simt_sgemm. A card test
(fadbench/tests/test_fadbench_wavlm.py) holds that: a step of the cell's
shape launches each of these names 48 times as often as one layer's
attention alone (two forwards of 24 layers), and no other. Left out, as their
names are shared: the copies that split q, k and v by head and gather the
heads' outputs (ATen's direct_copy_kernel, which the front end's transposes
also run; about 0.47 ms a layer at B = 64) and the gate's sum, sigmoid and
arithmetic (about 0.05 ms a layer)."""

KERNELS = ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n",
           "addcmul", "softmax_warp_forward", "SoftMaxForward", "wavlm_attention")


def read(run):
    if run.trace is None or not run.clips:
        return None
    measured = run.trace.kernel_time(KERNELS)
    if measured <= 0:
        return None
    return 1000.0 * measured / run.clips
