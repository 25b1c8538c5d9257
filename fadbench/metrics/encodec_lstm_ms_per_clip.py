"""Device milliseconds of Encodec's 2-layer LSTM per clip embedded: the
device time torch.profiler gives the LSTM's kernels in the window, over the
clips its completed calls embedded.

The names come from a trace of the port's model.lstm alone on an H100
(B = 64, T = 1500): cuDNN's cell (elemWiseRNNcell, 3000 launches a chunk;
``RNN`` and ``LSTM`` also hold cuDNN's persistent kernels) and cuBLAS's
float32 GEMMs sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_* (the 3000 recurrent
products and the input products). In Encodec's step only the LSTM calls
cuBLAS: the convolutions run cuDNN's fprop_implicit_gemm and
implicit_convolve_sgemm kernels, the statistics CUTLASS's simt_sgemm.
``lstm`` holds a later hand kernel."""

KERNELS = ("RNN", "LSTM", "lstm", "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n")


def read(run):
    if run.trace is None or not run.clips:
        return None
    measured = run.trace.kernel_time(KERNELS)
    if measured <= 0:
        return None
    return 1000.0 * measured / run.clips
