"""Device milliseconds of Encodec's GroupNorm(1, C) per clip embedded: the
device time torch.profiler gives every kernel of the 18 norms (ATen's
moments, its fused scale and shift, and the elementwise pass named after
GroupNormKernelImplInternal; ``group_norm`` for a later hand kernel) in the
window, over the clips its completed calls embedded."""

KERNELS = ("GroupNorm", "RowwiseMoments", "ComputeFusedParams", "group_norm")


def read(run):
    if run.trace is None or not run.clips:
        return None
    measured = run.trace.kernel_time(KERNELS)
    if measured <= 0:
        return None
    return 1000.0 * measured / run.clips
