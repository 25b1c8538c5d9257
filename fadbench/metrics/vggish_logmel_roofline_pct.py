"""The VGGish log-mel kernel's share of its roofline: the least time the
card could take over the device time torch.profiler gives the kernel.

The least time is the larger of the FLOPs over the TF32 peak and the bytes
over the HBM bandwidth; the bytes bound it. Per clip of S samples with P
complete patches (T = 96 P frames), the algorithm reads each needed sample
once, (T - 1) * hop + window float32 samples, and writes each output once,
T * 64 float32 log-mel values. An FFT log-mel's FLOPs (a real 512-point FFT
a frame, the magnitude, 461 mel taps, the log) are counted for the check
that they do not bound it.
"""

import math

from fadbench import peaks

KERNELS = ("vggish_logmel_kernel",)


def clip_work(cfg, samples):
    win, hop, n_fft = cfg["stft_window_samples"], cfg["stft_hop_samples"], cfg["fft_length"]
    frames = 0 if samples < win else 1 + (samples - win) // hop
    t = frames // cfg["patch_frames"] * cfg["patch_frames"]
    if t == 0:
        return 0, 0
    nbin = n_fft // 2 + 1
    flops_frame = 2.5 * n_fft * math.log2(n_fft) + 3 * nbin + 2 * 461 + cfg["mel_bands"]
    return t * flops_frame, 4 * ((t - 1) * hop + win) + 4 * t * cfg["mel_bands"]


def read(run):
    if run.trace is None or not run.clips:
        return None
    measured = run.trace.kernel_time(KERNELS)
    if measured <= 0:
        return None
    f, b = clip_work(run.cell.config, run.clip_samples)
    flops, nbytes = run.clips * f, run.clips * b
    least = max(flops / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
    return 100.0 * least / measured
