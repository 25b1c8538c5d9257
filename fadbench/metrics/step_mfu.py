"""The whole step's share of the card's peak: the model FLOPs of the clips
the traced window embedded (the configuration's counter under
fadbench/counts/, from its published shapes) over the window's wall time
and the H100's dense TF32 rate, the highest any float32-input product
reaches on the card."""

from fadbench import peaks


def read(run):
    if run.trace is None or run.window_s <= 0 or not run.clips:
        return None
    flops = run.clips * run.cell.counter().model_flops_per_clip(run.cell.config, run.clip_samples)
    return 100.0 * flops / run.window_s / peaks.TF32_FLOPS
