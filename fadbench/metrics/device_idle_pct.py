"""100 minus the device's busy share of the traced window: busy is the
union of every CUDA kernel, copy and set interval in torch.profiler's
trace (fadbench/devtrace.py)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
