"""Device seconds per hour of audio scored: the union of every CUDA kernel,
copy and set interval in the window's device trace (fadbench/devtrace.py),
over the hours of audio of every clip of every completed call. The card
time a score costs, whatever the host does around it: all the device work
of the window, a failed call's included, and none of its idle time."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.clips:
        return None
    hours = run.clips * run.clip_samples / run.cell.traffic["sample_rate"] / 3600.0
    return run.trace.busy_s / hours
