"""Audio scored per second: the minutes of audio of every clip of every
completed call, over the time from the window's start to the end of its
last call (all the work and all the time of the window, not a median of
calls). A failed call adds its time and none of its audio."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.clips * run.clip_samples / run.cell.traffic["sample_rate"] / 60.0 / run.window_s
