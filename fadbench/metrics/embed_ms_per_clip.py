"""Milliseconds of the embed_files[<family>] stage (host preparation, the
copies and the device steps as the host sees them) per clip embedded in
the window."""


def read(run):
    calls = run.completed
    clips = sum(c["clips"] for c in calls)
    if not clips:
        return None
    return 1000.0 * sum(c["embed_s"] for c in calls) / clips
