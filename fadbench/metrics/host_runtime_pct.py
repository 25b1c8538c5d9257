"""Share of the window's calls' wall time spent outside the
embed_files[<family>] stage of the pipeline's StageTimer: listing the
directories, waiting on the decode pool, finalising the statistics and the
epilogue. The stage is timed on the host clock without a synchronise, so
it holds the host's side of each chunk's device work."""


def read(run):
    calls = run.completed
    wall = sum(c["wall_s"] for c in calls)
    if not calls or wall <= 0:
        return None
    return 100.0 * (wall - sum(c["embed_s"] for c in calls)) / wall
