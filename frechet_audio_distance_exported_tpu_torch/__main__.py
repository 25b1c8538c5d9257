"""Command-line interface: compute FAD between two directories.

The counterpart of frechet_audio_distance_exported_tpu/__main__.py, with
``--device`` (the constructor's own extension):

    python -m frechet_audio_distance_exported_tpu_torch BG_DIR EVAL_DIR \\
        --model vggish [--ckpt-dir DIR] [--device-stats] [--verbose]

``--mesh`` shards the files over a process group, one process per card:

    torchrun --nproc-per-node N -m frechet_audio_distance_exported_tpu_torch \\
        BG_DIR EVAL_DIR --mesh [--device-stats] [--device cpu]

Only rank 0 prints the result. The exit code is 0, or 1 on the -1 sentinel.
With FAD_TPU_TRACE=<dir>, the scoring runs under utils.profiling.trace(),
which writes a Chrome trace of it, with the spans of score(), into <dir>.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import FrechetAudioDistance, registry
from .utils import profiling


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="frechet_audio_distance_exported_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("background_dir", help="directory of background audio files")
    ap.add_argument("eval_dir", help="directory of evaluation audio files")
    ap.add_argument("--model", default="vggish", choices=sorted(registry.VALID_MODELS))
    ap.add_argument("--ckpt-dir", default=None, help="weight bundle directory")
    ap.add_argument("--weights", default="auto", choices=["auto", "random"])
    ap.add_argument("--background-embds-path", default=None)
    ap.add_argument("--eval-embds-path", default=None)
    ap.add_argument("--device-stats", action="store_true",
                    help="stream statistics on device (no host embedding matrix)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the files over a process group, one process per card "
                         "(from torchrun's environment); with --device-stats the ranks "
                         "merge their streamed statistics")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the models run (default cuda; cpu runs the plain path)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--json", action="store_true", help="print a JSON record")
    args = ap.parse_args(argv)

    mesh, own_group = None, False
    if args.mesh:
        import torch.distributed as dist

        from .parallel.mesh import data_mesh, initialize_distributed

        if not dist.is_initialized():
            initialize_distributed(device=args.device)
            own_group = True
        mesh = data_mesh(device=args.device)
    try:
        fad = FrechetAudioDistance(
            ckpt_dir=args.ckpt_dir,
            model_name=args.model,
            verbose=args.verbose,
            weights=args.weights,
            device=args.device,
            mesh=mesh,
        )
        with profiling.trace():
            score = fad.score(
                args.background_dir,
                args.eval_dir,
                background_embds_path=args.background_embds_path,
                eval_embds_path=args.eval_embds_path,
                device_stats=args.device_stats,
            )
    finally:
        if own_group:
            dist.destroy_process_group()
    if mesh is None or mesh.rank == 0:
        if args.json:
            print(json.dumps({"model": args.model, "fad": score}))
        else:
            print(f"FAD ({args.model}): {score}")
    return 0 if score != -1 else 1


if __name__ == "__main__":
    sys.exit(main())
