"""Runs one cell of the benchmark once.

    python3 fadbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json and the port,
frechet_audio_distance_exported_tpu_torch, on a machine with a CUDA card.
It prints the run's notes and, as its last lines on standard error, each
number compared with the plain reference beside its limit; its last line
on standard output is one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics, or with --trace 1 its per-layer ones),
device, breakdown (--trace 1), card, launches and, last, checks.

The port's nvcc and g++ builds go to fadbench/.cache/build in the checkout
(and any torch extension or Triton cache beside it), so only the first run
there builds. It exits non-zero with no result where
there is no CUDA card, where the cell asks for more cards than there are,
or where the process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "frechet_audio_distance_exported_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    cache = ROOT / "fadbench" / ".cache"
    os.environ["FAD_TPU_TORCH_BUILD_DIR"] = str(cache / "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))

    import torch

    from fadbench import harness, spec

    chips = spec.load_cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fadbench: the cell needs {chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"fadbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    checks = result["checks"]
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
