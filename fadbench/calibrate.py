"""Readings that set a cell's correctness limits (fadbench/limits/<cell>.json).

    python3 fadbench/calibrate.py --workload <cell> --seeds <first>:<count>
        [--controls <count>] [--calls 2] [--out <file.jsonl>]

On a CUDA card, in one process, for each seed: the cell's corpus and the
reference's rows, then ``--calls`` calls of the cell's size (after a
warm-up call) by the program as the configuration states it (float32, TF32
off), and, on the first ``--controls`` seeds, by the program's own
lower-precision paths: TF32 products (FAD_TPU_PRECISION=high) and bf16
models (FAD_TPU_MODEL_DTYPE=bfloat16). Each line of the output holds one
seed and mode with the judge's three numbers (fadbench/judge.py), worst
over its calls. The lower reading of a number is the largest of the
float32 lines; the upper, the smallest of a control's. The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODES = {
    "float32": {},
    "tf32": {"FAD_TPU_PRECISION": "high"},
    "bf16": {"FAD_TPU_MODEL_DTYPE": "bfloat16"},
}


def main() -> int:
    ap = argparse.ArgumentParser(description="Correctness readings of one cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="first:count")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    os.environ["FAD_TPU_TORCH_BUILD_DIR"] = str(ROOT / "fadbench" / ".cache" / "build")
    sys.path.insert(0, str(ROOT))

    import torch

    from fadbench import harness, judge, spec

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda")
    first, count = (int(x) for x in args.seeds.split(":"))
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(range(first, first + count)):
        tmp = tempfile.mkdtemp(prefix="fadbench-")
        try:
            data = harness.make_corpus(cell, seed, dev, tmp)
            t = time.perf_counter()
            rows = judge.reference_rows(cell, data.pools, data.seeds["weights"], dev)
            ref_s = time.perf_counter() - t
            for mode, env in MODES.items():
                if mode != "float32" and i >= args.controls:
                    continue
                saved = {k: os.environ.get(k) for k in env}
                os.environ.update(env)
                try:
                    calc = harness.Calculator(cell, seed, data.seeds["weights"], dev,
                                              str(Path(tmp) / "ckpt"))
                    calc.call(data.dirs[0])
                    calls = harness.window(calc, data, float("inf"), max_calls=args.calls)
                    calc.close(dev)
                finally:
                    for k, v in saved.items():
                        if v is None:
                            os.environ.pop(k, None)
                        else:
                            os.environ[k] = v
                answered = [c for c in calls if not c["failed"]]
                line = {"cell": cell.name, "seed": seed, "mode": mode,
                        "failed": len(calls) - len(answered),
                        "fad": [c["value"] for c in calls],
                        "call_s": [c["wall_s"] for c in calls], "reference_s": ref_s,
                        **judge.readings(answered, rows)}
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                    out.flush()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
