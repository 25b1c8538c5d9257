"""The correctness controls, on the card at a size a test run holds: the
port as its configuration states it (float32, TF32 off) comes out correct
against the plain reference, and its own lower-precision paths (TF32
products, bf16 models) come out not correct, on each cell's limits.
fadbench/calibrate.py reads the same numbers at the cells' own sizes."""

from __future__ import annotations

import time

import pytest

from conftest import make_root

MODES = [
    ({}, True),
    ({"FAD_TPU_PRECISION": "high"}, False),
    ({"FAD_TPU_MODEL_DTYPE": "bfloat16"}, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["vggish", "clap"])
@pytest.mark.parametrize("env,correct", MODES)
def test_lower_precision_fails_the_cells_limits(cuda_card, tmp_path, monkeypatch, config, env,
                                                correct):
    from fadbench import harness

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cell = f"tiny.{config}"
    root = make_root(tmp_path, config, cell, limits_of=f"{config}.corpus")
    result = harness.run_cell(cell, 2**31 + 11, 0.5, False, time.perf_counter(), device="cuda",
                              root=root, bench_dir=root / "fadbench")
    assert result["failed"] == 0
    assert result["correct"] is correct, result["checks"]
