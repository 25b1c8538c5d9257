"""The harness on the CPU: a cell, a traffic, limits and a metric added as
files only run end to end and come out correct; with the program's timed
path broken underneath, the same run comes out not correct."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY_CELL, make_root

SEED = 2**31 + 7


def run_tiny(root, trace=False):
    from fadbench import harness

    return harness.run_cell(TINY_CELL, SEED, 0.5, trace, time.perf_counter(), device="cpu",
                            root=root, bench_dir=root / "fadbench")


def test_a_cell_and_a_metric_added_as_files_run_and_are_correct(tmp_path):
    root = make_root(tmp_path)
    (root / "fadbench" / "metrics" / "calls_per_window.py").write_text(
        "def read(run):\n    return float(len(run.completed))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "calls_per_window", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "audio_min_per_s", "workloads": [TINY_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    plain = run_tiny(root)
    assert plain["correct"] and plain["failed"] == 0 and plain["attempted"] >= 1
    assert set(plain["metrics"]) == {"audio_min_per_s", "setup_s"}
    assert list(plain)[-1] == "checks"
    for check in plain["checks"].values():
        assert check["value"] <= check["limit"]

    traced = run_tiny(root, trace=True)
    assert traced["correct"]
    m = traced["metrics"]
    assert m["calls_per_window"]["value"] == traced["attempted"]
    # The CPU has no device trace, so the kernel rooflines find nothing to read.
    assert "vggish_logmel_roofline_pct" not in m and "swin_roofline_pct" not in m
    assert 0 < m["step_mfu"]["value"] < 100
    assert 0 <= m["host_runtime_pct"]["value"] < 100
    # A quantity split by the metric it moves reads with the quantity's reader.
    assert m["step_mfu.vggish"]["value"] == m["step_mfu"]["value"]
    assert m["audio_min_per_s.vggish"]["value"] > 0
    assert traced["device"]["busy_s"] == 0.0 and traced["device"]["window_s"] > 0
    assert traced["breakdown"]["idle_gaps"]


def test_device_seconds_per_audio_hour_reads_the_device_trace():
    from fadbench import devtrace, harness, spec

    cell = spec.load_cell("vggish.corpus")
    calls = [{"failed": False, "clips": 2048}, {"failed": True, "clips": 2048}]
    run = harness.Run(cell=cell, setup_s=1.0, window_s=10.0, calls=calls, peak_window_bytes=0)
    reader = cell.reader("device_s_per_audio_h")
    assert reader.read(run) is None  # no device trace, nothing to read
    run.trace = devtrace.Trace(window_s=10.0, busy_s=0.0, kernel_s={}, idle_by_frame={})
    assert reader.read(run) is None  # a trace in which the card did nothing
    run.trace.busy_s = 2.56
    # 2048 completed clips of 10 s are 5.69 hours; the failed call adds none.
    assert reader.read(run) == pytest.approx(2.56 / (2048 * 10 / 3600))


def _fold_unchanged(orig):
    """A step that returns its state unchanged (after the first chunk)."""

    def fold(state, emb, mask):
        return orig(state, emb, mask) if state is None else state

    return fold


def _fold_half(orig):
    """Half of each chunk's rows left out, the statistics taken over the rest."""

    def fold(state, emb, mask):
        flat = mask.reshape(-1).clone()
        flat[flat.numel() // 2 :] = False
        return orig(state, emb, flat.reshape(mask.shape))

    return fold


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    from frechet_audio_distance_exported_tpu_torch import pipeline
    from frechet_audio_distance_exported_tpu_torch.ops import stats

    if fault == "state_unchanged":
        monkeypatch.setattr(pipeline, "_fold_stats", _fold_unchanged(pipeline._fold_stats))
    elif fault == "half_batch":
        monkeypatch.setattr(pipeline, "_fold_stats", _fold_half(pipeline._fold_stats))
    else:
        orig = stats.frechet_distance_eigh_np
        monkeypatch.setattr(stats, "frechet_distance_eigh_np",
                            lambda *a, **k: orig(*a, **k) * (1.0 + 1e-4))
    result = run_tiny(make_root(tmp_path))
    assert result["failed"] == 0
    assert not result["correct"]


def test_run_py_loads_no_jax_and_refuses_without_a_card(tmp_path):
    """The whole CPU run in a fresh process loads no module of JAX or the JAX
    package (whole top-level names), and run.py without CUDA prints no result."""
    root = make_root(tmp_path)
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from fadbench import harness\n"
        "sys.path.insert(0, %r)\n"
        "import run\n"
        "r = harness.run_cell(%r, %d, 0.1, False, time.perf_counter(), device='cpu', "
        "root=__import__('pathlib').Path(%r), bench_dir=__import__('pathlib').Path(%r))\n"
        "assert r['correct'], r\n"
        "print('FORBIDDEN', run.forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "fadbench"), TINY_CELL, SEED, str(root), str(root / "fadbench"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    if not torch.cuda.is_available():
        cli = subprocess.run(
            [sys.executable, str(ROOT / "fadbench" / "run.py"), "--workload", "vggish.corpus",
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert cli.returncode != 0 and cli.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(ROOT / "fadbench"))
    import run

    monkeypatch.setitem(sys.modules, "frechet_audio_distance_exported_tpu_torch_x", np)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", np)
    assert "frechet_audio_distance_exported_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "frechet_audio_distance_exported_tpu.fad", np)
    monkeypatch.setitem(sys.modules, "jax.numpy", np)
    found = run.forbidden_modules()
    assert "frechet_audio_distance_exported_tpu" in found and "jax" in found
