"""Shared pieces of the benchmark's CPU tests: the repository root on the
import path, the card fixture, and a copy of the benchmark with one tiny
cell added from files (a two-second or ten-second corpus of a few clips)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CELL = "tiny.vggish"


def tiny_traffic(sample_rate: int, clip_seconds: float) -> dict:
    return {
        "sample_rate": sample_rate,
        "clip_seconds": clip_seconds,
        "format": "wav_pcm16_mono",
        "pools": {
            "background": {"clips": 6, "tilt": [0.0, 0.8], "level_dbfs": [-36.0, -24.0]},
            "eval": {"clips": 6, "tilt": [1.2, 2.0], "level_dbfs": [-30.0, -18.0]},
        },
        "clips_per_call": {"background": 4, "eval": 4},
        "directories": 2,
        "score": {"device_stats": True},
        # Two files a device program: a call runs two chunks a directory.
        "fad": {"file_batch": 2},
    }


def make_root(tmp_path: Path, config: str = "vggish", cell: str = TINY_CELL,
              limits_of: str = "vggish.corpus") -> Path:
    """A checkout-like root: BENCHMARK.json and a copy of fadbench/ with the
    cell ``cell`` of configuration ``config`` added as files only (its
    traffic, its limits, a BENCHMARK.json entry, every metric listing it);
    the limits are those of the real cell ``limits_of``."""
    root = tmp_path / "root"
    bench_dir = root / "fadbench"
    shutil.copytree(ROOT / "fadbench", bench_dir,
                    ignore=shutil.ignore_patterns("tests", ".cache", "__pycache__"))
    sr, seconds = (16000, 2.0) if config == "vggish" else (48000, 10.0)
    (bench_dir / "traffic" / "tiny.json").write_text(json.dumps(tiny_traffic(sr, seconds)))
    shutil.copy(bench_dir / "limits" / f"{limits_of}.json", bench_dir / "limits" / f"{cell}.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": cell, "config": config, "traffic": "tiny", "chips": 1, "why": "a test cell"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        metric.get("workloads", []).append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
