"""The port's profiling utilities: the counterpart of test_profiling.py.

trace() writes a Chrome trace per rank when FAD_TPU_TRACE (or its argument)
names a directory and is a no-op otherwise; annotate() names a range in it;
the pipeline's verbose report lists the embed_files[family] stage.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import profiling  # noqa: E402


def test_stage_timer_accumulates():
    t = profiling.StageTimer()
    for name in ("a", "a", "b"):
        with t.stage(name):
            pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    report = t.report()
    assert "stage timings" in report and "a" in report and "b" in report


def test_trace_noop_without_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("FAD_TPU_TRACE", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace():
        x = torch.ones(4, 4) @ torch.ones(4, 4)
    assert float(x.sum()) == 64.0
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("how", ["env", "argument"])
def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch, how):
    log_dir = tmp_path / "traces"
    if how == "env":
        monkeypatch.setenv("FAD_TPU_TRACE", str(log_dir))
    else:
        monkeypatch.delenv("FAD_TPU_TRACE", raising=False)
    with profiling.trace(str(log_dir) if how == "argument" else None):
        with profiling.annotate("frontend"):
            x = torch.ones(8, 8) @ torch.ones(8, 8)
    assert float(x.sum()) == 512.0
    files = list(log_dir.glob("trace_rank0_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "frontend" for e in events)


def test_annotate_outside_a_trace():
    with profiling.annotate("frontend"):
        x = torch.ones(4) * 2
    np.testing.assert_array_equal(x.numpy(), 2.0)


def test_pipeline_reports_timings(capsys, sine_audio, tmp_path):
    fad = FrechetAudioDistance(model_name="vggish", weights="random", verbose=True, device="cpu",
                               ckpt_dir=str(tmp_path))
    fad.get_embeddings([sine_audio(1.0, 440.0), sine_audio(1.0, 550.0)], 16000)
    out = capsys.readouterr().out
    assert "stage timings" in out and "embed_files[vggish]" in out
    assert fad.pipeline.timer.counts["embed_files[vggish]"] == 1
