"""The port's span recorder (utils/profiling.span, start, stop) and the spans
of score(device_stats=True): off, nothing is recorded and span() is the
shared no-op; on, every call is one tree under its `score` span, with the
counts (`files` of `prep`, `bytes` of `h2d`) equal to what the call did, on
the perf_counter clock; under trace() the spans are ranges of the Chrome
trace, also through the CLI's FAD_TPU_TRACE.
"""

import json
import threading
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance, pipeline  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.__main__ import main  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import profiling  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils.audio_io import write_wav  # noqa: E402

FILES = 5  # a directory: two decode chunks of 4 files at file_batch=1
NAMES = ("score", "list", "decode.wait", "decode", "embed", "prep", "pack", "h2d", "step",
         "epilogue")
# Each span's parent, by name.
PARENT = {"list": "score", "decode.wait": "score", "embed": "score", "epilogue": "score",
          "decode": "decode.wait", "prep": "embed", "pack": "embed", "h2d": "embed",
          "step": "embed"}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    rng = np.random.default_rng(0)
    for d, level in (("bg", 0.1), ("ev", 0.3)):
        (root / d).mkdir()
        for i in range(FILES):
            x = rng.standard_normal(int(16000 * 1.5)) * level
            write_wav(str(root / d / f"{i}.wav"), x, 16000)  # PCM16
    (root / "ck").mkdir()
    return {d: str(root / d) for d in ("bg", "ev", "ck")}


@pytest.fixture(scope="module")
def fad(dirs):
    return FrechetAudioDistance(model_name="vggish", weights="random", device="cpu",
                                file_batch=1, ckpt_dir=dirs["ck"])


@pytest.fixture(autouse=True)
def no_recorder():
    assert profiling._recorder is None
    yield
    if profiling._recorder is not None:
        profiling.stop()
        pytest.fail("the test left spans being recorded")


def _recorded(fad, dirs, calls=1):
    profiling.start()
    t0 = time.perf_counter_ns()
    scores = [fad.score(dirs["bg"], dirs["ev"], device_stats=True) for _ in range(calls)]
    t1 = time.perf_counter_ns()
    spans = profiling.stop()
    assert all(s != -1 for s in scores)
    return spans, t0, t1


def test_off_records_nothing_and_reads_no_clock(fad, dirs, monkeypatch):
    assert profiling.span("pack") is profiling._NO_SPAN
    assert profiling.span("h2d", bytes=4) is profiling._NO_SPAN

    def clock():
        raise AssertionError("span() read the clock while nothing records")

    monkeypatch.setattr(profiling.time, "perf_counter_ns", clock)
    with profiling.span("decode", parent=profiling.span("decode.wait"), bytes=1) as s:
        assert s is None
    monkeypatch.undo()
    fad.score(dirs["bg"], dirs["ev"], device_stats=True)
    profiling.start()
    assert profiling.stop() == []


def test_start_and_stop_pair():
    with pytest.raises(RuntimeError):
        profiling.stop()
    profiling.start()
    with pytest.raises(RuntimeError):
        profiling.start()
    with profiling.span("a"):
        pending = profiling.span("b")
    with pending:  # made inside a, entered after it: a is its parent
        pass
    late = profiling.span("c")
    spans = profiling.stop()
    with late:  # ended after stop(): not recorded anywhere
        pass
    assert [s.name for s in spans] == ["a", "b"]
    a, b = spans
    assert b.parent == a.id and b.call == a.id and a.parent is None and a.call == a.id


def test_each_call_is_one_tree_of_the_layers(fad, dirs):
    spans, t0, t1 = _recorded(fad, dirs, calls=2)
    by_id = {s.id: s for s in spans}
    assert set(Counter(s.name for s in spans)) == set(NAMES)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["score", "score"]
    main = threading.main_thread().ident
    for root in roots:
        tree = [s for s in spans if s.call == root.id]
        n = Counter(s.name for s in tree)
        # Per call: two directories of FILES files, decoded in chunks of 4.
        assert n["list"] == 2 and n["decode.wait"] == 4 and n["decode"] == 2 * FILES
        assert n["embed"] == 4 and n["prep"] == 4 and n["epilogue"] == 1
        assert n["pack"] == n["step"] == 2 * FILES  # one file a program
        assert n["h2d"] == 2 * n["step"]  # the wave and the patch counts
    for s in spans:
        assert t0 <= s.start_ns <= s.end_ns <= t1
        if s.name == "score":
            continue
        parent = by_id[s.parent]
        assert parent.name == PARENT[s.name], (s, parent)
        assert s.call == parent.call
        if s.name == "decode":
            # Decoded in the pool's threads, a chunk ahead of its wait.
            assert s.thread != main
        else:
            assert s.thread == main
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_counts_are_the_files_and_the_bytes(fad, dirs, monkeypatch):
    packed = []
    pack = pipeline._pack_wave

    def spy(rows, b, length, *args):
        wave = pack(rows, b, length, *args)
        packed.append(wave)
        return wave

    monkeypatch.setattr(pipeline, "_pack_wave", spy)
    spans, _, _ = _recorded(fad, dirs)
    files = sum(s.counts["files"] for s in spans if s.name == "prep")
    assert files == 2 * FILES
    assert all(w.dtype == np.int16 for w in packed)  # PCM16 rides the int16 wire
    # Each packed wave, and VGGish's int64 patch count a row of it.
    expect = sum(w.nbytes + 8 * w.shape[0] for w in packed)
    assert sum(s.counts["bytes"] for s in spans if s.name == "h2d") == expect
    # Every file is a PCM16 WAV at the model's rate: each took the wire.
    assert all(set(s.counts) == {"files", "pcm16"} for s in spans if s.name == "prep")
    assert all(s.counts["pcm16"] == s.counts["files"] for s in spans if s.name == "prep")
    assert all(not s.counts for s in spans if s.name not in ("prep", "h2d"))


def test_self_time_is_the_duration_less_the_children(fad, dirs):
    spans, _, _ = _recorded(fad, dirs)
    own = profiling.self_ns(spans)
    for s in spans:
        kids = [c for c in spans if c.parent == s.id]
        if s.name in ("embed", "score"):  # children on its thread, one after another
            assert own[s.id] == s.duration_ns - sum(c.duration_ns for c in kids)
        if not kids:
            assert own[s.id] == s.duration_ns
    # Overlapping children and a child reaching outside its parent.
    S = profiling.Span
    hand = [S("p", 1, start_ns=100, end_ns=200), S("a", 2, 1, start_ns=90, end_ns=130),
            S("b", 3, 1, start_ns=120, end_ns=150), S("c", 4, 1, start_ns=180, end_ns=260)]
    # Covered: 100-130 (a), 130-150 (b), 180-200 (c).
    assert profiling.self_ns(hand)[1] == 100 - 30 - 20 - 20


def test_the_clock_is_perf_counter():
    a = time.perf_counter()
    b = time.perf_counter_ns()
    c = time.perf_counter()
    # ns against seconds: a float64 holds perf_counter to well under 1 us.
    assert a * 1e9 - 1000 <= b <= c * 1e9 + 1000


def _trace_names(log_dir):
    files = list(log_dir.glob("trace_rank0_*.json"))
    assert len(files) == 1
    return Counter(e.get("name") for e in json.loads(files[0].read_text())["traceEvents"])


def test_trace_shows_the_spans(fad, dirs, tmp_path, monkeypatch):
    monkeypatch.delenv("FAD_TPU_TRACE", raising=False)
    with profiling.trace(str(tmp_path / "own")):
        fad.score(dirs["bg"], dirs["ev"], device_stats=True)
    assert profiling._recorder is None  # it stopped the recorder it started
    names = _trace_names(tmp_path / "own")
    # The main thread's spans (the decode spans run in the pool's threads).
    for name in set(NAMES) - {"decode"}:
        assert names[name] >= 1, name
    # Inside a recording, the recording keeps its spans.
    profiling.start()
    with profiling.trace(str(tmp_path / "inside")):
        fad.score(dirs["bg"], dirs["ev"], device_stats=True)
    spans = profiling.stop()
    assert [s.name for s in spans if s.parent is None] == ["score"]
    assert _trace_names(tmp_path / "inside")["score"] == 1


def test_cli_writes_the_trace_named_by_fad_tpu_trace(dirs, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("FAD_TPU_TRACE", str(tmp_path / "cli"))
    rc = main([dirs["bg"], dirs["ev"], "--weights", "random", "--ckpt-dir", dirs["ck"],
               "--device", "cpu", "--device-stats", "--json"])
    assert rc == 0 and json.loads(capsys.readouterr().out.strip().splitlines()[-1])["fad"] > 0
    names = _trace_names(tmp_path / "cli")
    assert names["score"] == 1 and names["embed"] == 2 and names["epilogue"] == 1
