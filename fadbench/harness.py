"""One run of one cell: set-up, the measured window, its metrics, and the
judgement of its answers.

Set-up draws the two pools from the seed on the device and writes them as
WAV files under a fresh directory of TMPDIR, links a directory pair for
each call (the first for the warm-up), draws the weights on the device
and loads them into the calculator, and runs the warm-up call. The window
then calls ``score()`` on one pair after another, each waited for, until
``seconds`` have passed; the call running at the deadline finishes and
counts. With ``trace``, or where an end-to-end metric of the cell is read
from the device trace, the window runs under devtrace.Tracer. After the
window the program is freed and the plain reference judges every call.
"""

from __future__ import annotations

import gc
import math
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import torch

from . import corpus, devtrace, judge, spec


@dataclass
class Run:
    """What the metric readers (fadbench/metrics/) read."""

    cell: spec.Cell
    setup_s: float
    window_s: float
    calls: List[dict]
    peak_window_bytes: int
    trace: Optional[devtrace.Trace] = None

    @property
    def completed(self) -> List[dict]:
        return [c for c in self.calls if not c["failed"]]

    @property
    def clips(self) -> int:
        """Clips embedded by the window's completed calls."""
        return sum(c["clips"] for c in self.completed)

    @property
    def clip_samples(self) -> int:
        """Samples of one clip (every clip of a traffic has one length)."""
        return corpus.clip_samples(self.cell.traffic)


@dataclass
class Corpus:
    """A run's inputs: the pools on the host, the pairs and their directories."""

    seeds: dict
    pools: dict
    pairs: list
    dirs: list
    bytes_written: int


def make_corpus(cell: spec.Cell, seed: int, device: torch.device, tmp: str,
                log=sys.stderr) -> Corpus:
    traffic = cell.traffic
    s = corpus.seeds(seed)
    t0 = time.perf_counter()
    pools = corpus.make_pools(traffic, s["pools"], device)
    t1 = time.perf_counter()
    written = corpus.write_pools(tmp, pools, traffic["sample_rate"])
    t2 = time.perf_counter()
    subsets = corpus.draw_subsets(traffic, s["directories"])
    jobs = [(side, i, idx) for side, draws in subsets.items() for i, idx in enumerate(draws)]
    # One directory a thread: links into different directories do not wait
    # on one another's directory lock.
    with ThreadPoolExecutor(8) as ex:
        linked = list(ex.map(lambda job: corpus.link_dir(tmp, *job), jobs))
    paths = {side: [d for (s_, _, _), d in zip(jobs, linked) if s_ == side] for side in subsets}
    order = corpus.schedule(traffic["directories"])
    pairs = [{"background": subsets["background"][b], "eval": subsets["eval"][e]}
             for b, e in order]
    dirs = [(paths["background"][b], paths["eval"][e]) for b, e in order]
    print(f"set-up: pools drawn in {t1 - t0:.3f} s, {written} bytes of WAV written in "
          f"{t2 - t1:.3f} s, {len(dirs)} directory pairs linked in "
          f"{time.perf_counter() - t2:.3f} s", file=log)
    return Corpus(s, pools, pairs, dirs, written)


class Calculator:
    """The program under test, FrechetAudioDistance, with the benchmark's
    weights loaded, and the statistics each call hands its
    calculate_frechet_distance hook kept."""

    def __init__(self, cell: spec.Cell, seed: int, weight_seed: int, device: torch.device,
                 ckpt_dir: str):
        from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance

        cfg = cell.config
        gen = torch.Generator(device=device).manual_seed(weight_seed)
        state = cell.reference().init_state(cfg, gen, device)
        self.fad = FrechetAudioDistance(model_name=cfg["model_name"], weights="random",
                                        seed=seed, device=str(device), ckpt_dir=ckpt_dir,
                                        **cell.traffic.get("fad", {}))
        self.fad.model.load_state_dict(state)
        del state
        self.seen = []
        hook = self.fad.calculate_frechet_distance

        def recording(mu1, sigma1, mu2, sigma2, *args, **kwargs):
            self.seen.append((mu1, sigma1, mu2, sigma2))
            return hook(mu1, sigma1, mu2, sigma2, *args, **kwargs)

        self.fad.calculate_frechet_distance = recording
        self.score_kw = cell.traffic.get("score", {})
        self.stage = f"embed_files[{self.fad.pipeline.cfg.family}]"

    def embed_s(self) -> float:
        return self.fad.pipeline.timer.totals.get(self.stage, 0.0)

    def call(self, dirs, log=sys.stderr) -> dict:
        """One score() call on a directory pair, timed on the host clock."""
        n_seen, e0 = len(self.seen), self.embed_s()
        cpu0, main0 = time.process_time(), time.thread_time()
        c0 = time.perf_counter()
        try:
            value = self.fad.score(*dirs, **self.score_kw)
        except Exception as e:  # a call that raises is a failed call, not a crash
            print(f"score() raised {type(e).__name__}: {e}", file=log)
            value = -1
        c1 = time.perf_counter()
        # The process's and the main thread's CPU seconds: where the same
        # work takes more of them, the host's cores ran it slower.
        cpu = (time.process_time() - cpu0, time.thread_time() - main0)
        got = self.seen[n_seen:]
        failed = value == -1 or not math.isfinite(value) or len(got) != 1
        return {"t0": c0, "t1": c1, "wall_s": c1 - c0, "cpu_s": cpu,
                "embed_s": self.embed_s() - e0,
                "value": value, "stats": got[0] if len(got) == 1 else None, "failed": failed}

    def close(self, device: torch.device) -> None:
        del self.fad
        self.seen = []
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def window(calc: Calculator, data: Corpus, seconds: float, max_calls: Optional[int] = None,
           log=sys.stderr) -> List[dict]:
    """Calls on pairs 1, 2, ... back to back until ``seconds`` have passed
    (or ``max_calls`` are done); the call running at the deadline counts."""
    calls = []
    t0 = time.perf_counter()
    for j in range(1, len(data.dirs)):
        call = calc.call(data.dirs[j], log)
        call["pair"] = data.pairs[j]
        call["clips"] = sum(len(v) for v in data.pairs[j].values())
        calls.append(call)
        if call["t1"] - t0 >= seconds or (max_calls and len(calls) >= max_calls):
            break
    else:
        print(f"window: ran out of directory pairs after {len(calls)} calls", file=log)
    return calls


def card_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
        return out[0] if out else torch.cuda.get_device_name(device)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", root: Path = spec.ROOT, bench_dir: Path = spec.BENCH_DIR,
             log=sys.stderr) -> dict:
    """One run; returns the result line's object (the numbers compared last)."""
    from frechet_audio_distance_exported_tpu_torch.ops import launches

    cell = spec.load_cell(name, root, bench_dir)
    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="fadbench-")
    try:
        print(f"set-up: {time.perf_counter() - t_start:.3f} s to the cell's first step",
              file=log)
        data = make_corpus(cell, seed, dev, tmp, log)
        t = time.perf_counter()
        calc = Calculator(cell, seed, data.seeds["weights"], dev, str(Path(tmp) / "ckpt"))
        print(f"set-up: calculator and weights in {time.perf_counter() - t:.3f} s", file=log)
        _reset_peak(dev)
        warm = calc.call(data.dirs[0], log)
        print(f"set-up: warm-up call {warm['wall_s']:.3f} s"
              f"{', failed' if warm['failed'] else ''}", file=log)
        _sync(dev)
        peak_setup = _peak(dev)
        setup_s = time.perf_counter() - t_start

        _reset_peak(dev)
        launches.zero()
        # An end-to-end metric read from the device trace has the card
        # traced in every run; the host is sampled only with --trace 1.
        on_card = any(m["source"] == "device_trace" for m in cell.end_to_end)
        tracer = devtrace.Tracer(sample_host=trace) if trace or on_card else None
        if tracer:
            tracer.start()
        t0 = time.perf_counter()
        calls = window(calc, data, seconds, log=log)
        t1 = calls[-1]["t1"] if calls else t0
        traced = tracer.stop(t0, t1) if tracer else None
        peak_window = _peak(dev)
        kernel_counts = launches.read()
        calc.close(dev)

        answered = [c for c in calls if not c["failed"]]
        run = Run(cell=cell, setup_s=setup_s, window_s=t1 - t0, calls=calls,
                  peak_window_bytes=peak_window, trace=traced)
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = cell.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        t = time.perf_counter()
        rows = judge.reference_rows(cell, data.pools, data.seeds["weights"], dev)
        values = judge.readings(answered, rows)
        print(f"judge: {len(calls)} calls, reference {time.perf_counter() - t:.3f} s", file=log)
        print("window: call seconds " + " ".join(f"{c['wall_s']:.3f}" for c in calls), file=log)
        print("window: call CPU seconds, process/main thread " +
              " ".join(f"{c['cpu_s'][0]:.2f}/{c['cpu_s'][1]:.2f}" for c in calls), file=log)
        correct, checks = judge.decide(cell.limits, values,
                                       bool(calls) and len(answered) == len(calls))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    dev_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": max(peak_setup, peak_window),
    }
    result = {"correct": correct, "attempted": len(calls),
              "failed": len(calls) - len(answered), "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = traced.busy_s
        dev_info["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    result["card"] = card_line(dev)
    result["launches"] = {k: v for k, v in kernel_counts.items() if v}
    result["checks"] = checks
    return result
