"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and checks
each against its plain torch version at the main paths' shapes. Then it
drives both ported paths through the public API,
FrechetAudioDistance(weights="random", device="cuda"):
- VGGish: scores two WAV corpora and checks the results;
- PANN: scores the same corpora with pann-16k, and a part of them with
  pann-8k and pann-32k (the resample path and the other two geometries).
Each path (vggish, pann-16k, pann-8k, pann-32k) runs with both kernels'
launch counts set to 0 just before it and read just after, so the counts
show which kernel the path went through; the `kernels` line gives each
kernel's count on its main path (vggish, pann-16k), and the PANN kernel's
count on each PANN path under "launches_by_path".
Any failure raises and the exit code is non-zero. It imports nothing of JAX.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists the kernels with their launch counts, errors and
times. Without CUDA, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SEED = 0
N_CLIPS = 32  # per corpus, 10 s each
CLIP_SECONDS = 10.0
LONG_SECONDS = 1000.0  # VGGish: 1041 patches, crosses patch_chunk=1024; PANN: 100001 frames
SHORT_SECONDS = 0.5  # under one 0.96 s VGGish patch; a 72-frame grid for PANN
RAGGED_FRAMES = 296
PANN_SMALL_CLIPS = 8  # per side, for pann-8k and pann-32k
LOGMEL_ATOL = 1e-4  # VGGish kernel vs plain, exact float32 on both; only the sum order differs
# PANN kernel vs plain: linear mel power, relative to each file's largest. A
# dB bar would fail healthy kernels on quiet bins, where the summation order
# moves a near-cancelling sum by whole decibels.
PANN_POWER_RTOL = 1e-5
EMBEDDING_ATOL = 1e-4  # card vs CPU plain path: cuDNN vs CPU convolution order
DEVICE_STATS_RTOL = 1e-3


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of fn, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed_pair(torch, kernel, plain, iters: int = 20):
    """(kernel ms, plain ms, the four runs), taken in the order plain, kernel, kernel, plain."""
    plain_a = cuda_ms(torch, plain, iters)
    kern_a = cuda_ms(torch, kernel, iters)
    kern_b = cuda_ms(torch, kernel, iters)
    plain_b = cuda_ms(torch, plain, iters)
    return (kern_a + kern_b) / 2, (plain_a + plain_b) / 2, (plain_a, kern_a, kern_b, plain_b)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def write_corpora(root: Path, audio_io, np) -> tuple:
    rng = np.random.default_rng(SEED)
    sr = 16000
    bg, ev = root / "bg", root / "ev"
    bg.mkdir()
    ev.mkdir()
    t = np.arange(int(sr * CLIP_SECONDS)) / sr
    for i in range(N_CLIPS):
        freq = 220.0 * 2 ** (i / 12)
        audio_io.write_wav(str(bg / f"sine{i:02d}.wav"), 0.5 * np.sin(2 * np.pi * freq * t), sr)
        audio_io.write_wav(str(ev / f"noise{i:02d}.wav"), rng.standard_normal(t.size) * 0.1, sr)
    audio_io.write_wav(
        str(ev / "short.wav"), 0.5 * np.sin(2 * np.pi * 440.0 * t[: int(sr * SHORT_SECONDS)]), sr
    )
    audio_io.write_wav(
        str(ev / "long.wav"), rng.standard_normal(int(sr * LONG_SECONDS)) * 0.1, sr
    )
    # A part of each corpus, for the pann-8k and pann-32k calls.
    small = []
    for src, prefix in ((bg, "sine"), (ev, "noise")):
        dst = root / f"{src.name}_small"
        dst.mkdir()
        for i in range(PANN_SMALL_CLIPS):
            os.link(src / f"{prefix}{i:02d}.wav", dst / f"{prefix}{i:02d}.wav")
        small.append(str(dst))
    return str(bg), str(ev), *small


def build_phase(torch, _build) -> None:
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.relative_to(ROOT)}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if any(k in line for k in ("entry function", "registers", "spill", "smem")):
            print("ptxas:", line.strip())


def vggish_kernel_phase(torch, np, cuda_frontend, fe, batch: int):
    """VGGish kernel vs plain at B = the CUDA default file_batch, T = 960
    frames (10 s clips, in their length bucket of 163840 samples), and a
    ragged T whose wave ends inside the last frame."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(960, 163840), (RAGGED_FRAMES, (RAGGED_FRAMES - 1) * fe.VGGISH_HOP + 300)]
    max_err = 0.0
    times = {}
    for num_frames, num_samples in shapes:
        wave = torch.randn((batch, num_samples), generator=gen, device=dev) * 0.1
        out = cuda_frontend.fused_vggish_logmel(wave, num_frames)
        ref = cuda_frontend.fused_vggish_logmel_reference(wave, num_frames)
        torch.cuda.synchronize()
        check(out.shape == (batch, num_frames, fe.VGGISH_MEL_BINS), f"kernel shape {out.shape}")
        check(bool(torch.isfinite(out).all()), "kernel output not finite")
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        kern, plain, runs = timed_pair(
            torch,
            lambda: cuda_frontend.fused_vggish_logmel(wave, num_frames),
            lambda: cuda_frontend.fused_vggish_logmel_reference(wave, num_frames),
        )
        times[num_frames] = (kern, plain)
        print(f"vggish logmel B={batch} T={num_frames} S={num_samples}: max_abs_err {err:.3e} "
              f"kernel {kern:.4f} ms ({runs[1]:.4f}, {runs[2]:.4f}) "
              f"plain {plain:.4f} ms ({runs[0]:.4f}, {runs[3]:.4f})")
    check(max_err <= LOGMEL_ATOL, f"VGGish kernel vs plain log-mel {max_err} > {LOGMEL_ATOL}")
    return max_err, times[960]


def pann_kernel_phase(torch, np, cuda_pann_frontend, fe, batch: int):
    """PANN kernel vs plain at all four geometries: B = the CUDA PANN
    file_batch, T = 1032 (10 s clips on their grid; the buffer is the grid's
    t*hop + n_fft samples) and T = 1001 at 48 kHz, with a ragged n_valid on
    some rows and one row of batch padding (n_valid 0)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst, times = 0.0, {}
    for sr in sorted(fe.PANN_CONFIGS):
        cfg = fe.PANN_CONFIGS[sr]
        n_fft, hop = cfg["window_size"], cfg["hop_size"]
        num_frames = 1001 if sr == 48000 else 1032
        wave = torch.randn((batch, num_frames * hop + n_fft), generator=gen, device=dev) * 0.1
        nv = np.full((batch,), num_frames, np.int32)
        nv[1], nv[2], nv[3] = num_frames - 31, num_frames // 2 + 3, 0
        n_valid = torch.from_numpy(nv).to(dev)
        out = cuda_pann_frontend.fused_pann_logmel(wave, n_valid, sr, num_frames)
        ref = cuda_pann_frontend.fused_pann_logmel_reference(wave, n_valid, sr, num_frames)
        torch.cuda.synchronize()
        check(out.shape == (batch, num_frames, 64), f"PANN kernel shape {out.shape}")
        check(bool(torch.isfinite(out).all()), f"PANN kernel output not finite at {sr} Hz")
        err = 0.0
        for b in range(batch):
            v = int(nv[b])
            check(not bool(out[b, v:].any()), f"{sr} Hz: kernel rows past n_valid {v} are not 0")
            check(not bool(ref[b, v:].any()), f"{sr} Hz: plain rows past n_valid {v} are not 0")
            if v:
                p_out = torch.pow(10.0, out[b, :v].double() / 10.0)
                p_ref = torch.pow(10.0, ref[b, :v].double() / 10.0)
                err = max(err, float((p_out - p_ref).abs().max() / p_ref.max()))
        worst = max(worst, err)
        kern, plain, runs = timed_pair(
            torch,
            lambda: cuda_pann_frontend.fused_pann_logmel(wave, n_valid, sr, num_frames),
            lambda: cuda_pann_frontend.fused_pann_logmel_reference(wave, n_valid, sr, num_frames),
        )
        times[sr] = (kern, plain)
        print(f"pann logmel {sr} Hz (n_fft {n_fft}, hop {hop}) B={batch} T={num_frames}: "
              f"max power err / file max {err:.3e}, kernel {kern:.4f} ms "
              f"({runs[1]:.4f}, {runs[2]:.4f}) plain {plain:.4f} ms ({runs[0]:.4f}, {runs[3]:.4f})")
        check(err <= PANN_POWER_RTOL, f"PANN kernel vs plain at {sr} Hz: {err} > {PANN_POWER_RTOL}")
    return worst, times[16000]


def run_scores(torch, fad, calls, counter, label: str) -> dict:
    """fad.score for each (name, args, kwargs); each call must raise the counter."""
    scores = {}
    for name, args, kwargs in calls:
        before = counter.LAUNCHES
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scores[name] = fad.score(*args, **kwargs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"{label} score {name}: {scores[name]!r} in {time.perf_counter() - t0:.3f} s, "
              f"peak {peak / 2**30:.3f} GiB, LAUNCHES {before} -> {counter.LAUNCHES}")
        check(counter.LAUNCHES > before, f"{label} score {name} did not launch its kernel")
        check(scores[name] != -1 and math.isfinite(scores[name]),
              f"{label} score {name} = {scores[name]}")
    return scores


def run_path(torch, fad, calls, kernel, other, label: str):
    """One path: both launch counts set to 0 just before it and read just
    after. Returns (scores, this path's launches of its kernel); the other
    family's kernel must not launch."""
    kernel.LAUNCHES = other.LAUNCHES = 0
    scores = run_scores(torch, fad, calls, kernel, label)
    launches, stray = kernel.LAUNCHES, other.LAUNCHES
    print(f"{label} path: {launches} launches of its kernel, {stray} of the other")
    check(stray == 0, f"the {label} path launched the other family's kernel")
    return scores, launches


def check_pair_scores(scores: dict, label: str) -> None:
    check(scores["bg_bg"] <= 1e-3, f"{label} score(bg, bg) = {scores['bg_bg']}")
    check(scores["bg_ev"] > 0 and scores["bg_ev"] > 10 * abs(scores["bg_bg"]),
          f"{label} score(bg, ev) = {scores['bg_ev']} does not separate from score(bg, bg)")
    rel = abs(scores["bg_ev_device_stats"] - scores["bg_ev"]) / abs(scores["bg_ev"])
    print(f"{label} device_stats vs host: relative difference {rel:.3e}")
    check(rel <= DEVICE_STATS_RTOL, f"{label} device_stats vs host {rel} > {DEVICE_STATS_RTOL}")


def card_vs_cpu(np, fad, cpu_fad, clips, sr: int, shape, label: str) -> None:
    on_card = fad.get_embeddings(clips, sr=sr)
    on_cpu = cpu_fad.get_embeddings(clips, sr=sr)
    check(on_card.shape == on_cpu.shape == shape, f"{label} embedding shape {on_card.shape}")
    check(bool(np.isfinite(on_card).all()), f"{label} embeddings not finite")
    err = float(np.abs(on_card - on_cpu).max())
    print(f"{label} embeddings card vs CPU plain path: max_abs_err {err:.3e} "
          f"(mean |x| {float(np.abs(on_cpu).mean()):.3e})")
    check(err <= EMBEDDING_ATOL, f"{label} card vs CPU embeddings {err} > {EMBEDDING_ATOL}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import frechet_audio_distance_exported_tpu_torch as port
    from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance
    from frechet_audio_distance_exported_tpu_torch.ops import _build, cuda_frontend, cuda_pann_frontend
    from frechet_audio_distance_exported_tpu_torch.ops import frontends as fe
    from frechet_audio_distance_exported_tpu_torch.pipeline import DEFAULT_FILE_BATCH
    from frechet_audio_distance_exported_tpu_torch.utils import audio_io

    check(Path(port.__file__).resolve().is_relative_to(ROOT),
          f"the port must come from this checkout, got {port.__file__}")
    check("jax" not in sys.modules, "jax was imported")

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. Build both kernels from this checkout's sources.
    build_phase(torch, _build)

    # 3. Each kernel against its plain version at its main path's shapes.
    batch = DEFAULT_FILE_BATCH["cuda"]
    vggish_err, (vggish_ms, vggish_plain_ms) = vggish_kernel_phase(
        torch, np, cuda_frontend, fe, batch
    )
    pann_err, (pann_ms, pann_plain_ms) = pann_kernel_phase(
        torch, np, cuda_pann_frontend, fe, batch
    )

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        bg, ev, bg_small, ev_small = write_corpora(tmp, audio_io, np)
        pair_calls = [
            ("bg_ev", (bg, ev), {}),
            ("bg_bg", (bg, bg), {}),
            ("bg_ev_device_stats", (bg, ev), {"device_stats": True}),
        ]

        def calculator(model, device="cuda"):
            return FrechetAudioDistance(
                model_name=model, weights="random", seed=SEED, ckpt_dir=str(tmp / "ck"),
                device=device,
            )

        # 4. The VGGish path through the public API.
        fad = calculator("vggish")
        check(torch.backends.cuda.matmul.allow_tf32 is False, "matmul TF32 is on")
        check(torch.backends.cudnn.allow_tf32 is False, "cuDNN TF32 is on")
        check(fad.pipeline.file_batch == batch, "file_batch is not the CUDA default")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fad.warmup()
        torch.cuda.synchronize()
        print(f"vggish warmup ({batch} x 10 s clips, f32 + int16 wire, host + device "
              f"stats): {time.perf_counter() - t0:.2f} s, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        scores, vggish_launches = run_path(
            torch, fad, pair_calls, cuda_frontend, cuda_pann_frontend, "vggish"
        )
        check_pair_scores(scores, "vggish")
        clips = [audio_io.load_audio(os.path.join(d, f), 16000, 1)
                 for d, f in ((bg, "sine05.wav"), (ev, "noise05.wav"))]
        card_vs_cpu(np, fad, calculator("vggish", "cpu"), clips, 16000, (20, 128), "vggish")
        del fad

        # 5. The PANN paths through the public API: pann-16k on the whole
        #    corpora (the 1000 s clip runs alone, on the long-file path),
        #    then pann-8k and pann-32k on a part of them, each a path of its
        #    own with the counts set to 0 just before it.
        fad = calculator("pann-16k")
        check(fad.pipeline.file_batch == batch, "PANN file_batch is not the CUDA default")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fad.warmup()
        torch.cuda.synchronize()
        print(f"pann-16k warmup ({batch} x 10 s clips, f32 + int16 wire, host + device "
              f"stats): {time.perf_counter() - t0:.2f} s, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        others = {name: calculator(name) for name in ("pann-8k", "pann-32k")}
        pann_launches = {}
        scores, pann_launches["pann-16k"] = run_path(
            torch, fad, pair_calls, cuda_pann_frontend, cuda_frontend, "pann-16k"
        )
        check_pair_scores(scores, "pann-16k")
        for name, other in others.items():
            _, pann_launches[name] = run_path(
                torch, other, [("bg_ev", (bg_small, ev_small), {})],
                cuda_pann_frontend, cuda_frontend, name,
            )
        clips = [audio_io.load_audio(os.path.join(d, f), 16000, 1)
                 for d, f in ((bg, "sine05.wav"), (ev, "noise05.wav"))]
        card_vs_cpu(np, fad, calculator("pann-16k", "cpu"), clips, 16000, (2, 2048), "pann-16k")

    print(json.dumps({"kernels": [
        {
            "name": "fused_vggish_logmel",
            "route": "cuda",
            "source": "frechet_audio_distance_exported_tpu_torch/csrc/vggish_logmel.cu",
            "replaces": "frechet_audio_distance_exported_tpu/ops/pallas_frontend.py:83",
            "launches": vggish_launches,
            "max_abs_err": vggish_err,
            "err_of": "log-mel, absolute",
            "ms": vggish_ms,
            "plain_ms": vggish_plain_ms,
        },
        {
            "name": "fused_pann_logmel",
            "route": "cuda",
            "source": "frechet_audio_distance_exported_tpu_torch/csrc/pann_logmel.cu",
            "replaces": "frechet_audio_distance_exported_tpu/ops/pallas_frontend.py:185",
            "launches": pann_launches["pann-16k"],
            "launches_by_path": pann_launches,
            "max_abs_err": pann_err,
            "err_of": "linear mel power, relative to each file's largest",
            "ms": pann_ms,
            "plain_ms": pann_plain_ms,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
