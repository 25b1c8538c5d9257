"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, checks it
against its plain torch version at the main path's shapes, then scores two
WAV corpora through FrechetAudioDistance(model_name="vggish",
weights="random", device="cuda") and checks the results. Any failure raises
and the exit code is non-zero. It imports nothing of JAX.

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
LONG_SECONDS = 1000.0  # 1041 patches: crosses patch_chunk=1024
SHORT_SECONDS = 0.5  # under one 0.96 s patch
RAGGED_FRAMES = 296
LOGMEL_ATOL = 1e-4  # kernel vs plain, exact float32 on both; only the sum order differs
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
    return str(bg), str(ev)


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
    from frechet_audio_distance_exported_tpu_torch.ops import _build, cuda_frontend
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

    # 2. Build the kernels from this checkout's sources.
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.relative_to(ROOT)}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("ptxas:", line.strip())

    # 3. Kernel vs plain version at the main path's shapes: B = the CUDA
    #    default file_batch, T = 960 frames (10 s clips, in their length
    #    bucket of 163840 samples), and a ragged T whose wave ends inside the
    #    last frame.
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = DEFAULT_FILE_BATCH["cuda"]
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
        plain_a = cuda_ms(torch, lambda: cuda_frontend.fused_vggish_logmel_reference(wave, num_frames))
        kern_a = cuda_ms(torch, lambda: cuda_frontend.fused_vggish_logmel(wave, num_frames))
        kern_b = cuda_ms(torch, lambda: cuda_frontend.fused_vggish_logmel(wave, num_frames))
        plain_b = cuda_ms(torch, lambda: cuda_frontend.fused_vggish_logmel_reference(wave, num_frames))
        times[num_frames] = ((kern_a + kern_b) / 2, (plain_a + plain_b) / 2)
        print(f"logmel B={batch} T={num_frames} S={num_samples}: max_abs_err {err:.3e} "
              f"kernel {times[num_frames][0]:.4f} ms ({kern_a:.4f}, {kern_b:.4f}) "
              f"plain {times[num_frames][1]:.4f} ms ({plain_a:.4f}, {plain_b:.4f})")
    check(max_err <= LOGMEL_ATOL, f"kernel vs plain log-mel {max_err} > {LOGMEL_ATOL}")

    # 4. The main path: score two corpora through the public API.
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        bg, ev = write_corpora(tmp, audio_io, np)
        fad = FrechetAudioDistance(
            model_name="vggish", weights="random", seed=SEED, ckpt_dir=str(tmp / "ck"),
            device="cuda",
        )
        check(torch.backends.cuda.matmul.allow_tf32 is False, "matmul TF32 is on")
        check(torch.backends.cudnn.allow_tf32 is False, "cuDNN TF32 is on")
        check(fad.pipeline.file_batch == batch, "file_batch is not the CUDA default")

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fad.warmup()
        torch.cuda.synchronize()
        print(f"warmup ({batch} x 10 s clips, f32 + int16 wire, host + device stats): "
              f"{time.perf_counter() - t0:.2f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

        cuda_frontend.LAUNCHES = 0
        scores, peaks = {}, {}
        calls = [
            ("bg_ev", (bg, ev), {}),
            ("bg_bg", (bg, bg), {}),
            ("bg_ev_device_stats", (bg, ev), {"device_stats": True}),
        ]
        for name, args, kwargs in calls:
            before = cuda_frontend.LAUNCHES
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            scores[name] = fad.score(*args, **kwargs)
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated()
            print(f"score {name}: {scores[name]!r} in {time.perf_counter() - t0:.3f} s, "
                  f"peak {peaks[name] / 2**30:.3f} GiB, LAUNCHES {before} -> {cuda_frontend.LAUNCHES}")
            check(cuda_frontend.LAUNCHES > before, f"score {name} did not launch the kernel")
        launches = cuda_frontend.LAUNCHES

        # 5. Checks on what came out.
        for name, score in scores.items():
            check(score != -1 and math.isfinite(score), f"score {name} = {score}")
        check(scores["bg_bg"] <= 1e-3, f"score(bg, bg) = {scores['bg_bg']}")
        check(scores["bg_ev"] > 0 and scores["bg_ev"] > 10 * abs(scores["bg_bg"]),
              f"score(bg, ev) = {scores['bg_ev']} does not separate from score(bg, bg)")
        rel = abs(scores["bg_ev_device_stats"] - scores["bg_ev"]) / abs(scores["bg_ev"])
        print(f"device_stats vs host: relative difference {rel:.3e}")
        check(rel <= DEVICE_STATS_RTOL, f"device_stats vs host {rel} > {DEVICE_STATS_RTOL}")

        # The card's embeddings against the port's plain CPU path, same weights.
        clips = [audio_io.load_audio(os.path.join(d, f), 16000, 1)
                 for d, f in ((bg, "sine05.wav"), (ev, "noise05.wav"))]
        on_card = fad.get_embeddings(clips, sr=16000)
        cpu_fad = FrechetAudioDistance(
            model_name="vggish", weights="random", seed=SEED, ckpt_dir=str(tmp / "ck"),
            device="cpu",
        )
        on_cpu = cpu_fad.get_embeddings(clips, sr=16000)
        check(on_card.shape == on_cpu.shape == (20, 128), f"embedding shape {on_card.shape}")
        check(bool(np.isfinite(on_card).all()), "embeddings not finite")
        emb_err = float(np.abs(on_card - on_cpu).max())
        print(f"embeddings card vs CPU plain path: max_abs_err {emb_err:.3e} "
              f"(mean |x| {float(np.abs(on_cpu).mean()):.3e})")
        check(emb_err <= EMBEDDING_ATOL, f"card vs CPU embeddings {emb_err} > {EMBEDDING_ATOL}")

    kern_ms, plain_ms = times[960]
    print(json.dumps({"kernels": [{
        "name": "fused_vggish_logmel",
        "route": "cuda",
        "source": "frechet_audio_distance_exported_tpu_torch/csrc/vggish_logmel.cu",
        "replaces": "frechet_audio_distance_exported_tpu/ops/pallas_frontend.py:83",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
