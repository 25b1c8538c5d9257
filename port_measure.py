"""On-card measurements of the PyTorch/CUDA port's fused embed+stats path.

    python3 port_measure.py [--models pann-16k,vggish,clap,encodec-24k,encodec-48k]
                            [--clips 256] [--batches 16,32,64,128]
                            [--out-dir measure_out]

Needs one CUDA card; imports nothing of JAX. For each model, at full width
with random weights drawn from seed 0, on --clips clips of 10 s of noise on
the PCM16 grid at the model's rate (so chunks travel on the int16 wire;
stereo, two different channels, for encodec-48k), it measures
pipeline.accumulate_stats over the whole list, the path that
score(..., device_stats=True) runs:
- sweep: audio-min/s and peak device memory for each file_batch, taken in
  the order given and then in reverse, each after one warm-up pass (a
  file_batch that runs out of device memory is recorded as such);
- profile: one pass at the CUDA default file_batch under torch.profiler:
  the device-busy share (the union of device kernel and copy intervals over
  the pass's wall), device time per kernel name, and the four kernels'
  launch counts over the pass;
- split: the same pass's host preparation (PANN: reflect pad,
  as_int16_exact; CLAP: the pipeline's _clap_prep, which adds the 10 s pad
  and the int16 round trip; Encodec: the pipeline's _encodec_prep; all then
  _pack_wave), host-to-device copies and device steps on chunks already on
  the card, each timed alone (VGGish has no split);
- cprofile: one pass under cProfile, the host functions with most own time.
It also times the kernels' build: ops/_build.build() (one nvcc per source,
in parallel, then a link) against one nvcc call for all sources.

The numerics knobs apply as they do to FrechetAudioDistance: run it under
FAD_TPU_MODEL_DTYPE=bfloat16 (with another --out-dir) for the bf16 models;
each model's entry names its compute dtype.

Prints a summary and writes port_measure.json under --out-dir. Numbers are
of the card it ran on: the card's name and power limit are in the file.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CLIP_SECONDS = 10.0
SEED = 0


def synced_seconds(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def build_times(_build) -> dict:
    """Seconds of the package's parallel build and of one nvcc for all sources,
    each into an empty temporary directory."""
    sources = sorted(str(p) for p in _build.CSRC_DIR.glob("*.cu"))
    with tempfile.TemporaryDirectory() as tmp:
        saved = os.environ.get(_build.BUILD_DIR_ENV)
        os.environ[_build.BUILD_DIR_ENV] = str(Path(tmp) / "parallel")
        try:
            t0 = time.perf_counter()
            _build.build()
            parallel = time.perf_counter() - t0
        finally:
            if saved is None:
                del os.environ[_build.BUILD_DIR_ENV]
            else:
                os.environ[_build.BUILD_DIR_ENV] = saved
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", f"{tmp}/one.so", *sources]
        t0 = time.perf_counter()
        subprocess.run(cmd, check=True, capture_output=True)
        serial = time.perf_counter() - t0
    return {"sources": len(sources), "parallel_s": parallel, "one_nvcc_s": serial}


def device_profile(torch, run) -> dict:
    """Busy share and per-kernel device time of one pass under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = synced_seconds(torch, run)
    spans, per_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        row = per_name.setdefault(e.name, [0.0, 0])
        row[0] += (end - start) / 1e3
        row[1] += 1
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    kernels = sorted(
        ({"name": n, "ms": ms, "count": c} for n, (ms, c) in per_name.items()),
        key=lambda r: -r["ms"],
    )
    return {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "busy_share": busy_us / 1e3 / (wall * 1e3),
        "kernels": kernels,
    }


def host_profile(run, top: int = 15) -> list:
    prof = cProfile.Profile()
    prof.enable()
    run()
    prof.disable()
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [
        {"function": f"{Path(f).name}:{line}({name})", "calls": nc, "own_ms": tt * 1e3,
         "cum_ms": ct * 1e3}
        for (f, line, name), (_, nc, tt, ct, _) in rows
    ]


def timed_split(torch, pipe, prepare, step) -> dict:
    """Host preparation, host-to-device copies and device steps of one
    accumulate_stats pass, each timed alone. prepare() -> the pass's chunks
    as tuples (numpy arrays go to the card, other items stay as they are);
    step(state, *chunk on the card) -> state."""
    import numpy as np

    t0 = time.perf_counter()
    packed = prepare()
    host_s = time.perf_counter() - t0
    on_card = []
    copy_s = synced_seconds(torch, lambda: on_card.extend(
        tuple(pipe._to_device(a) if isinstance(a, np.ndarray) else a for a in chunk)
        for chunk in packed
    ))

    def steps():
        state = None
        for chunk in on_card:
            state = step(state, *chunk)

    with torch.inference_mode():
        steps()  # warm-up
        device_s = synced_seconds(torch, steps)
    return {"host_prep_ms": host_s * 1e3, "copy_ms": copy_s * 1e3, "device_ms": device_s * 1e3,
            "chunks": len(packed), "wire": str(packed[0][0].dtype)}


def mel_split(torch, np, pipeline_mod, pipe, clips, prep, target_sr, full_scale) -> dict:
    """timed_split of EmbeddingPipeline._embed_mel_cnn for clips that share
    one program shape; prep(clip) -> (wave row, frame count, buffer length,
    frames of the program)."""
    _, _, length, num_frames = prep(clips[0])
    b_cap = min(pipe.file_batch, max(1, (pipe.file_batch * 1032) // num_frames))

    def prepare():
        packed = []
        for c0 in range(0, len(clips), b_cap):
            items = [prep(data) for data in clips[c0 : c0 + b_cap]]
            b = pipeline_mod.bucket_batch(len(items), b_cap)
            n_valid = np.zeros((b,), np.int32)
            n_valid[: len(items)] = [frames for _, frames, _, _ in items]
            wave = pipeline_mod._pack_wave([row for row, _, _, _ in items], b, length, full_scale)
            packed.append((wave, n_valid, len(items)))
        return packed

    def step(state, wave, n_valid, n_live):
        return pipeline_mod._fused_mel_cnn_stats_step(
            pipe.forward, wave, n_valid, n_live, state, target_sr, num_frames, full_scale
        )

    return timed_split(torch, pipe, prepare, step)


def encodec_split(torch, np, pipeline_mod, fe, pipe, clips, sr) -> dict:
    """timed_split of EmbeddingPipeline._embed_encodec: the pipeline's own
    _encodec_prep, then chunks of file_batch padded to 10 s."""
    max_samples = fe.ENCODEC_CONFIGS[sr]["max_samples"]
    fb = pipe.file_batch

    def prepare():
        packed = []
        for c0 in range(0, len(clips), fb):
            items = [pipe._encodec_prep(data, sr) for data in clips[c0 : c0 + fb]]
            b = pipeline_mod.bucket_batch(len(items), fb)
            frames = np.zeros((b,), np.int64)
            frames[: len(items)] = [count for _, count in items]
            packed.append((pipeline_mod._pack_wave([row for row, _ in items], b, max_samples),
                           frames))
        return packed

    def step(state, wave, frames):
        return pipeline_mod._fused_encodec_stats_step(pipe.forward, wave, frames, state)

    return timed_split(torch, pipe, prepare, step)


def pann_prep(pipeline_mod, fe, target_sr):
    """_embed_pann's steps for a clip at the model's rate: reflect pad, int16 check."""
    n_fft = fe.PANN_CONFIGS[target_sr]["window_size"]
    hop = fe.PANN_CONFIGS[target_sr]["hop_size"]

    def prep(data):
        t_i = fe.pann_num_frames(len(data), hop)
        t_grid = fe.pann_valid_time(t_i)
        padded = fe.reflect_pad_host(data, n_fft)
        q = pipeline_mod.as_int16_exact(padded)
        return (padded if q is None else q), t_i, t_grid * hop + n_fft, t_grid

    return prep


def clap_prep(pipeline_mod, fe, pipe):
    """_embed_clap's steps: the pipeline's own _clap_prep, and its length bucket."""

    def prep(data):
        row, n_valid = pipe._clap_prep(data, fe.CLAP_SAMPLE_RATE)
        return row, n_valid, pipeline_mod.bucket_len(len(row)), fe.CLAP_TIME_FRAMES

    return prep


def measure_model(torch, np, port, model_name: str, n_clips: int, batches, tmp) -> dict:
    from frechet_audio_distance_exported_tpu_torch import pipeline as pipeline_mod
    from frechet_audio_distance_exported_tpu_torch import registry
    from frechet_audio_distance_exported_tpu_torch.ops import frontends as fe
    from frechet_audio_distance_exported_tpu_torch.ops import launches

    fad = port.FrechetAudioDistance(
        model_name=model_name, weights="random", seed=SEED, ckpt_dir=tmp, device="cuda"
    )
    sr = fad.sample_rate
    channels = registry.VALID_MODELS[model_name].get("channels", 1)
    shape = (int(sr * CLIP_SECONDS),) + ((channels,) if channels > 1 else ())
    rng = np.random.default_rng(SEED)
    clips = [
        (np.round(rng.standard_normal(shape) * 0.1 * 32768.0).clip(-32768, 32767)
         / 32768.0).astype(np.float32)
        for _ in range(n_clips)
    ]
    audio_min = n_clips * CLIP_SECONDS / 60.0
    family = fad.pipeline.cfg.family

    def pipe_for(fb):
        return pipeline_mod.EmbeddingPipeline(model_name, fad.model, fad.device, file_batch=fb)

    def pass_of(pipe):
        return lambda: pipe.accumulate_stats(clips, sr)

    sweep = {fb: [] for fb in batches}
    for fb in list(batches) + list(reversed(batches)):
        if sweep[fb] and sweep[fb][0].get("oom"):
            continue
        run = pass_of(pipe_for(fb))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            if not sweep[fb]:
                run()  # warm-up: cuDNN's algorithm choice and the allocator's growth
            s = synced_seconds(torch, run)
        except torch.cuda.OutOfMemoryError:
            sweep[fb].append({"oom": True, "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
            print(f"{model_name} file_batch {fb}: out of device memory")
            continue
        sweep[fb].append({"s": s, "audio_min_per_s": audio_min / s,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30})
        print(f"{model_name} file_batch {fb}: {audio_min / s:.2f} audio-min/s, "
              f"peak {sweep[fb][-1]['peak_gib']:.3f} GiB "
              f"(reserved {sweep[fb][-1]['peak_reserved_gib']:.3f})")
    torch.cuda.empty_cache()

    default = pipe_for(None)
    run = pass_of(default)
    run()
    launches.zero()
    prof = device_profile(torch, run)
    prof["file_batch"] = default.file_batch
    prof["kernel_launches"] = launches.read()
    print(f"{model_name} profile at file_batch {default.file_batch}: wall "
          f"{prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.1f} ms "
          f"({100 * prof['busy_share']:.1f} %)")
    for row in prof["kernels"][:12]:
        print(f"  {row['ms']:9.3f} ms  x{row['count']:<4d} {row['name'][:110]}")
    out = {"clips": n_clips, "clip_seconds": CLIP_SECONDS, "model_dtype": str(default.dtype),
           "sweep": sweep, "profile": prof}
    if family != "vggish":
        if family == "encodec":
            out["split"] = encodec_split(torch, np, pipeline_mod, fe, default, clips, sr)
        else:
            if family == "pann":
                prep, full_scale = pann_prep(pipeline_mod, fe, sr), 32768.0
            else:
                prep, full_scale = clap_prep(pipeline_mod, fe, default), 32767.0
            out["split"] = mel_split(torch, np, pipeline_mod, default, clips, prep, sr, full_scale)
        out["split"]["whole_pass_ms"] = synced_seconds(torch, run) * 1e3
        print(f"{model_name} split: {out['split']}")
    out["cprofile"] = host_profile(run)
    for row in out["cprofile"][:6]:
        print(f"  host {row['own_ms']:8.1f} ms own, {row['cum_ms']:8.1f} cum  {row['function']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default="pann-16k")
    ap.add_argument("--clips", type=int, default=256)
    ap.add_argument("--batches", default="16,32,64,128")
    ap.add_argument("--out-dir", default=str(ROOT / "measure_out"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_measure: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import frechet_audio_distance_exported_tpu_torch as port
    from frechet_audio_distance_exported_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build": build_times(_build)}
    print(f"build: {result['build']}")
    batches = [int(b) for b in args.batches.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        for model_name in args.models.split(","):
            result[model_name] = measure_model(torch, np, port, model_name, args.clips, batches, tmp)
    out = Path(args.out_dir) / "port_measure.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
