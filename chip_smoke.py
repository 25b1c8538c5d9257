"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's four CUDA kernels from the sources in this checkout and
checks each against its plain torch version at its main path's shapes, at
the CUDA file_batch of 64: the two log-mel kernels (each an in-block real
FFT on csrc/rfft.cuh), swin_block_fused at CLAP stages 1-3 (shifted and
not) and window_attention_fused at stage 4 (LN1, then the qkv and proj
3xTF32 GEMMs over token tiles around the per-window attention:
csrc/window_attn.cu), each
timed beside its plain version and its bound (the log-mel kernels also
beside a cuFFT composition of the same log-mel, as a yardstick). Then it
drives the ported paths through the public API,
FrechetAudioDistance(weights="random", device="cuda"):
- VGGish: scores two 16 kHz WAV corpora and checks the results;
- PANN: scores the same corpora with pann-16k, and a part of them with
  pann-8k and pann-32k (the resample path and the other two geometries);
- CLAP: scores two 48 kHz corpora (with a 12 s clip, truncated, and a
  0.5 s one), then the 16 kHz part (resampled as it is loaded), and holds
  card embeddings against the CPU's on the pipeline's resample path;
- Encodec, which has no hand kernel (its convolutions, GroupNorm and LSTM
  are cuDNN's): encodec-24k on 24 kHz mono corpora and encodec-48k on 48
  kHz stereo ones (8 sines and 8 noise clips of 10 s, a 4 s clip whose
  padded frames are masked, a 12 s clip that the batch skips), then
  encodec-48k with channels=1 on the 16 kHz part (mono duplicated to two
  channels, each resampled). Each holds card embeddings against the CPU's,
  scores 4 clips a side on both, and compares the LSTM module alone on the
  card and the CPU at 750 and 1500 steps: cuDNN must not run it in TF32.
The CLAP pair, the pann-32k pair, a VGGish pair (8 clips a side) and the
Encodec pairs are also scored on the CPU plain path: the card's FAD must
agree within 1e-3, absolute and relative.
Last, the mesh (parallel/). The machine has one card, so NCCL between cards
is not exercised; in its place:
(a) a one-rank NCCL group in this process runs make_sharded_score_step on
    full-width VGGish x300 over 64 + 61 clips of 10 s (held to the float64
    host epilogue of the same rows within 1e-3 relative; it must launch the
    VGGish kernel), and times frechet_distance_torch on the card (eigh and
    Newton-Schulz) beside the float64 host epilogue at d = 128, 512, 2048;
(b) two gloo ranks on the one card, started as two processes of this script
    (--mesh-rank) on one empty kernel build directory, score the VGGish and
    CLAP corpora with FrechetAudioDistance(mesh=...), host path and
    device_stats: both ranks must give the same score, within 1e-3 relative
    of the single-process card score, and each rank must launch its kernels;
(c) the CLI under torchrun with one process (--mesh --device-stats --json)
    on the VGGish pair must give the single-process device_stats score
    within 1e-6 relative.
Each path runs with all four launch counts set to 0 just before it and read
just after, so the counts show which kernels it went through: VGGish and
PANN launch only their own log-mel kernel; CLAP launches the PANN log-mel
kernel once per chunk, swin_block_fused exactly 10 times as often and
window_attention_fused 2 times; Encodec launches none of the four. The
`kernels` line gives each kernel's count on its main path (vggish,
pann-16k, clap) and the PANN kernel's count on every path that runs it
under "launches_by_path".
Any failure raises and the exit code is non-zero. It imports nothing of JAX.
Its processes all end before it does.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists the kernels with their launch counts, errors,
times per 64-clip chunk, bounds (with the peak rate each used:
`bound_flops_per_s`) and arithmetic (`arith`: "fp32 fft" or "3xtf32 mma").
Without CUDA, or outside a checkout of the repository, it exits non-zero and
prints no result.
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
# Swin kernels vs plain: float32 on both sides, outputs of order 1; only the
# summation orders differ.
SWIN_ATOL = 1e-4
CLAP_CLIPS = 16  # per corpus, 10 s at 48 kHz
CLAP_LONG_SECONDS = 12.0  # past CLAP's 10 s: truncated to the 1001-frame read window
# The peak rates of the H100 SXM: float32 outside the tensor cores; float32-
# accurate products on the tensor cores, 3xTF32 (dense TF32, 495 TFLOP/s, over
# the three products of the split); and device memory.
F32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12
FAD_DELTA = 1e-3  # card vs CPU plain path, absolute and relative
ENCODEC_CLIPS = 8  # per corpus, 10 s each
ENCODEC_SMALL_CLIPS = 4  # per side, for the CPU plain path's score
ENCODEC_MASKED_SECONDS = 4.0  # padded to 10 s; frames past 4 s are masked
ENCODEC_LONG_SECONDS = 12.0  # past Encodec's 10 s: the batch skips it
LSTM_STEPS = (750, 1500)  # the LSTM's steps on a 10 s clip at 24 and 48 kHz
MESH_RTOL = 1e-3  # mesh scores vs the single-process card scores; the score step vs float64
CLI_RTOL = 1e-6  # the one-rank CLI's device_stats score vs the single-process one
VGGISH_SCALE = 300.0  # random-weight VGGish rows are about 1e-3: x300 gives an O(1) FAD
STEP_FILES = 64  # files a side in the sharded score step, 10 s each
EPILOGUE_DIMS = (128, 512, 2048)  # VGGish / Encodec, CLAP, PANN widths


def bound(flops: float, nbytes: float, flops_per_s: float = F32_FLOPS):
    """(least ms, what bounds it): the larger of flops at the given peak (the
    float32 SIMT one unless the kernel's products run on the tensor cores) and
    bytes at the memory rate."""
    ops_ms, bytes_ms = flops / flops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def rate_name(flops_per_s: float) -> str:
    return {F32_FLOPS: "67 TFLOP/s fp32", TF32X3_FLOPS: "165 TFLOP/s 3xTF32"}[flops_per_s]


def logmel_flops(np, frames: int, window: int, n_fft: int, mel, magnitude: bool) -> float:
    """Operations of an FFT-based log-mel over the frames it needs: per frame
    the window product, a real FFT of n_fft points (2.5 n log2 n), the power
    of each bin (3; 4 with the square root of a magnitude), 2 for each
    nonzero mel tap, and the log of each mel bin."""
    bins = n_fft // 2 + 1
    per_frame = (window + 2.5 * n_fft * math.log2(n_fft) + (4 if magnitude else 3) * bins
                 + 2 * int(np.count_nonzero(mel)) + mel.shape[1])
    return frames * per_frame


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


def write_clap_corpora(root: Path, audio_io, np) -> tuple:
    """16 sines and 16 noise clips of 10 s at 48 kHz; the noise side also
    holds a 12 s clip and a 0.5 s one."""
    rng = np.random.default_rng(SEED + 2)
    sr = 48000
    bg, ev = root / "clap_bg", root / "clap_ev"
    bg.mkdir()
    ev.mkdir()
    t = np.arange(int(sr * CLIP_SECONDS)) / sr
    for i in range(CLAP_CLIPS):
        freq = 220.0 * 2 ** (i / 12)
        audio_io.write_wav(str(bg / f"sine{i:02d}.wav"), 0.5 * np.sin(2 * np.pi * freq * t), sr)
        audio_io.write_wav(str(ev / f"noise{i:02d}.wav"), rng.standard_normal(t.size) * 0.1, sr)
    audio_io.write_wav(str(ev / "long.wav"),
                       rng.standard_normal(int(sr * CLAP_LONG_SECONDS)) * 0.1, sr)
    audio_io.write_wav(str(ev / "short.wav"),
                       0.5 * np.sin(2 * np.pi * 440.0 * t[: int(sr * SHORT_SECONDS)]), sr)
    return str(bg), str(ev)


def write_encodec_corpora(root: Path, audio_io, np, sr: int, channels: int) -> tuple:
    """ENCODEC_CLIPS sines and noise clips of 10 s at sr (stereo: a second,
    different channel), a 4 s clip and a 12 s one on the noise side; and a
    part of each corpus, ENCODEC_SMALL_CLIPS a side, for the CPU scores."""
    rng = np.random.default_rng(SEED + sr)
    bg, ev = root / f"encodec{sr}_bg", root / f"encodec{sr}_ev"
    bg.mkdir()
    ev.mkdir()
    t = np.arange(int(sr * CLIP_SECONDS)) / sr

    def clip(n, freq=None):
        if freq is None:
            chans = [rng.standard_normal(n) * 0.1 for _ in range(channels)]
        else:
            chans = [0.5 * np.sin(2 * np.pi * freq * t[:n]),
                     0.3 * np.sin(2 * np.pi * 1.5 * freq * t[:n])][:channels]
        return chans[0] if channels == 1 else np.stack(chans, axis=1)

    for i in range(ENCODEC_CLIPS):
        audio_io.write_wav(str(bg / f"sine{i:02d}.wav"), clip(t.size, 220.0 * 2 ** (i / 12)), sr)
        audio_io.write_wav(str(ev / f"noise{i:02d}.wav"), clip(t.size), sr)
    audio_io.write_wav(str(ev / "masked.wav"), clip(int(sr * ENCODEC_MASKED_SECONDS)), sr)
    audio_io.write_wav(str(ev / "long.wav"), clip(int(sr * ENCODEC_LONG_SECONDS)), sr)
    small = []
    for src, prefix in ((bg, "sine"), (ev, "noise")):
        dst = root / f"{src.name}_small"
        dst.mkdir()
        for i in range(ENCODEC_SMALL_CLIPS):
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


def cufft_vggish_logmel(torch, fe, wave, mel, num_frames: int):
    """The VGGish log-mel composed from cuFFT and cuBLAS: torch.fft.rfft of the
    windowed 400-sample frames zero-padded to 512, magnitude, mel product,
    log. A yardstick for the FFT kernel's time only; the port never calls it."""
    need = (num_frames - 1) * fe.VGGISH_HOP + fe.VGGISH_WINDOW
    wave = torch.nn.functional.pad(wave, (0, max(0, need - wave.shape[1])))
    frames = wave[:, :need].unfold(1, fe.VGGISH_WINDOW, fe.VGGISH_HOP)
    window = torch.hann_window(fe.VGGISH_WINDOW, periodic=True, device=wave.device)
    magnitude = torch.fft.rfft(frames * window, n=fe.VGGISH_FFT).abs()
    return torch.log(torch.matmul(magnitude, mel) + fe.VGGISH_LOG_OFFSET)


def vggish_kernel_phase(torch, np, cuda_frontend, fe, batch: int) -> dict:
    """VGGish kernel vs plain at B = the CUDA default file_batch, T = 960
    frames (10 s clips, in their length bucket of 163840 samples), and a
    ragged T whose wave ends inside the last frame. Returns the 960-frame
    numbers, with its bound: logmel_flops with a 512-point FFT of a 400-sample
    frame and the HTK mel's nonzero taps, and as bytes the samples the frames
    read and the log-mel written. Also times cufft_vggish_logmel on the same
    inputs (printed, and as cufft_ms; not the library time, which needs one
    call)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(960, 163840), (RAGGED_FRAMES, (RAGGED_FRAMES - 1) * fe.VGGISH_HOP + 300)]
    mel = cuda_frontend._htk_mel_np()
    mel_dev = torch.from_numpy(mel).to(dev)
    max_err = 0.0
    rows = {}
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
        composed = cufft_vggish_logmel(torch, fe, wave, mel_dev, num_frames)
        check(bool(torch.isfinite(composed).all()), "cuFFT VGGish log-mel not finite")
        cufft_ms = cuda_ms(torch, lambda: cufft_vggish_logmel(torch, fe, wave, mel_dev, num_frames))
        flops = logmel_flops(np, batch * num_frames, fe.VGGISH_WINDOW, fe.VGGISH_FFT, mel, True)
        read = min(num_samples, (num_frames - 1) * fe.VGGISH_HOP + fe.VGGISH_WINDOW)
        nbytes = 4 * (batch * read + out.numel())
        bound_ms, bound_by = bound(flops, nbytes)
        rows[num_frames] = {"ms": kern, "plain_ms": plain, "bound_ms": bound_ms,
                            "bound_by": bound_by, "cufft_ms": cufft_ms}
        print(f"vggish logmel B={batch} T={num_frames} S={num_samples}: max_abs_err {err:.3e} "
              f"kernel {kern:.4f} ms ({runs[1]:.4f}, {runs[2]:.4f}) "
              f"plain {plain:.4f} ms ({runs[0]:.4f}, {runs[3]:.4f}) bound {bound_ms:.4f} ms "
              f"({bound_by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB); cuFFT + cuBLAS "
              f"composition (torch.fft.rfft, magnitude, mel matmul, log; a yardstick only) "
              f"{cufft_ms:.4f} ms")
    check(max_err <= LOGMEL_ATOL, f"VGGish kernel vs plain log-mel {max_err} > {LOGMEL_ATOL}")
    return {"max_abs_err": max_err, **rows[960]}


def cufft_logmel(torch, wave, mel, n_valid, n_fft: int, hop: int, num_frames: int):
    """The PANN log-mel composed from cuFFT and cuBLAS: torch.fft.rfft of the
    windowed frames, power, mel product, dB, mask. A yardstick for the FFT
    kernel's time only; the port never calls it."""
    frames = wave[:, : (num_frames - 1) * hop + n_fft].unfold(1, n_fft, hop)
    window = torch.hann_window(n_fft, periodic=True, device=wave.device)
    spectrum = torch.fft.rfft(frames * window)
    power = spectrum.real * spectrum.real + spectrum.imag * spectrum.imag
    log_mel = 10.0 * torch.log10(torch.clamp_min(torch.matmul(power, mel), 1e-10))
    keep = torch.arange(num_frames, device=wave.device)[None, :, None] < n_valid[:, None, None]
    return torch.where(keep, log_mel, 0.0)


def pann_kernel_phase(torch, np, cuda_pann_frontend, fe, batch: int) -> dict:
    """PANN kernel vs plain at all four geometries: B = the CUDA PANN
    file_batch, T = 1032 (10 s clips on their grid; the buffer is the grid's
    t*hop + n_fft samples) and T = 1001 at 48 kHz, with a ragged n_valid on
    some rows and one row of batch padding (n_valid 0). Returns the worst
    error and each geometry's numbers. The bound counts the frames below
    n_valid (the kernel skips tiles past it) in logmel_flops, with an n_fft
    FFT and the Slaney mel's nonzero taps, and as bytes the samples those
    frames read, n_valid and the whole log-mel written. Also times
    cufft_logmel on the same inputs (printed, not in the kernels line)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst, rows = 0.0, {}
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
        mel = cuda_pann_frontend._slaney_mel_np(sr)
        mel_dev = torch.from_numpy(np.ascontiguousarray(mel)).to(dev)
        composed = cufft_logmel(torch, wave, mel_dev, n_valid, n_fft, hop, num_frames)
        check(bool(torch.isfinite(composed).all()), f"cuFFT log-mel not finite at {sr} Hz")
        cufft_ms = cuda_ms(torch, lambda: cufft_logmel(torch, wave, mel_dev, n_valid, n_fft, hop,
                                                       num_frames))
        print(f"pann logmel {sr} Hz: cuFFT + cuBLAS composition (torch.fft.rfft, power, mel "
              f"matmul, dB; a yardstick only) {cufft_ms:.4f} ms")
        flops = logmel_flops(np, int(nv.sum()), n_fft, n_fft, mel, False)
        read = sum(min(wave.shape[1], (int(v) - 1) * hop + n_fft) for v in nv if v)
        nbytes = 4 * (read + batch + out.numel())
        bound_ms, bound_by = bound(flops, nbytes)
        rows[sr] = {"ms": kern, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
                    "cufft_ms": cufft_ms}
        print(f"pann logmel {sr} Hz (n_fft {n_fft}, hop {hop}) B={batch} T={num_frames}: "
              f"max power err / file max {err:.3e}, kernel {kern:.4f} ms "
              f"({runs[1]:.4f}, {runs[2]:.4f}) plain {plain:.4f} ms ({runs[0]:.4f}, {runs[3]:.4f}) "
              f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)")
        check(err <= PANN_POWER_RTOL, f"PANN kernel vs plain at {sr} Hz: {err} > {PANN_POWER_RTOL}")
    return {"max_abs_err": worst, "rows": rows}


def swin_layers(clap) -> dict:
    """(stage, shifted) -> the layer's kernel, width, heads, windows per image,
    mask and launches per forward, read from the blocks of the CLAP module
    that runs the main path (its parameters stay unset: only the layout is
    read)."""
    layers = {}
    for stage, module in enumerate(clap.CLAP().stages):
        for block in module.blocks:
            layer = layers.setdefault((stage, bool(block.shift)), {
                "kernel": "swin_block_fused" if block.fused_block else "window_attention_fused",
                "c": block.qkv.w.shape[0], "heads": block.heads, "nw": block.num_windows,
                "mask": block.attn_mask, "per_forward": 0,
            })
            layer["per_forward"] += 1
    return layers


def swin_kernel_phase(torch, np, window_attn, clap, batch: int) -> dict:
    """Both Swin kernels vs plain at every layer shape of one CLAP forward at
    B = the CUDA file_batch: swin_block_fused at stages 1-3 (shifted and not),
    window_attention_fused at stage 4. Inputs are scaled as in the tests
    (x 0.5, weights 0.05, biases 0.01). Per kernel: the worst error, and the
    time, plain time and bound of one 64-clip chunk (each shape's launch
    times its launches per forward). The bound counts 24*M*C^2 + 4*M*64*C
    flops for the block and 8*M*C^2 + 4*M*64*C for the attention half (M =
    tokens) at the 3xTF32 rate (both kernels form every product so), and x,
    out, the weights, bias and mask as bytes; the bound at the float32 SIMT
    rate (67 TFLOP/s), which a kernel on FMA lanes would face, is printed
    beside it."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n = clap.WINDOW_SIZE ** 2

    def normal(shape, scale, offset=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + offset

    summary = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "bound_ms_fp32": 0.0, "flops": 0.0, "bytes": 0.0, "shapes": []}
               for name in ("swin_block_fused", "window_attention_fused")}
    for (stage, shifted), layer in sorted(swin_layers(clap).items()):
        name, c, heads, nw = layer["kernel"], layer["c"], layer["heads"], layer["nw"]
        per_forward = layer["per_forward"]
        table = normal(((2 * clap.WINDOW_SIZE - 1) ** 2, heads), 0.1)
        index = torch.from_numpy(clap._relative_position_index(clap.WINDOW_SIZE).reshape(-1))
        bias = table[index.long().to(dev)].reshape(n, n, heads).permute(2, 0, 1).contiguous()
        mask = layer["mask"].to(dev)
        args = dict(
            x_windows=normal((batch * nw, n, c), 0.5),
            w_qkv=normal((c, 3 * c), 0.05), b_qkv=normal((3 * c,), 0.01),
            w_proj=normal((c, c), 0.05), b_proj=normal((c,), 0.01), bias=bias, mask=mask,
            gamma1=normal((c,), 0.1, 1.0), beta1=normal((c,), 0.1),
        )
        if name == "swin_block_fused":
            args.update(gamma2=normal((c,), 0.1, 1.0), beta2=normal((c,), 0.1),
                        w_fc1=normal((c, 4 * c), 0.05), b_fc1=normal((4 * c,), 0.01),
                        w_fc2=normal((4 * c, c), 0.05), b_fc2=normal((c,), 0.01))
        kernel = getattr(window_attn, name)
        plain = getattr(window_attn, f"{name}_reference")
        out = kernel(**args, heads=heads, num_windows=nw)
        ref = plain(**args, heads=heads, num_windows=nw)
        torch.cuda.synchronize()
        check(out.shape == ref.shape == args["x_windows"].shape, f"{name} shape {out.shape}")
        check(bool(torch.isfinite(out).all()), f"{name} output not finite at stage {stage + 1}")
        err = float((out - ref).abs().max())
        kern_ms, plain_ms, runs = timed_pair(
            torch, lambda: kernel(**args, heads=heads, num_windows=nw),
            lambda: plain(**args, heads=heads, num_windows=nw), iters=10,
        )
        m = batch * nw * n
        c2 = 24 if name == "swin_block_fused" else 8
        flops = c2 * m * c * c + 4 * m * n * c
        nbytes = 4 * (2 * args["x_windows"].numel()
                      + sum(t.numel() for k, t in args.items() if k != "x_windows"))
        bound_ms, bound_by = bound(flops, nbytes, TF32X3_FLOPS)
        bound_ms_fp32 = bound(flops, nbytes)[0]
        print(f"{name} stage {stage + 1} (C {c}, {heads} heads, nW {nw}, "
              f"{'shifted' if shifted else 'unshifted'}) B={batch}: max_abs_err {err:.3e}, "
              f"kernel {kern_ms:.4f} ms ({runs[1]:.4f}, {runs[2]:.4f}) plain {plain_ms:.4f} ms "
              f"({runs[0]:.4f}, {runs[3]:.4f}) bound {bound_ms:.4f} ms ({bound_by} at "
              f"{rate_name(TF32X3_FLOPS)}; {bound_ms_fp32:.4f} ms at {rate_name(F32_FLOPS)}; "
              f"{flops / 1e9:.2f} GFLOP, {flops / kern_ms / 1e9:.2f} TFLOP/s), "
              f"{per_forward} per forward")
        check(err <= SWIN_ATOL, f"{name} vs plain at stage {stage + 1}: {err} > {SWIN_ATOL}")
        row = summary[name]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        for key, value in (("ms", kern_ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                           ("bound_ms_fp32", bound_ms_fp32), ("flops", flops), ("bytes", nbytes)):
            row[key] += per_forward * value
        row["shapes"].append({"stage": stage + 1, "C": c, "heads": heads, "shifted": shifted,
                              "per_forward": per_forward, "ms": kern_ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_ms_fp32": bound_ms_fp32,
                              "max_abs_err": err})
        del args, out, ref
    for row in summary.values():
        row["bound_by"] = bound(row.pop("flops"), row.pop("bytes"), TF32X3_FLOPS)[1]
    return summary


def run_scores(torch, fad, calls, launches, kernel, label: str) -> dict:
    """fad.score for each (name, args, kwargs); each call must raise the count
    of `kernel` (None: a path that has no kernel of its own)."""
    scores = {}
    for name, args, kwargs in calls:
        before = launches.read()[kernel] if kernel else 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scores[name] = fad.score(*args, **kwargs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        after = launches.read()[kernel] if kernel else 0
        print(f"{label} score {name}: {scores[name]!r} in {time.perf_counter() - t0:.3f} s, "
              f"peak {peak / 2**30:.3f} GiB, {kernel} launches {before} -> {after}")
        check(kernel is None or after > before, f"{label} score {name} did not launch {kernel}")
        check(scores[name] != -1 and math.isfinite(scores[name]),
              f"{label} score {name} = {scores[name]}")
    return scores


def run_path(torch, fad, calls, launches, kernel, label: str):
    """One path: all four launch counts set to 0 just before it and read just
    after. Returns (scores, the counts)."""
    launches.zero()
    scores = run_scores(torch, fad, calls, launches, kernel, label)
    counts = launches.read()
    print(f"{label} path launches: {counts}")
    return scores, counts


def check_only(counts: dict, kernel: str, label: str) -> None:
    """A VGGish or PANN path launched its own kernel and no other."""
    stray = {k: v for k, v in counts.items() if k != kernel and v}
    check(counts[kernel] > 0 and not stray, f"the {label} path launched {counts}")


def check_none(counts: dict, label: str) -> None:
    """An Encodec path launched none of the four kernels."""
    check(not any(counts.values()), f"the {label} path launched {counts}")


def check_clap_counts(counts: dict, label: str) -> None:
    """One log-mel launch per chunk, and per chunk 10 swin_block_fused and 2
    window_attention_fused launches (stages 1-3 and stage 4)."""
    chunks = counts["fused_pann_logmel"]
    check(chunks > 0, f"the {label} path launched no log-mel kernel")
    check(counts["swin_block_fused"] == 10 * chunks,
          f"{label}: {counts['swin_block_fused']} swin_block_fused launches for {chunks} chunks")
    check(counts["window_attention_fused"] == 2 * chunks,
          f"{label}: {counts['window_attention_fused']} window_attention_fused launches "
          f"for {chunks} chunks")
    check(counts["fused_vggish_logmel"] == 0, f"the {label} path launched the VGGish kernel")


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


def fad_delta(score_on_card: float, cpu_fad, bg: str, ev: str, label: str) -> None:
    """The pair scored on the CPU plain path (the plain versions of every
    kernel, CPU convolutions) against the card's score: |delta| <= 1e-3 both
    absolute and relative, since random-weight scores are small."""
    t0 = time.perf_counter()
    on_cpu = cpu_fad.score(bg, ev)
    check(on_cpu != -1 and math.isfinite(on_cpu), f"{label} CPU score = {on_cpu}")
    delta = abs(score_on_card - on_cpu)
    rel = delta / abs(on_cpu)
    print(f"{label} FAD card {score_on_card!r} vs CPU plain path {on_cpu!r} "
          f"({time.perf_counter() - t0:.1f} s): |delta| {delta:.3e} absolute, {rel:.3e} relative")
    check(delta <= FAD_DELTA and rel <= FAD_DELTA,
          f"{label} card vs CPU FAD: {delta} absolute, {rel} relative > {FAD_DELTA}")


def lstm_card_vs_cpu(torch, fad, cpu_fad, label: str) -> None:
    """The Encodec LSTM module (two layers, the skip) alone, on the card and
    on the CPU with the same weights, at LSTM_STEPS steps: its max abs
    error with TF32 off, as the public API sets it, and, for contrast, with
    cuDNN's TF32 on. The error with TF32 off must stay within
    EMBEDDING_ATOL."""
    gen = torch.Generator().manual_seed(SEED + 5)
    for steps in LSTM_STEPS:
        x = torch.randn((4, fad.model.lstm.hidden_size, steps), generator=gen)
        with torch.inference_mode():
            on_cpu = cpu_fad.model.lstm(x)
            on_card = {}
            for tf32 in (False, True):
                torch.backends.cudnn.allow_tf32 = tf32
                try:
                    on_card[tf32] = fad.model.lstm(x.to("cuda")).cpu()
                finally:
                    torch.backends.cudnn.allow_tf32 = False
        err = {tf32: float((out - on_cpu).abs().max()) for tf32, out in on_card.items()}
        print(f"{label} LSTM card vs CPU, T={steps}: max_abs_err {err[False]:.3e} "
              f"with TF32 off (cuDNN TF32 on: {err[True]:.3e})")
        check(err[False] <= EMBEDDING_ATOL,
              f"{label} LSTM card vs CPU at T={steps}: {err[False]} > {EMBEDDING_ATOL}")


def timed_warmup(torch, fad, label: str, batch: int) -> None:
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fad.warmup()
    torch.cuda.synchronize()
    print(f"{label} warmup ({batch} x 10 s clips, f32 + int16 wire, host + device "
          f"stats): {time.perf_counter() - t0:.2f} s, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def score_step_phase(torch, np, launches, stats_ops, embed, fe, mesh, model) -> dict:
    """(a) make_sharded_score_step on full-width VGGish x300 over 10 s clips
    (STEP_FILES a side, three ev files masked), against the float64 host
    epilogue of the same rows taken on the card. The step's launch counts
    are read just after it."""
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    samples = int(16000 * CLIP_SECONDS)
    patches = fe.vggish_num_patches(samples)
    t = torch.arange(samples, device=dev) / 16000.0
    freqs = 220.0 * 2 ** (torch.arange(STEP_FILES, device=dev)[:, None] / 12.0)
    rows_bg = 0.5 * torch.sin(2 * math.pi * freqs * t)
    rows_ev = torch.randn((STEP_FILES, samples), generator=gen, device=dev) * 0.1
    mask_bg = torch.ones(STEP_FILES, device=dev)
    mask_ev = torch.ones(STEP_FILES, device=dev)
    mask_ev[-3:] = 0.0

    def model_fn(wave):
        mel = fe.vggish_patches_batch(wave, patches)
        emb = model(mel.reshape(-1, fe.VGGISH_PATCH_FRAMES, fe.VGGISH_MEL_BINS))
        return emb.reshape(wave.shape[0], patches, -1) * VGGISH_SCALE

    step = embed.make_sharded_score_step(mesh, model_fn)
    launches.zero()
    t0 = time.perf_counter()
    fused = float(step(rows_bg, mask_bg, rows_ev, mask_ev))
    seconds = time.perf_counter() - t0
    counts = launches.read()
    with torch.inference_mode():
        e1 = model_fn(rows_bg).reshape(-1, 128).double().cpu().numpy()
        e2 = model_fn(rows_ev[:-3]).reshape(-1, 128).double().cpu().numpy()
    host = stats_ops.frechet_distance_eigh_np(
        e1.mean(0), np.cov(e1, rowvar=False), e2.mean(0), np.cov(e2, rowvar=False))
    rel = abs(fused - host) / abs(host)
    print(f"mesh (a) sharded score step, a group of {mesh.size} on {dev}: VGGish x"
          f"{VGGISH_SCALE:g} on {STEP_FILES} + {STEP_FILES - 3} clips of {CLIP_SECONDS:g} s "
          f"({len(e1)} + {len(e2)} rows): FAD {fused!r} on the card vs float64 host {host!r}, "
          f"relative {rel:.3e}; {seconds:.3f} s; launches {counts}")
    return {"fad": fused, "host": host, "rel": rel, "seconds": seconds, "launches": counts}


def epilogue_phase(torch, np, stats_ops, embed, mesh) -> dict:
    """frechet_distance_torch on the card (eigh and Newton-Schulz, float32)
    beside the float64 host epilogue (frechet_distance_eigh_np, the default
    of score()) at each width of EPILOGUE_DIMS, on covariances of 4d
    samples (the second 1.5x wider and shifted by 0.5: an O(d) FAD); and
    the time of merge_stats, the merge of a directory's streamed
    statistics, on the mesh's group."""
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    rows = {}
    for d in EPILOGUE_DIMS:
        x1 = torch.randn((4 * d, d), generator=gen, device=dev, dtype=torch.float64)
        x2 = torch.randn((4 * d, d), generator=gen, device=dev, dtype=torch.float64) * 1.5 + 0.5
        f64 = [a.cpu().numpy() for a in (x1.mean(0), torch.cov(x1.T), x2.mean(0), torch.cov(x2.T))]
        f32 = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in f64]
        t0 = time.perf_counter()
        host = stats_ops.frechet_distance_eigh_np(*f64)
        host_ms = (time.perf_counter() - t0) * 1e3
        state = stats_ops.init_update_stats(x1.float(), torch.ones(4 * d, device=dev))
        row = {"host_ms": host_ms, "host": host,
               "merge_ms": cuda_ms(torch, lambda: embed.merge_stats(mesh, state, d), 10, 2)}
        for method in stats_ops.FRECHET_METHODS:
            value = float(stats_ops.frechet_distance_torch(*f32, method=method))
            ms = cuda_ms(torch, lambda: stats_ops.frechet_distance_torch(*f32, method=method),
                         iters=5, warmup=1)
            row[method] = {"ms": ms, "rel": abs(value - host) / abs(host)}
        # The eigh route in float64 on the card, and the float32 eigenvalues
        # of Σ₂ on the card against numpy's float64 ones: where the float32
        # route's error comes from.
        d64 = [torch.from_numpy(a).to(dev) for a in f64]
        value = float(stats_ops.frechet_distance_torch(*d64))
        row["eigh_float64"] = {
            "ms": cuda_ms(torch, lambda: stats_ops.frechet_distance_torch(*d64), iters=5, warmup=1),
            "rel": abs(value - host) / abs(host)}
        w64 = np.linalg.eigvalsh(f64[3])
        w32 = torch.linalg.eigvalsh(f32[3]).double().cpu().numpy()
        row["eigvalsh_float32_err"] = float(np.abs(w32 - w64).max() / np.abs(w64).max())
        rows[d] = row
        print(f"mesh (a) epilogue d={d}: card eigh {row['eigh']['ms']:.3f} ms (relative "
              f"{row['eigh']['rel']:.3e}), card Newton-Schulz {row['newton_schulz']['ms']:.3f} ms "
              f"(relative {row['newton_schulz']['rel']:.3e}), host float64 eigh {host_ms:.3f} ms "
              f"(FAD {host:.6g}); merge_stats {row['merge_ms']:.3f} ms; card eigh in float64 "
              f"{row['eigh_float64']['ms']:.3f} ms (relative {row['eigh_float64']['rel']:.3e}); "
              f"float32 eigvalsh of the second covariance: max error / max eigenvalue "
              f"{row['eigvalsh_float32_err']:.3e} "
              f"({torch.backends.cuda.preferred_linalg_library()})")
    return rows


def mesh_rank_main(argv) -> int:
    """(b) one rank of the two-rank gloo group: FrechetAudioDistance(mesh=...)
    on VGGish and CLAP, host path and device_stats, each model with every
    launch count set to 0 just before it and read just after. Writes its
    scores and counts as JSON."""
    import torch

    rank, port, cfg_path = int(argv[0]), int(argv[1]), argv[2]
    sys.path.insert(0, str(ROOT))
    from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance
    from frechet_audio_distance_exported_tpu_torch.ops import launches
    from frechet_audio_distance_exported_tpu_torch.parallel import mesh as mesh_mod

    cfg = json.loads(Path(cfg_path).read_text())
    dev = torch.device(cfg["device"])
    mesh_mod.initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo", device=dev,
                                    timeout_s=600)
    mesh = mesh_mod.data_mesh(device=dev)
    out = {"rank": rank, "device": str(mesh.device)}
    for model, (bg, ev) in cfg["pairs"].items():
        fad = FrechetAudioDistance(model_name=model, weights="random", seed=SEED,
                                   ckpt_dir=cfg["ck"], device=dev.type, mesh=mesh)
        launches.zero()
        t0 = time.perf_counter()
        scores = {"bg_ev": fad.score(bg, ev),
                  "bg_ev_device_stats": fad.score(bg, ev, device_stats=True)}
        out[model] = {"scores": scores, "launches": launches.read(),
                      "seconds": time.perf_counter() - t0}
        del fad
    Path(cfg["out"].format(rank=rank)).write_text(json.dumps(out))
    torch.distributed.destroy_process_group()
    return 0


def two_rank_phase(tmp: Path, dev: str, pairs: dict) -> list:
    """(b) starts mesh_rank_main twice, both ranks on one device and, at
    first, on one empty kernel build directory (both build it at once).
    Returns each rank's results."""
    cfg = {"device": dev, "pairs": pairs, "ck": str(tmp / "ck"),
           "out": str(tmp / "mesh_rank{rank}.json")}
    (tmp / "mesh_cfg.json").write_text(json.dumps(cfg))
    build_dir = tmp / "mesh_build"
    build_dir.mkdir()
    env = dict(os.environ, FAD_TPU_TORCH_BUILD_DIR=str(build_dir))
    port = free_port()
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank", str(rank),
                          str(port), str(tmp / "mesh_cfg.json")], env=env, cwd=str(ROOT),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)
    ]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.strip().splitlines()[-30:])
        check(p.returncode == 0, f"mesh (b) rank {rank} exited {p.returncode}:\n{tail}")
    built = sorted(f.name for f in build_dir.iterdir())
    print(f"mesh (b) two gloo ranks on {dev}: {time.perf_counter() - t0:.1f} s with the kernel "
          f"build from an empty directory (now {built})")
    return [json.loads(Path(cfg["out"].format(rank=r)).read_text()) for r in (0, 1)]


def cli_phase(tmp: Path, bg: str, ev: str, dev: str) -> float:
    """(c) the CLI under torchrun with one process: --mesh --device-stats
    --json on a VGGish pair; returns its score."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="4")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
           "--master-port", str(free_port()), "-m", "frechet_audio_distance_exported_tpu_torch",
           bg, ev, "--model", "vggish", "--weights", "random", "--ckpt-dir", str(tmp / "ck"),
           "--device", dev, "--mesh", "--device-stats", "--json"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=str(ROOT), env=env)
    check(r.returncode == 0, f"mesh (c) CLI exited {r.returncode}:\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"mesh (c) CLI under torchrun, one rank: {rec} in {time.perf_counter() - t0:.1f} s")
    return rec["fad"]


def main() -> int:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import frechet_audio_distance_exported_tpu_torch as port
    from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance
    from frechet_audio_distance_exported_tpu_torch.config import set_exact_float32
    from frechet_audio_distance_exported_tpu_torch.models import clap
    from frechet_audio_distance_exported_tpu_torch.ops import _build, cuda_frontend, cuda_pann_frontend
    from frechet_audio_distance_exported_tpu_torch.ops import frontends as fe
    from frechet_audio_distance_exported_tpu_torch.ops import launches, window_attn
    from frechet_audio_distance_exported_tpu_torch.ops import stats as stats_ops
    from frechet_audio_distance_exported_tpu_torch.parallel import embed
    from frechet_audio_distance_exported_tpu_torch.parallel import mesh as mesh_mod
    from frechet_audio_distance_exported_tpu_torch.pipeline import (
        DEFAULT_FILE_BATCH,
        ENCODEC_FILE_BATCH,
    )
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

    # 2. Build every kernel from this checkout's sources.
    build_phase(torch, _build)

    # 3. Each kernel against its plain version at its main path's shapes
    #    (exact float32 on both sides: TF32 off, as the public API sets it).
    set_exact_float32()
    batch = DEFAULT_FILE_BATCH["cuda"]
    vggish = vggish_kernel_phase(torch, np, cuda_frontend, fe, batch)
    pann = pann_kernel_phase(torch, np, cuda_pann_frontend, fe, batch)
    swin = swin_kernel_phase(torch, np, window_attn, clap, batch)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        bg, ev, bg_small, ev_small = write_corpora(tmp, audio_io, np)
        clap_bg, clap_ev = write_clap_corpora(tmp, audio_io, np)

        def pair_calls(bg_dir, ev_dir):
            return [
                ("bg_ev", (bg_dir, ev_dir), {}),
                ("bg_bg", (bg_dir, bg_dir), {}),
                ("bg_ev_device_stats", (bg_dir, ev_dir), {"device_stats": True}),
            ]

        def calculator(model, device="cuda", channels=1):
            return FrechetAudioDistance(
                model_name=model, weights="random", seed=SEED, ckpt_dir=str(tmp / "ck"),
                device=device, channels=channels,
            )

        def clips16k():
            return [audio_io.load_audio(os.path.join(d, f), 16000, 1)
                    for d, f in ((bg, "sine05.wav"), (ev, "noise05.wav"))]

        # 4. The VGGish path through the public API.
        fad = calculator("vggish")
        check(torch.backends.cuda.matmul.allow_tf32 is False, "matmul TF32 is on")
        check(torch.backends.cudnn.allow_tf32 is False, "cuDNN TF32 is on")
        check(fad.pipeline.file_batch == batch, "file_batch is not the CUDA default")
        timed_warmup(torch, fad, "vggish", batch)
        scores, counts = run_path(
            torch, fad, pair_calls(bg, ev), launches, "fused_vggish_logmel", "vggish"
        )
        check_only(counts, "fused_vggish_logmel", "vggish")
        vggish_launches = counts["fused_vggish_logmel"]
        check_pair_scores(scores, "vggish")
        single_scores = {"vggish": scores}
        cpu_vggish = calculator("vggish", "cpu")
        card_vs_cpu(np, fad, cpu_vggish, clips16k(), 16000, (20, 128), "vggish")
        small = fad.score(bg_small, ev_small)
        check(small != -1 and math.isfinite(small), f"vggish score(bg_small, ev_small) = {small}")
        fad_delta(small, cpu_vggish, bg_small, ev_small, "vggish")
        del fad

        # 5. The PANN paths through the public API: pann-16k on the whole
        #    corpora (the 1000 s clip runs alone, on the long-file path),
        #    then pann-8k and pann-32k on a part of them, each a path of its
        #    own with the counts set to 0 just before it.
        fad = calculator("pann-16k")
        check(fad.pipeline.file_batch == batch, "PANN file_batch is not the CUDA default")
        timed_warmup(torch, fad, "pann-16k", batch)
        others = {name: calculator(name) for name in ("pann-8k", "pann-32k")}
        pann_launches = {}
        scores, counts = run_path(
            torch, fad, pair_calls(bg, ev), launches, "fused_pann_logmel", "pann-16k"
        )
        check_only(counts, "fused_pann_logmel", "pann-16k")
        pann_launches["pann-16k"] = counts["fused_pann_logmel"]
        check_pair_scores(scores, "pann-16k")
        small_scores = {}
        for name, other in others.items():
            small_scores[name], counts = run_path(
                torch, other, [("bg_ev", (bg_small, ev_small), {})], launches,
                "fused_pann_logmel", name)
            check_only(counts, "fused_pann_logmel", name)
            pann_launches[name] = counts["fused_pann_logmel"]
        card_vs_cpu(np, fad, calculator("pann-16k", "cpu"), clips16k(), 16000, (2, 2048),
                    "pann-16k")
        fad_delta(small_scores["pann-32k"]["bg_ev"], calculator("pann-32k", "cpu"), bg_small,
                  ev_small, "pann-32k")
        del fad, others

        # 6. The CLAP path through the public API: the 48 kHz corpora (the
        #    main path), then the 16 kHz part, resampled as it is loaded;
        #    card vs CPU on the pipeline's own resample path.
        fad = calculator("clap")
        check(fad.pipeline.file_batch == batch, "CLAP file_batch is not the CUDA default")
        timed_warmup(torch, fad, "clap", batch)
        scores, counts = run_path(
            torch, fad, pair_calls(clap_bg, clap_ev), launches, "swin_block_fused", "clap"
        )
        check_clap_counts(counts, "clap")
        clap_launches = counts
        pann_launches["clap"] = counts["fused_pann_logmel"]
        check_pair_scores(scores, "clap")
        single_scores["clap"] = scores
        _, counts = run_path(torch, fad, [("bg_ev", (bg_small, ev_small), {})], launches,
                             "swin_block_fused", "clap 16 kHz")
        check_clap_counts(counts, "clap 16 kHz")
        cpu_clap = calculator("clap", "cpu")
        card_vs_cpu(np, fad, cpu_clap, clips16k(), 16000, (2, 512), "clap")
        fad_delta(scores["bg_ev"], cpu_clap, clap_bg, clap_ev, "clap")
        del fad, cpu_clap

        # 7. The Encodec paths through the public API. They have no hand
        #    kernel, so all four counts stay 0. encodec-24k on mono 24 kHz
        #    corpora, encodec-48k on stereo 48 kHz ones (channels=2), each
        #    a path of its own; then encodec-48k with channels=1 on the
        #    16 kHz part: mono duplicated to two channels, each resampled.
        for model, sr, channels in (("encodec-24k", 24000, 1), ("encodec-48k", 48000, 2)):
            e_bg, e_ev, e_bg_small, e_ev_small = write_encodec_corpora(
                tmp, audio_io, np, sr, channels)
            fad = calculator(model, channels=channels)
            check(fad.pipeline.file_batch == ENCODEC_FILE_BATCH["cuda"],
                  f"{model} file_batch is not the CUDA Encodec default")
            timed_warmup(torch, fad, model, fad.pipeline.file_batch)
            scores, counts = run_path(torch, fad, pair_calls(e_bg, e_ev), launches, None, model)
            check_none(counts, model)
            check_pair_scores(scores, model)
            cpu_fad = calculator(model, "cpu", channels)
            clips = [audio_io.load_audio(os.path.join(d, f), sr, channels)
                     for d, f in ((e_bg, "sine05.wav"), (e_ev, "masked.wav"))]
            frames = (int(sr * CLIP_SECONDS) + int(sr * ENCODEC_MASKED_SECONDS)) // 320
            card_vs_cpu(np, fad, cpu_fad, clips, sr, (frames, 128), model)
            small = fad.score(e_bg_small, e_ev_small)
            check(small != -1 and math.isfinite(small), f"{model} score(small pair) = {small}")
            fad_delta(small, cpu_fad, e_bg_small, e_ev_small, model)
            lstm_card_vs_cpu(torch, fad, cpu_fad, model)
            del fad, cpu_fad
        fad = calculator("encodec-48k", channels=1)
        _, counts = run_path(torch, fad, [("bg_ev", (bg_small, ev_small), {})], launches, None,
                             "encodec-48k 16 kHz")
        check_none(counts, "encodec-48k 16 kHz")
        card_vs_cpu(np, fad, calculator("encodec-48k", "cpu", 1), clips16k(), 16000,
                    (2 * 48000 * int(CLIP_SECONDS) // 320, 128), "encodec-48k 16 kHz")
        del fad

        # 8. The mesh (parallel/), on this one card. NCCL between cards is
        #    not exercised: the machine has one.
        print("mesh: NCCL across two or more cards is not exercised here (the machine has "
              f"{torch.cuda.device_count()} card); a one-rank NCCL group and two gloo ranks on "
              "one card stand in")
        #    (a) A one-rank NCCL group in this process: the sharded score step
        #        and the on-device epilogue's times.
        mesh_mod.initialize_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl",
                                        device="cuda:0")
        try:
            mesh = mesh_mod.data_mesh()
            check(dist.get_backend() == "nccl" and (mesh.rank, mesh.size) == (0, 1),
                  f"mesh (a): {mesh}")
            step = score_step_phase(torch, np, launches, stats_ops, embed, fe, mesh,
                                    calculator("vggish").model)
            check(step["rel"] <= MESH_RTOL,
                  f"mesh (a) score step vs float64 host: {step['rel']} > {MESH_RTOL}")
            check_only(step["launches"], "fused_vggish_logmel", "mesh (a) score step")
            epilogue = epilogue_phase(torch, np, stats_ops, embed, mesh)
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        #    (b) Two gloo ranks on this card, started as two processes, on
        #        the VGGish and CLAP corpora: each rank's counts set to 0 just
        #        before each model and read just after, in the rank.
        ranks = two_rank_phase(tmp, "cuda:0", {"vggish": (bg, ev), "clap": (clap_bg, clap_ev)})
        for model in ("vggish", "clap"):
            for mode in ("bg_ev", "bg_ev_device_stats"):
                s0, s1 = (r[model]["scores"][mode] for r in ranks)
                ref = single_scores[model][mode]
                rel = abs(s0 - ref) / abs(ref)
                print(f"mesh (b) {model} {mode}: rank 0 {s0!r}, rank 1 {s1!r}; single process "
                      f"{ref!r}, relative difference {rel:.3e}")
                check(s0 == s1, f"mesh (b) {model} {mode}: the ranks disagree: {s0} vs {s1}")
                check(s0 != -1 and rel <= MESH_RTOL,
                      f"mesh (b) {model} {mode}: {s0} vs single process {ref}")
            for r in ranks:
                label = f"mesh (b) rank {r['rank']} {model}"
                print(f"{label}: {r[model]['seconds']:.1f} s, launches {r[model]['launches']}")
                if model == "vggish":
                    check_only(r[model]["launches"], "fused_vggish_logmel", label)
                else:
                    check_clap_counts(r[model]["launches"], label)
        #    (c) The CLI under torchrun, one process, on the VGGish pair.
        cli = cli_phase(tmp, bg, ev, "cuda")
        ref = single_scores["vggish"]["bg_ev_device_stats"]
        rel = abs(cli - ref) / abs(ref)
        print(f"mesh (c) CLI --mesh --device-stats {cli!r} vs single process {ref!r}: "
              f"relative {rel:.3e}")
        check(rel <= CLI_RTOL, f"mesh (c) CLI vs single process: {rel} > {CLI_RTOL}")
        print(json.dumps({"mesh": {
            "score_step": step, "epilogue": epilogue, "cli": {"fad": cli, "rel": rel},
            "two_ranks": {m: {"scores": [r[m]["scores"] for r in ranks],
                              "single": single_scores[m],
                              "launches": [r[m]["launches"] for r in ranks]}
                          for m in ("vggish", "clap")},
        }}))

    print(json.dumps({"kernels": [
        {
            "name": "fused_vggish_logmel",
            "route": "cuda",
            "source": "frechet_audio_distance_exported_tpu_torch/csrc/vggish_logmel.cu",
            "replaces": "frechet_audio_distance_exported_tpu/ops/pallas_frontend.py:83",
            "launches": vggish_launches,
            "max_abs_err": vggish["max_abs_err"],
            "err_of": "log-mel, absolute",
            "ms": vggish["ms"],
            "plain_ms": vggish["plain_ms"],
            "bound_ms": vggish["bound_ms"],
            "bound_by": vggish["bound_by"],
            "cufft_ms": vggish["cufft_ms"],
            "library_ms": None,
            "arith": "fp32 fft",
            "bound_flops_per_s": F32_FLOPS,
            "at": "64 files x 960 frames",
        },
        {
            "name": "fused_pann_logmel",
            "route": "cuda",
            "source": "frechet_audio_distance_exported_tpu_torch/csrc/pann_logmel.cu",
            "replaces": "frechet_audio_distance_exported_tpu/ops/pallas_frontend.py:185",
            "launches": pann_launches["pann-16k"],
            "launches_by_path": pann_launches,
            "max_abs_err": pann["max_abs_err"],
            "err_of": "linear mel power, relative to each file's largest",
            **pann["rows"][16000],
            "library_ms": None,
            "arith": "fp32 fft",
            "bound_flops_per_s": F32_FLOPS,
            "at": "pann-16k, 64 files x 1032 frames",
            "by_rate": pann["rows"],
        },
        *(
            {
                "name": name,
                "route": "cuda",
                "source": "frechet_audio_distance_exported_tpu_torch/csrc/window_attn.cu",
                "replaces": f"frechet_audio_distance_exported_tpu/ops/pallas_window_attn.py:{line}",
                "launches": clap_launches[name],
                "max_abs_err": swin[name]["max_abs_err"],
                "err_of": "block output, absolute",
                "ms": swin[name]["ms"],
                "plain_ms": swin[name]["plain_ms"],
                "bound_ms": swin[name]["bound_ms"],
                "bound_by": swin[name]["bound_by"],
                "bound_ms_fp32": swin[name]["bound_ms_fp32"],
                "library_ms": None,
                "arith": "3xtf32 mma",
                "bound_flops_per_s": TF32X3_FLOPS,
                "at": "one 64-clip CLAP chunk: every launch of a forward",
                "shapes": swin[name]["shapes"],
            }
            for name, line in (("swin_block_fused", 152), ("window_attention_fused", 217))
        ),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(sys.argv[2:]))
    sys.exit(main())
