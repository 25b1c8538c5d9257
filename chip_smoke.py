"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (four, bf16 instances of the two Swin
kernels, and the GroupNorm(1, C) pair in float32 and bf16) from the sources
in this checkout and checks each against its plain torch version at its
main path's shapes, at the CUDA file_batch of 64: the two log-mel kernels
(each an in-block real FFT on csrc/rfft.cuh), swin_block_fused at CLAP stages 1-3 (shifted and
not) and window_attention_fused at stage 4 (csrc/window_attn.cu: the
weights split once a call, then 3xTF32 wgmma GEMMs over token tiles, fed
by TMA, with the LayerNorm applied on load, around the per-window
attention), each
timed beside its plain version and its bound (the log-mel kernels also
beside a cuFFT composition of the same log-mel, as a yardstick; the Swin
kernels beside the time of their weights' split). The float32 Swin
kernels are also held to their plain versions at a ragged BW of each
(odd, shifted, nine masks), their ptxas lines (no spill), the HGMMA
instructions of the GEMM they launch (none fails the run), and
torch.matmul's float32 time on the stage-4 GEMM shapes, TF32 off and on,
is printed as a yardstick. The GroupNorm pair (csrc/group_norm.cu) runs
the 14 applies of a 48 kHz Encodec forward of 64 clips as the forward calls
them (each form with its norms, a conv bias and its pads, recorded from a
forward), each held to its plain version (GN_ATOL) and to ATen's chain
around the pair's own norm (bias add_, +, ELU, pad) bit for bit, two
launches bit for bit, and timed beside that chain (what the forward ran
before the fold), the chain on ATen's nn.GroupNorm (the yardstick,
library_ms), the plain version and its bound (each norm read by the
moments and the apply, and the form's writes); bf16 at every apply within
one ulp of the chain; and its ptxas lines (no spill). Then it
drives the ported paths through the public API,
FrechetAudioDistance(weights="random", device="cuda"):
- VGGish: scores two 16 kHz WAV corpora and checks the results;
- PANN: scores the same corpora with pann-16k, and a part of them with
  pann-8k and pann-32k (the resample path and the other two geometries);
- CLAP: scores two 48 kHz corpora (with a 12 s clip, truncated, and a
  0.5 s one), then the 16 kHz part (resampled as it is loaded), and holds
  card embeddings against the CPU's on the pipeline's resample path;
- Encodec (cuDNN's convolutions and LSTM; at 48 kHz the GroupNorm kernel
  pair after each of the 18 convolutions): encodec-24k on 24 kHz mono
  corpora and encodec-48k on 48 kHz stereo ones (8 sines and 8 noise
  clips of 10 s, a 4 s clip whose padded frames are masked, a 12 s clip
  that the batch skips), then
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
Then the host runtime (step 9): the path from a file that is not WAV, mixed
to mono and resampled by the native C library (native/fad_native.cpp),
into the kernels:
(a) the native library is built from this checkout (g++) into an empty
    directory, with its seconds and path; the step fails unless
    native.available();
(b) the port's own writers make 32 sines (background, 16-bit FLAC) and 32
    noise clips (eval, in turn FLAC-24, AIFF, AIFC mu-law, AU A-law, CAF,
    RF64, Wave64, float WAV, Ogg FLAC, and Ogg Vorbis, MP3 and Ogg Opus
    where the system has the library: each library is reported present or
    absent) of 10 s at 44.1 kHz stereo, 16-bit WAV copies of the background
    and of the lossless eval files, and a 16 kHz mono FLAC pair; every file
    is decoded, and each lossless one must equal its WAV copy;
(c) VGGish (random weights, seed 0, file_batch 64) scores the FLAC pair,
    the mixed pair, its lossless part and the WAV copies (within 1e-3 of
    each other: score() reads each directory in its listing order, and the
    FAD moves with the order of the files), the lossless clips and their
    WAV copies in one order (the same embeddings, the FAD within 1e-6
    relative), and 8 a side, also on the CPU plain path (1e-3);
(d) CLAP scores the 44.1 kHz pair, resampled to 48 kHz in C, with its
    three kernels' counts, and 4 a side on the card and the CPU (1e-3);
(e) host times: decode per format, the C resampler against the NumPy
    fallback at 44.1 -> 16 and 48 kHz, and the host preparation of one
    64-clip chunk on the resample path beside the 16 kHz int16 wire, in a
    {"host_runtime": ...} line.
Last, the numerics modes (step 10), in a {"numerics": ...} line with its
seconds:
(a) the bf16 instances of both Swin kernels (csrc/window_attn_bf16.cu,
    wgmma products on weight slabs that two windows share) against their
    plain bf16 versions at every layer shape of a CLAP forward at
    file_batch 64 and at a ragged BW of each (odd, shifted, nine masks):
    the error in bf16 ulps of the output's largest magnitude (at most 2)
    and the share of elements within one ulp of their own (at least 0.9),
    times, bounds at the dense bf16 rate, the ptxas lines (every bf16
    kernel, no spill), the HGMMA instructions of each kernel in the
    library's SASS (none fails the run), and torch.matmul's time on the
    stage-4 qkv and proj GEMM shapes as a yardstick;
(b) vggish, pann-16k, clap, encodec-24k (mixed) and encodec-48k (forced,
    mixed) with FAD_TPU_MODEL_DTYPE=bfloat16 against float32 on the same
    32 + 32 clips of 10 s: FAD deltas (held to 1e-3 absolute but for
    encodec-48k, printed) and embedding errors; the bf16 CLAP run is the
    bf16 kernels' path (10 and 2 launches a chunk, no float32 kernel);
(c) encodec-24k with FAD_TPU_LSTM_MATMUL=bfloat16 against cuDNN's float32
    LSTM: embedding error, forward and LSTM times (graphed and eager);
(d) FAD_TPU_PRECISION=high (TF32) for VGGish and pann-16k: FAD deltas and
    the model's time a chunk;
(e) CLAP with FAD_TPU_FUSED_BLOCK=0: no swin_block_fused launch, 12
    window_attention_fused a chunk, the score within 1e-6 relative.
Each path runs with every launch count set to 0 just before it and read
just after, so the counts show which kernels it went through: VGGish and
PANN launch only their own log-mel kernel; CLAP launches the PANN log-mel
kernel once per chunk, swin_block_fused exactly 10 times as often and
window_attention_fused 2 times; encodec-24k launches none, encodec-48k
group_norm 18 times a forward, its applies 4 split, 4 elu, 4 residual and
2 plain, and nothing else. The
`kernels` line gives each kernel's count on its main path (vggish,
pann-16k, clap; the bf16 Swin kernels: step 10's bf16 CLAP run) and the
PANN kernel's count on every path that runs it under "launches_by_path".
Any failure raises and the exit code is non-zero. It imports nothing of JAX.
Its processes all end before it does.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists the kernels with their launch counts, errors,
times per 64-clip chunk, bounds (with the peak rate each used:
`bound_flops_per_s`) and arithmetic (`arith`: "fp32 fft", "3xtf32 wgmma
(attention: mma.sync)" or "bf16 wgmma (attention: mma.sync)").
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
# bf16 Swin kernels vs their plain bf16 versions: both round at the same
# points, so they differ where a float32 sum order moves a value across a
# bf16 rounding boundary: at most this many bf16 ulps of the output's largest
# magnitude, and at least this share of elements within one ulp of their own
# (the plain versions against the JAX Pallas kernels on the CPU: <= 1 ulp,
# 0.955-0.9998; tests/test_torch_precision.py).
SWIN_BF16_ULPS = 2.0
SWIN_BF16_WITHIN = 0.9
CLAP_CLIPS = 16  # per corpus, 10 s at 48 kHz
CLAP_LONG_SECONDS = 12.0  # past CLAP's 10 s: truncated to the 1001-frame read window
# The peak rates of the H100 SXM: float32 outside the tensor cores; float32-
# accurate products on the tensor cores, 3xTF32 (dense TF32, 495 TFLOP/s, over
# the three products of the split); and device memory.
F32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3
BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FAD_DELTA = 1e-3  # card vs CPU plain path, absolute and relative
# GroupNorm kernel pair vs plain, float32 outputs of order 1: only the
# moments' summation order (float32 within a thread) and the fma's single
# rounding differ.
GN_ATOL = 1e-5
GN_EPS = 1e-5
# The kernels of csrc/group_norm.cu that ptxas must report without a spill:
# group_norm_moments_kernel and group_norm_apply_kernel's four forms, float
# and bf16.
GN_KERNEL_COUNT = 10
# A 48 kHz forward's applies by form (ops/group_norm.py's FORMS).
GN_FORMS = {"split": 4, "elu": 4, "residual": 4, "plain": 2}
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
NUMERICS_CLIPS = 32  # step 10: per side, 10 s each, at each family's rate
FUSED_BLOCK_RTOL = 1e-6  # FAD_TPU_FUSED_BLOCK=0 vs the whole-block route, both 3xTF32
HOST_SR = 44100  # step 9: the host runtime's corpora, stereo
HOST_CLIPS = 32  # sines (background) and noise clips (eval), 10 s each; and a 16 kHz pair
HOST_CPU_CLIPS = 8  # per side, the VGGish pair also scored on the CPU
HOST_CLAP_CLIPS = 4  # per side, the CLAP pair scored on the card and the CPU
HOST_EQUAL_RTOL = 1e-6  # lossless containers vs their 16-bit WAV copies: the same arrays
LOSSLESS_FORMATS = ("flac24", "aiff", "aifc_ulaw", "au_alaw", "caf", "rf64", "w64",
                    "wav_float", "ogg_flac")  # G.711 too: its WAV copy holds what it decodes to
LOSSY_FORMATS = ("vorbis", "mp3", "opus")  # where the system library is present
HOST_EXT = {"flac16": ".flac", "flac24": ".flac", "aiff": ".aiff", "aifc_ulaw": ".aifc",
            "au_alaw": ".au", "caf": ".caf", "rf64": ".rf64", "w64": ".w64",
            "wav_float": ".wav", "ogg_flac": ".oga", "vorbis": ".ogg", "mp3": ".mp3",
            "opus": ".opus"}


def bound(flops: float, nbytes: float, flops_per_s: float = F32_FLOPS):
    """(least ms, what bounds it): the larger of flops at the given peak (the
    float32 SIMT one unless the kernel's products run on the tensor cores) and
    bytes at the memory rate."""
    ops_ms, bytes_ms = flops / flops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def rate_name(flops_per_s: float) -> str:
    return {F32_FLOPS: "67 TFLOP/s fp32", TF32X3_FLOPS: "165 TFLOP/s 3xTF32",
            BF16_FLOPS: "989 TFLOP/s bf16"}[flops_per_s]


def bf16_ulp(torch, v):
    """The spacing of bf16 values at |v| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


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


def device_ms(torch, fn, name: str = "", iters: int = 5):
    """Device milliseconds per call of fn of the kernels whose name holds
    name (every kernel: ""), summed from a torch.profiler trace of iters
    calls after one warm-up call; None where the trace has no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == DeviceType.CUDA and name in e.name
                and not e.name.startswith("Memcpy") and not e.name.startswith("Memset"))
    return total / 1e3 / iters if total > 0 else None


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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


def swin_inputs(torch, gen, clap, name: str, c: int, heads: int, bw: int, mask, dtype=None) -> dict:
    """Keyword arguments of a Swin kernel on the card, drawn from gen: x
    [bw, 64, c] x 0.5, weights x 0.05, biases x 0.01, LayerNorm gamma 1 +- 0.1
    and beta 0.1, the gathered relative-position bias of a table x 0.1; all
    in dtype (when given) but the float32 mask."""
    dev = torch.device("cuda")
    n = clap.WINDOW_SIZE ** 2

    def normal(shape, scale, offset=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + offset

    table = normal(((2 * clap.WINDOW_SIZE - 1) ** 2, heads), 0.1)
    index = torch.from_numpy(clap._relative_position_index(clap.WINDOW_SIZE).reshape(-1))
    bias = table[index.long().to(dev)].reshape(n, n, heads).permute(2, 0, 1).contiguous()
    args = dict(
        x_windows=normal((bw, n, c), 0.5),
        w_qkv=normal((c, 3 * c), 0.05), b_qkv=normal((3 * c,), 0.01),
        w_proj=normal((c, c), 0.05), b_proj=normal((c,), 0.01), bias=bias, mask=mask.to(dev),
        gamma1=normal((c,), 0.1, 1.0), beta1=normal((c,), 0.1),
    )
    if name == "swin_block_fused":
        args.update(gamma2=normal((c,), 0.1, 1.0), beta2=normal((c,), 0.1),
                    w_fc1=normal((c, 4 * c), 0.05), b_fc1=normal((4 * c,), 0.01),
                    w_fc2=normal((4 * c, c), 0.05), b_fc2=normal((c,), 0.01))
    if dtype is not None:
        args = {k: v if k == "mask" else v.to(dtype).contiguous() for k, v in args.items()}
    return args


def bf16_accuracy(torch, diff, ref) -> tuple:
    """(the largest |kernel - plain| in bf16 ulps of the plain output's largest
    magnitude, the share of elements within one ulp of their own value)."""
    ref_f = ref.float()
    return (float(diff.max()) / float(bf16_ulp(torch, ref_f.abs().max())),
            float((diff <= bf16_ulp(torch, ref_f)).float().mean()))


def swin_kernel_phase(torch, np, window_attn, clap, batch: int, dtype=None) -> dict:
    """Both Swin kernels vs plain at every layer shape of one CLAP forward at
    B = the CUDA file_batch: swin_block_fused at stages 1-3 (shifted and not),
    window_attention_fused at stage 4. Inputs are scaled as in the tests
    (x 0.5, weights 0.05, biases 0.01), and for a bf16 call (dtype) rounded to
    bf16, the mask kept float32. Per kernel: the worst error (bf16: also in
    bf16 ulps of the output's largest magnitude, and the share of elements
    within one ulp of their own), and the time, plain time and bound of one
    64-clip chunk (each shape's launch times its launches per forward). The
    bound counts 24*M*C^2 + 4*M*64*C flops for the block and 8*M*C^2 +
    4*M*64*C for the attention half (M = tokens) at the rate of the kernels'
    products (float32: 3xTF32, with the float32 SIMT bound printed beside it;
    bf16: the dense bf16 rate), and x, out, the weights, bias and mask as
    bytes in their dtypes. For float32 also the call's device time and that
    of the weights' split in it (split_weights_kernel, which the wrapper
    launches for each weight in every call), from a torch.profiler trace."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n = clap.WINDOW_SIZE ** 2
    bf16 = dtype == torch.bfloat16
    rate = BF16_FLOPS if bf16 else TF32X3_FLOPS

    summary = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "bound_ms_fp32": 0.0, "device_ms": 0.0, "split_ms": 0.0, "flops": 0.0,
                      "bytes": 0.0, "shapes": []}
               for name in ("swin_block_fused", "window_attention_fused")}
    if bf16:
        for row in summary.values():
            row.update(max_err_ulps=0.0, within_one_ulp=1.0)
            del row["bound_ms_fp32"], row["device_ms"], row["split_ms"]
    for (stage, shifted), layer in sorted(swin_layers(clap).items()):
        name, c, heads, nw = layer["kernel"], layer["c"], layer["heads"], layer["nw"]
        per_forward = layer["per_forward"]
        args = swin_inputs(torch, gen, clap, name, c, heads, batch * nw, layer["mask"], dtype)
        kernel = getattr(window_attn, name)
        plain = getattr(window_attn, f"{name}_reference")
        out = kernel(**args, heads=heads, num_windows=nw)
        ref = plain(**args, heads=heads, num_windows=nw)
        torch.cuda.synchronize()
        label = f"{name}{'[bf16]' if bf16 else ''} stage {stage + 1}"
        check(out.shape == ref.shape == args["x_windows"].shape and out.dtype == ref.dtype,
              f"{label} shape {out.shape} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{label} output not finite")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        kern_ms, plain_ms, runs = timed_pair(
            torch, lambda: kernel(**args, heads=heads, num_windows=nw),
            lambda: plain(**args, heads=heads, num_windows=nw), iters=10,
        )
        m = batch * nw * n
        c2 = 24 if name == "swin_block_fused" else 8
        flops = c2 * m * c * c + 4 * m * n * c
        nbytes = (2 * args["x_windows"].numel() * args["x_windows"].element_size()
                  + sum(t.numel() * t.element_size() for k, t in args.items() if k != "x_windows"))
        bound_ms, bound_by = bound(flops, nbytes, rate)
        bound_ms_fp32 = bound(flops, nbytes)[0]
        shape_row = {"stage": stage + 1, "C": c, "heads": heads, "shifted": shifted,
                     "per_forward": per_forward, "ms": kern_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "max_abs_err": err}
        if bf16:
            ulps, within = bf16_accuracy(torch, diff, ref)
            shape_row.update(max_err_ulps=ulps, within_one_ulp=within)
            accuracy = f"max_abs_err {err:.3e} = {ulps:.2f} ulps of the largest, {within:.4f} within one ulp"
            rates = f"{bound_by} at {rate_name(rate)}"
        else:
            call = lambda: kernel(**args, heads=heads, num_windows=nw)  # noqa: E731
            dev_ms = device_ms(torch, call)
            split_ms = device_ms(torch, call, "split_weights_kernel")
            shape_row.update(bound_ms_fp32=bound_ms_fp32, device_ms=dev_ms, split_ms=split_ms)
            accuracy = f"max_abs_err {err:.3e}"
            rates = (f"{bound_by} at {rate_name(rate)}; {bound_ms_fp32:.4f} ms at "
                     f"{rate_name(F32_FLOPS)}; device time {ms_text(dev_ms)}, of it the "
                     f"weights' split {ms_text(split_ms)}")
        print(f"{name}{'[bf16]' if bf16 else ''} stage {stage + 1} (C {c}, {heads} heads, nW {nw}, "
              f"{'shifted' if shifted else 'unshifted'}) B={batch}: {accuracy}, "
              f"kernel {kern_ms:.4f} ms ({runs[1]:.4f}, {runs[2]:.4f}) plain {plain_ms:.4f} ms "
              f"({runs[0]:.4f}, {runs[3]:.4f}) bound {bound_ms:.4f} ms ({rates}; "
              f"{flops / 1e9:.2f} GFLOP, {flops / kern_ms / 1e9:.2f} TFLOP/s), "
              f"{per_forward} per forward")
        if bf16:
            check(ulps <= SWIN_BF16_ULPS and within >= SWIN_BF16_WITHIN,
                  f"{label} vs plain: {ulps} ulps > {SWIN_BF16_ULPS} or {within} within one "
                  f"ulp < {SWIN_BF16_WITHIN}")
        else:
            check(err <= SWIN_ATOL, f"{label} vs plain: {err} > {SWIN_ATOL}")
        row = summary[name]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if bf16:
            row["max_err_ulps"] = max(row["max_err_ulps"], ulps)
            row["within_one_ulp"] = min(row["within_one_ulp"], within)
        for key in ("ms", "plain_ms", "bound_ms") + (
                () if bf16 else ("bound_ms_fp32", "device_ms", "split_ms")):
            if row[key] is not None and shape_row[key] is not None:
                row[key] += per_forward * shape_row[key]
            else:  # a trace without device time: not measured
                row[key] = None
        row["flops"] += per_forward * flops
        row["bytes"] += per_forward * nbytes
        row["shapes"].append(shape_row)
        del args, out, ref, diff
    for row in summary.values():
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        row["bound_by"] = bound(row.pop("flops"), row.pop("bytes"), rate)[1]
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
    """An encodec-24k path launched no kernel of the port."""
    check(not any(counts.values()), f"the {label} path launched {counts}")


def check_group_norm_counts(counts: dict, forwards: int, label: str) -> None:
    """An encodec-48k path: 18 group_norm launches a forward, its applies by
    form (GN_FORMS), no other kernel."""
    want = {"group_norm": 18 * forwards,
            **{f"group_norm_apply.{form}": n * forwards for form, n in GN_FORMS.items()}}
    got = {k: v for k, v in counts.items() if v}
    check(forwards > 0 and got == want,
          f"the {label} path launched {counts} in {forwards} forwards")


def counted_forwards(fad) -> list:
    """A list that grows by one with each forward of fad.model (a hook that
    stays on the model)."""
    calls = []
    fad.model.register_forward_hook(lambda module, args, out: calls.append(1))
    return calls


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


def host_clip(np, index: int, kind: str, sr: int, channels: int, seconds: float):
    """Step 9's clip `index` on the PCM16 grid: a sine (a second one, 1.5
    times higher, on the right channel) or noise from its own seed."""
    n = int(sr * seconds)
    if kind == "sine":
        t = np.arange(n) / sr
        freq = 220.0 * 2 ** (index / 12)
        chans = [0.5 * np.sin(2 * np.pi * freq * t), 0.3 * np.sin(2 * np.pi * 1.5 * freq * t)]
    else:
        rng = np.random.default_rng(SEED + 1000 * sr + index)
        chans = [rng.standard_normal(n) * 0.1 for _ in range(channels)]
    x = chans[0] if channels == 1 else np.stack(chans[:channels], axis=1)
    return np.clip(np.round(x * 32768.0), -32768, 32767) / 32768.0


def ogg_crc(data: bytes) -> int:
    """The Ogg page checksum (CRC-32, polynomial 0x04C11DB7, not reflected)."""
    table = OGG_CRC_TABLE
    crc = 0
    for byte in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ table[(crc >> 24) ^ byte]
    return crc


def _ogg_crc_table() -> list:
    table = []
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ 0x04C11DB7) if r & 0x80000000 else (r << 1)
        table.append(r & 0xFFFFFFFF)
    return table


OGG_CRC_TABLE = _ogg_crc_table()


def write_ogg_flac(flac, path: str, x, sr: int) -> None:
    """Ogg FLAC (mapping 1.0) around the port's native FLAC stream: a first
    packet of 0x7F 'FLAC' 1.0 with the fLaC marker and STREAMINFO, then the
    frames in packets of 16 KiB, one packet a page. The port reads Ogg FLAC
    but, like the JAX package, writes none; this muxer is the smoke run's."""
    import struct

    native_path = path + ".native"
    flac.write_flac(native_path, x, sr)
    raw = Path(native_path).read_bytes()
    Path(native_path).unlink()
    pos = 4
    while True:  # the metadata blocks, up to the first frame
        last, size = raw[pos] >> 7, int.from_bytes(raw[pos + 1 : pos + 4], "big")
        pos += 4 + size
        if last:
            break
    frames = raw[pos:]
    packets = [b"\x7fFLAC\x01\x00" + struct.pack(">H", 0) + raw[: 4 + 4 + 34]]
    packets += [frames[i : i + 16384] for i in range(0, len(frames), 16384)]
    pages = []
    for seq, packet in enumerate(packets):
        lacing = [255] * (len(packet) // 255) + [len(packet) % 255]
        flags = (2 if seq == 0 else 0) | (4 if seq == len(packets) - 1 else 0)
        head = (b"OggS" + struct.pack("<BBqIII", 0, flags, 0, 0xF1AC, seq, 0)
                + bytes([len(lacing)]) + bytes(lacing))
        crc = ogg_crc(head + packet)
        pages.append(head[:22] + struct.pack("<I", crc) + head[26:] + packet)
    Path(path).write_bytes(b"".join(pages))


def write_host_file(task) -> None:
    """One file of step 9's corpora, by the port's own writers, and its
    16-bit WAV copy where it has one (G.711 files: of the G.711 round trip,
    which is what they decode to). Runs in a worker process."""
    fmt, path, index, kind, sr, channels, seconds, wav_copy = task
    import numpy as np

    from frechet_audio_distance_exported_tpu_torch.ops.resample import resample
    from frechet_audio_distance_exported_tpu_torch.utils import (
        aiff, au, audio_io, caf, flac, g711, mp3, opusogg, vorbis, wav64,
    )

    x = host_clip(np, index, kind, sr, channels, seconds)
    writers = {
        "flac16": lambda: flac.write_flac(path, x, sr),
        "flac24": lambda: flac.write_flac(path, x, sr, bits=24),
        "aiff": lambda: aiff.write_aiff(path, x, sr),
        "aifc_ulaw": lambda: aiff.write_aiff(path, x, sr, subtype="ulaw"),
        "au_alaw": lambda: au.write_au(path, x, sr, subtype="alaw"),
        "caf": lambda: caf.write_caf(path, x, sr),
        "rf64": lambda: wav64.write_rf64(path, x, sr),
        "w64": lambda: wav64.write_w64(path, x, sr),
        "wav_float": lambda: audio_io.write_wav(path, x, sr, subtype="float32"),
        "ogg_flac": lambda: write_ogg_flac(flac, path, x, sr),
        "vorbis": lambda: vorbis.write_ogg_vorbis(path, x, sr),
        "mp3": lambda: mp3.write_mp3(path, x, sr),
        "opus": lambda: opusogg.write_ogg_opus(path, resample(x, sr, 48000), 48000),
    }
    writers[fmt]()
    if wav_copy:
        pcm = np.round(x * 32768.0).astype(np.int16)
        if fmt == "aifc_ulaw":
            pcm = g711.ulaw_decode(g711.ulaw_encode(pcm))
        elif fmt == "au_alaw":
            pcm = g711.alaw_decode(g711.alaw_encode(pcm))
        audio_io.write_wav(wav_copy, pcm / 32768.0, sr)


def host_libraries(vorbis, mp3, opusogg) -> dict:
    """The system codec libraries, probed with the calls the tests use."""
    return {
        "vorbis": {"decode": vorbis.have_vorbis(), "encode": vorbis.have_vorbis_encoder()},
        "mp3": {"decode": mp3.have_mp3(), "encode": mp3.have_mp3_encoder()},
        "opus": {"decode": opusogg.have_opus(), "encode": opusogg.have_opus_encoder()},
    }


def write_host_corpora(root: Path, libraries: dict) -> dict:
    """Step 9's directories: HOST_CLIPS sines at 44.1 kHz stereo as 16-bit
    FLAC (background) and HOST_CLIPS noise clips split in turn across the
    lossless containers and the lossy ones whose library is present (eval);
    16-bit WAV copies of the background and of the lossless eval files;
    a 16 kHz mono 16-bit FLAC pair; and small pairs for the CPU. Written by
    a pool of worker processes."""
    import multiprocessing

    formats = list(LOSSLESS_FORMATS) + [f for f in LOSSY_FORMATS
                                        if all(libraries[f].values())]
    dirs = {name: root / f"host_{name}" for name in (
        "bg", "ev", "ev_lossless", "bg_wav", "ev_wav", "bg16", "ev16", "bg_small", "ev_small",
        "bg_clap", "ev_clap")}
    for d in dirs.values():
        d.mkdir()
    tasks, ev_formats = [], {}
    for i in range(HOST_CLIPS):
        tasks.append(("flac16", str(dirs["bg"] / f"sine{i:02d}.flac"), i, "sine", HOST_SR, 2,
                      CLIP_SECONDS, str(dirs["bg_wav"] / f"sine{i:02d}.wav")))
        fmt = formats[i % len(formats)]
        ev_formats[f"noise{i:02d}{HOST_EXT[fmt]}"] = fmt
        wav_copy = str(dirs["ev_wav"] / f"noise{i:02d}.wav") if fmt in LOSSLESS_FORMATS else None
        tasks.append((fmt, str(dirs["ev"] / f"noise{i:02d}{HOST_EXT[fmt]}"), i, "noise", HOST_SR, 2,
                      CLIP_SECONDS, wav_copy))
        for side, kind in (("bg16", "sine"), ("ev16", "noise")):
            tasks.append(("flac16", str(dirs[side] / f"{kind}{i:02d}.flac"), i, kind, 16000, 1,
                          CLIP_SECONDS, None))
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, os.cpu_count() or 1)) as pool:
        pool.map(write_host_file, tasks, chunksize=1)
    for name, fmt in ev_formats.items():
        if fmt in LOSSLESS_FORMATS:
            os.link(dirs["ev"] / name, dirs["ev_lossless"] / name)
    names = sorted(ev_formats)
    for i in range(HOST_CPU_CLIPS):
        os.link(dirs["bg"] / f"sine{i:02d}.flac", dirs["bg_small"] / f"sine{i:02d}.flac")
        os.link(dirs["ev"] / names[i], dirs["ev_small"] / names[i])
    for i in range(HOST_CLAP_CLIPS):
        os.link(dirs["bg"] / f"sine{i:02d}.flac", dirs["bg_clap"] / f"sine{i:02d}.flac")
        os.link(dirs["ev"] / names[i], dirs["ev_clap"] / names[i])
    print(f"host runtime (b): {len(tasks)} files written in {time.perf_counter() - t0:.1f} s; "
          f"eval formats in turn: {formats}")
    return {"dirs": {k: str(v) for k, v in dirs.items()}, "ev_formats": ev_formats,
            "formats": formats}


def decode_host_corpora(np, audio_io, corpora: dict) -> dict:
    """Decode every file of step 9's corpora: any exception fails the run.
    Each lossless file must equal its 16-bit WAV copy, each lossy one must
    hold 10 s of two channels. Returns the decode ms of each file by format."""
    dirs, ev_formats = corpora["dirs"], corpora["ev_formats"]
    times = {}

    def timed_read(path):
        t0 = time.perf_counter()
        data, sr = audio_io.sf_read(path)
        return data, sr, (time.perf_counter() - t0) * 1e3

    checked = 0
    for side, prefix in (("bg", "sine"), ("ev", "noise")):
        for name in sorted(os.listdir(dirs[side])):
            fmt = "flac16" if side == "bg" else ev_formats[name]
            data, sr, ms = timed_read(os.path.join(dirs[side], name))
            times.setdefault(fmt, []).append(ms)
            check(bool(np.isfinite(data).all()) and data.ndim == 2 and data.shape[1] == 2,
                  f"host runtime: {name} ({fmt}) decoded to {data.shape}")
            stem = os.path.splitext(name)[0]
            if fmt in LOSSLESS_FORMATS or side == "bg":
                wav, wav_sr, _ = timed_read(os.path.join(dirs[f"{side}_wav"], stem + ".wav"))
                check(sr == wav_sr == HOST_SR and np.array_equal(data, wav),
                      f"host runtime: {name} ({fmt}) does not decode to its WAV copy")
                checked += 1
            else:
                rate = 48000 if fmt == "opus" else HOST_SR
                check(sr == rate and abs(len(data) - rate * CLIP_SECONDS) <= 0.01 * rate
                      * CLIP_SECONDS, f"host runtime: {name} ({fmt}) is {len(data)} frames at {sr}")
    for side in ("bg16", "ev16"):
        for name in sorted(os.listdir(dirs[side])):
            data, sr, ms = timed_read(os.path.join(dirs[side], name))
            times.setdefault("flac16_16k_mono", []).append(ms)
            check(sr == 16000 and data.shape == (int(16000 * CLIP_SECONDS),),
                  f"host runtime: {side}/{name} decoded to {data.shape} at {sr}")
    print(f"host runtime (b): every file decoded; {checked} lossless files equal their WAV copies")
    return times


def host_chunk_prep(audio_io, resample, pipeline, paths, family, workers: int,
                    native_resample: bool = True) -> dict:
    """Host preparation of one chunk of files, stage by stage: decode (a
    pool of `workers` threads, as score() loads), mono mix and resample to
    the family's rate (the same pool; in NumPy under
    FAD_TPU_DISABLE_NATIVE=1 unless native_resample), then the pipeline's
    own steps (`family`, a pipeline.Family: its prepare, the wire included)
    and _pack_wave, as the pipeline runs them. ms per stage, the wire's
    dtype."""
    from multiprocessing.dummy import Pool as ThreadPool

    out = {}
    with ThreadPool(workers) as pool:
        t0 = time.perf_counter()
        decoded = pool.map(lambda p: audio_io.sf_read(p), paths)
        t1 = time.perf_counter()

        def mix_resample(item):
            data, sr = item
            mono = data.mean(axis=1) if data.ndim > 1 else data
            return mono if sr == family.rate else resample(mono, sr, family.rate)

        if not native_resample:
            os.environ["FAD_TPU_DISABLE_NATIVE"] = "1"
        try:
            clips = pool.map(mix_resample, decoded)
        finally:
            os.environ.pop("FAD_TPU_DISABLE_NATIVE", None)
        t2 = time.perf_counter()
    rows = [family.prepare(clip, family.rate, False)[0] for clip in clips]
    wave = pipeline._pack_wave(rows, len(rows), pipeline.bucket_len(max(len(r) for r in rows)),
                               family.full_scale)
    t3 = time.perf_counter()
    out.update(decode_ms=(t1 - t0) * 1e3, mix_resample_ms=(t2 - t1) * 1e3,
               prep_pack_ms=(t3 - t2) * 1e3, total_ms=(t3 - t0) * 1e3, wire=str(wave.dtype),
               files=len(paths))
    return out


def numpy_resample(resample, x, sr_orig: int, sr_new: int):
    """The resampler's NumPy fallback: FAD_TPU_DISABLE_NATIVE=1 for the call."""
    os.environ["FAD_TPU_DISABLE_NATIVE"] = "1"
    try:
        return resample(x, sr_orig, sr_new)
    finally:
        del os.environ["FAD_TPU_DISABLE_NATIVE"]


def host_stems(container_dir: str, wav_dir: str, wanted: str) -> list:
    """(stem, extension) of each clip of a container directory that has a WAV
    copy, sorted by stem, with the extension of the directory `wanted`."""
    ext = {os.path.splitext(n)[0]: os.path.splitext(n)[1] for n in os.listdir(container_dir)}
    stems = sorted(os.path.splitext(n)[0] for n in os.listdir(wav_dir))
    return [(stem, ".wav" if wanted == wav_dir else ext[stem]) for stem in stems]


def fad_of(fad, emb_bg, emb_ev) -> float:
    """The host FAD of two embedding matrices, as score() computes it."""
    return float(fad.calculate_frechet_distance(*fad.calculate_embd_statistics(emb_bg),
                                                *fad.calculate_embd_statistics(emb_ev)))


def numerics_clips(np, sr: int, channels: int) -> tuple:
    """NUMERICS_CLIPS sines (a second, different channel in stereo) and as
    many noise clips, 10 s each at sr, float32 off the PCM16 grid."""
    rng = np.random.default_rng(SEED + 7 + sr + channels)
    t = np.arange(int(sr * CLIP_SECONDS)) / sr

    def clip(freq=None):
        if freq is None:
            chans = [rng.standard_normal(t.size) * 0.1 for _ in range(channels)]
        else:
            chans = [0.5 * np.sin(2 * np.pi * freq * t) + 0.01 * rng.standard_normal(t.size),
                     0.3 * np.sin(2 * np.pi * 1.5 * freq * t)][:channels]
        x = chans[0] if channels == 1 else np.stack(chans, axis=1)
        return x.astype(np.float32)

    bg = [clip(110.0 * 2 ** (i / 7)) for i in range(NUMERICS_CLIPS)]
    return bg, [clip() for _ in range(NUMERICS_CLIPS)]


def with_env(name: str, value, fn):
    """fn() with os.environ[name] = value (unset for None), restored after."""
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        return fn()
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def embedding_error(np, ours, ref) -> dict:
    """Embedding rows of a reduced mode against float32: the largest error
    relative to the largest float32 value, and the median error relative to
    each value (values under 1e-3 of the largest excluded)."""
    diff = np.abs(ours - ref)
    scale = float(np.abs(ref).max())
    big = np.abs(ref) > 1e-3 * scale
    return {"max_rel": float(diff.max()) / scale,
            "median_rel": float(np.median(diff[big] / np.abs(ref[big])))}


def ptxas_rows(build_log: str, source: str) -> list:
    """(kernel, registers, spill line) of each kernel of one source in the
    build log; source is the file's name as its kernels' mangled names carry
    it ("window_attn_cu" for csrc/window_attn.cu, "window_attn_bf16" for
    csrc/window_attn_bf16.cu)."""
    rows, name = [], None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if source in line else None
        elif name and "spill" in line and not any(r[0] == name for r in rows):
            rows.append([name, None, line.strip()])
        elif name and "Used" in line and "registers" in line:
            for r in rows:
                if r[0] == name:
                    r[1] = line.split("Used")[1].split("registers")[0].strip()
    return rows


# The ragged cases of steps 3 and 10(a): (kernel, C, heads, windows per image, images). Nine
# windows an image (a 24 x 24 token grid, shifted: nine masks) make BW odd, so a block's last
# window pair and the GEMMs' last 128-row tile are half empty.
SWIN_RAGGED = (("swin_block_fused", 96, 4, 9, 7), ("window_attention_fused", 768, 32, 9, 3))
# The float32 kernels of csrc/window_attn.cu that ptxas must report without a spill:
# gemm_tf32_kernel at three epilogues and two tile widths, split_weights_kernel,
# row_stats_kernel and attention_from_qkv_kernel.
F32_KERNEL_COUNT = 9
# The float32 kernels' wgmma functions in the library's SASS, by the launch key they serve.
F32_FUNCTIONS = {"swin_block_fused": ("gemm_tf32_kernel",),
                 "window_attention_fused": ("gemm_tf32_kernel",)}
# The bf16 kernels of csrc/window_attn_bf16.cu that ptxas must report without a spill:
# swin_attn_bf16_kernel and swin_mlp_bf16_kernel at C = 96, 192, 384; gemm_bf16_kernel,
# ln_rows_bf16_kernel and attention_from_qkv_bf16_kernel.
BF16_KERNEL_COUNT = 9
# The bf16 kernels' functions in the library's SASS, by the launch key they serve.
BF16_FUNCTIONS = {"swin_block_fused[bf16]": ("swin_attn_bf16_kernel", "swin_mlp_bf16_kernel"),
                  "window_attention_fused[bf16]": ("gemm_bf16_kernel",)}


def ragged_phase(torch, window_attn, clap, dtype) -> list:
    """Each Swin kernel in dtype against its plain version at a ragged BW
    (SWIN_RAGGED), shifted, with mask_count > 1: float32 within SWIN_ATOL,
    bf16 within the ulp bars."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    bf16 = dtype == torch.bfloat16
    rows = []
    for name, c, heads, nw, images in SWIN_RAGGED:
        label = f"{name}[bf16]" if bf16 else name
        res = clap.WINDOW_SIZE * int(round(math.sqrt(nw)))
        mask = torch.from_numpy(clap._shift_attn_mask(res, clap.WINDOW_SIZE, clap.WINDOW_SIZE // 2))
        check(mask.shape[0] == nw > 1, f"ragged mask {tuple(mask.shape)}")
        args = swin_inputs(torch, gen, clap, name, c, heads, images * nw, mask,
                           torch.bfloat16 if bf16 else None)
        out = getattr(window_attn, name)(**args, heads=heads, num_windows=nw)
        ref = getattr(window_attn, f"{name}_reference")(**args, heads=heads, num_windows=nw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{label} ragged output not finite")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        row = {"kernel": name, "C": c, "heads": heads, "bw": images * nw, "mask_count": nw,
               "max_abs_err": err}
        shape = (f"{label} ragged (C {c}, {heads} heads, BW {images * nw} = {images} x {nw}, "
                 f"shifted, {nw} masks): max_abs_err {err:.3e}")
        if bf16:
            ulps, within = bf16_accuracy(torch, diff, ref)
            print(f"{shape} = {ulps:.2f} ulps of the largest, {within:.4f} within one ulp")
            check(ulps <= SWIN_BF16_ULPS and within >= SWIN_BF16_WITHIN,
                  f"{label} ragged vs plain: {ulps} ulps or {within} within one ulp")
            row.update(max_err_ulps=ulps, within_one_ulp=within)
        else:
            print(shape)
            check(err <= SWIN_ATOL, f"{label} ragged vs plain: {err} > {SWIN_ATOL}")
        rows.append(row)
        del args, out, ref, diff
    return rows


def forward_applies(torch, group_norm_ops, encodec, samples: int) -> list:
    """The applies of a 48 kHz forward in the order it calls them: (form,
    [(C, T) of each norm], left, right), recorded from a forward of one
    clip of samples samples on the card."""
    calls = []
    epilogue = group_norm_ops._epilogue

    def record(form, norms, left, right):
        calls.append((form, [tuple(n.y.shape[1:]) for n in norms], left, right))
        return epilogue(form, norms, left, right)

    model = encodec.encodec_for_rate(48000).eval().cuda()
    group_norm_ops._epilogue = record
    try:
        with torch.inference_mode():
            model(torch.zeros((1, 2, samples), device="cuda"))
    finally:
        group_norm_ops._epilogue = epilogue
    return calls


def draw_norms(torch, group_norm_ops, gen, batch: int, shapes: list, dtype) -> list:
    """A Norm of each (C, T): conv outputs with channel offsets and a row
    mean^2 / var about 4, a conv bias, gamma and beta drawn, in dtype."""
    dev = gen.device
    out = []
    for channels, t in shapes:
        y = (torch.randn((batch, channels, t), generator=gen, device=dev)
             + 0.3 * torch.randn((1, channels, 1), generator=gen, device=dev) + 2.0)
        conv_bias = 0.5 * torch.randn(channels, generator=gen, device=dev)
        gamma = 1.0 + 0.2 * torch.randn(channels, generator=gen, device=dev)
        beta = 0.3 * torch.randn(channels, generator=gen, device=dev)
        out.append(group_norm_ops.Norm(y.to(dtype), conv_bias.to(dtype), gamma.to(dtype),
                                       beta.to(dtype), GN_EPS))
    return out


def gn_form(group_norm_ops, form: str, norms: list, left: int, right: int):
    """The wrapper of form, as the encoder calls it."""
    if form == "plain":
        return group_norm_ops.plain(norms[0])
    if form == "residual":
        return group_norm_ops.residual(norms[0], norms[1], left, right)
    fn = group_norm_ops.elu_pad if form == "elu" else group_norm_ops.split
    return fn(norms[0], left, right)


def gn_chain(torch, form: str, norms: list, left: int, right: int, norm):
    """ATen's chain that form folds into the apply: the conv's bias added
    as ATen's add_ adds it, norm(x, Norm) alone, then the residual sum, F.elu
    and F.pad as the form has them."""
    F = torch.nn.functional
    g = [norm(n.y + n.conv_bias[:, None], n) for n in norms]
    if form == "plain":
        return g[0]
    act = F.elu(g[0] + g[1] if form == "residual" else g[0])
    if left or right:
        act = F.pad(act, (left, right), mode="reflect")
    return (g[0], act) if form == "split" else act


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def gn_bytes(form: str, shapes: list, left: int, right: int, batch: int, size: int) -> int:
    """The pair's bytes for one apply of form: each norm's input read by its
    moments and by the apply, and what the form writes (g, and the padded
    ELU)."""
    channels, t = shapes[0]
    n = channels * t
    writes = (n if form in ("plain", "split") else 0) + (
        channels * (left + t + right) if form != "plain" else 0)
    return batch * size * (2 * n * len(shapes) + writes)


def group_norm_kernel_phase(torch, group_norm_ops, encodec, _build, batch: int) -> dict:
    """The GroupNorm pair as a 48 kHz forward of batch 10 s clips calls it:
    each of its 14 applies (GN_FORMS, recorded from a forward: its form,
    norms and pads) on drawn conv outputs with a conv bias, float32: against
    the plain version (ops/group_norm._compose on the same card tensors,
    GN_ATOL), against ATen's chain around the pair's own norm bit for bit
    (the bias add_, group_norm(), +, F.elu, F.pad), two launches bit for
    bit; timed beside that chain (unfused_ms: what the forward ran before
    the fold), the same chain on ATen's F.group_norm (the yardstick,
    library_ms), the plain version and the bound, the pair's bytes (each
    norm read by the moments and the apply, and the form's writes) at the
    memory rate. bf16 at every apply: within one bf16 ulp of the chain,
    element by element, and in bf16 ulps of the largest output from the
    plain version (one a norm). The ptxas lines of csrc/group_norm.cu.
    Totals are a chunk's: the 14 applies (18 norms) once each."""
    samples = int(48000 * CLIP_SECONDS)
    calls = forward_applies(torch, group_norm_ops, encodec, samples)
    forms = [form for form, *_ in calls]
    check({f: forms.count(f) for f in GN_FORMS} == GN_FORMS,
          f"a 48 kHz forward's applies: {forms}")
    check([s for _, shapes, *_ in calls for s in shapes] == encodec.group_norm_shapes(samples),
          "the applies' norms are not group_norm_shapes")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    F = torch.nn.functional

    def pair(x, n):
        return group_norm_ops.group_norm(x, n.weight, n.bias, n.eps)

    def library(x, n):
        return F.group_norm(x, 1, n.weight, n.bias, n.eps)

    rows, max_err = [], 0.0
    for form, shapes, left, right in calls:
        norms = draw_norms(torch, group_norm_ops, gen, batch, shapes, torch.float32)
        label = f"group_norm {form} {[batch, *shapes[0]]} x{len(shapes)} pad ({left}, {right})"

        def kernel():
            return gn_form(group_norm_ops, form, norms, left, right)

        def unfused():
            return gn_chain(torch, form, norms, left, right, pair)

        def aten():
            return gn_chain(torch, form, norms, left, right, library)

        def plain():
            return group_norm_ops._compose(form, norms, left, right)

        out, again = as_tuple(kernel()), as_tuple(kernel())
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)), f"{label}: two launches differ")
        del again
        chain = as_tuple(unfused())
        check(len(out) == len(chain) and all(a.shape == b.shape and torch.equal(a, b)
                                             for a, b in zip(out, chain)),
              f"{label}: not the unfused chain's bits")
        del chain
        ref = as_tuple(plain())
        err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        del out, ref
        max_err = max(max_err, err)
        numel = batch * shapes[0][0] * shapes[0][1]
        iters = max(3, min(50, int(2e9 // numel)))
        plain_a = cuda_ms(torch, plain, 2, 1)
        kern_a = cuda_ms(torch, kernel, iters)
        unfused_ms = cuda_ms(torch, unfused, iters)
        library_ms = cuda_ms(torch, aten, iters)
        kern_b = cuda_ms(torch, kernel, iters)
        plain_b = cuda_ms(torch, plain, 2, 1)
        nbytes = gn_bytes(form, shapes, left, right, batch, 4)
        row = {"form": form, "shape": [batch, *shapes[0]], "norms": len(shapes),
               "pad": [left, right], "max_abs_err": err, "ms": (kern_a + kern_b) / 2,
               "unfused_ms": unfused_ms, "library_ms": library_ms,
               "plain_ms": (plain_a + plain_b) / 2,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "gb": nbytes / 1e9}
        row["roofline_pct"] = 100.0 * row["bound_ms"] / row["ms"]
        rows.append(row)
        print(f"{label}: max_abs_err {err:.3e}, the chain's bits; kernel {row['ms']:.4f} ms "
              f"({kern_a:.4f}, {kern_b:.4f}), unfused {unfused_ms:.4f} ms, on nn.GroupNorm "
              f"{library_ms:.4f} ms (yardstick), plain {row['plain_ms']:.3f} ms; bound "
              f"{row['bound_ms']:.4f} ms ({row['gb']:.2f} GB), {row['roofline_pct']:.1f} % of it")
        del norms
    check(max_err <= GN_ATOL, f"group_norm forms vs plain {max_err} > {GN_ATOL}")
    bf16 = []
    for form, shapes, left, right in calls:
        norms = draw_norms(torch, group_norm_ops, gen, batch, shapes, torch.bfloat16)
        out = as_tuple(gn_form(group_norm_ops, form, norms, left, right))
        chain = as_tuple(gn_chain(torch, form, norms, left, right, pair))
        within = all(a.shape == b.shape and bool(((a.float() - b.float()).abs() <= bf16_ulp(
            torch, torch.maximum(a.float().abs(), b.float().abs()))).all())
            for a, b in zip(out, chain))
        del chain
        ref = as_tuple(group_norm_ops._compose(form, norms, left, right))
        ulps = max(float((a.float() - b.float()).abs().max()
                         / bf16_ulp(torch, b.float().abs().max())) for a, b in zip(out, ref))
        del out, ref
        ms = cuda_ms(torch, lambda: gn_form(group_norm_ops, form, norms, left, right),
                     max(3, min(50, int(2e9 // (batch * shapes[0][0] * shapes[0][1])))))
        nbytes = gn_bytes(form, shapes, left, right, batch, 2)
        bf16.append({"form": form, "shape": [batch, *shapes[0]], "norms": len(shapes),
                     "max_err_ulps": ulps, "within_one_ulp_of_chain": within, "ms": ms,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        print(f"group_norm bf16 {form} {[batch, *shapes[0]]} x{len(shapes)}: within one ulp of "
              f"the chain {within}; {ulps:.2f} ulps of the largest output from plain; kernel "
              f"{ms:.4f} ms, bound {bf16[-1]['bound_ms']:.4f} ms")
        check(within, f"group_norm bf16 {form} at {shapes}: not within one ulp of the chain")
        check(ulps <= len(shapes), f"group_norm bf16 {form} at {shapes}: {ulps} ulps of plain")
        del norms
    ptxas = ptxas_rows(_build.library_path().with_suffix(".log").read_text(), "group_norm")
    for name, regs, spill in ptxas:
        print(f"ptxas group_norm: {name[:90]}: {regs} registers; {spill}")
    check(len(ptxas) == GN_KERNEL_COUNT
          and all(" 0 bytes spill stores, 0 bytes spill loads" in r[2] for r in ptxas),
          f"group_norm kernels spill or are missing: {ptxas}")
    keys = ("ms", "unfused_ms", "library_ms", "plain_ms", "bound_ms", "gb")
    total = {k: sum(r[k] for r in rows) for k in keys}
    print(f"group_norm, the 14 applies (18 norms) of a {batch}-clip chunk: kernel "
          f"{total['ms']:.3f} ms, unfused {total['unfused_ms']:.3f} ms, on nn.GroupNorm "
          f"{total['library_ms']:.3f} ms, plain {total['plain_ms']:.2f} ms, bound "
          f"{total['bound_ms']:.3f} ms ({total['gb']:.1f} GB)")
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, **total, "rows": rows, "bf16": bf16, "ptxas": ptxas}


def hgmma_counts(_build, functions: dict) -> dict:
    """HGMMA (wgmma) instructions in the built library's SASS, per launch key
    of functions (BF16_FUNCTIONS or F32_FUNCTIONS), by cuobjdump -sass."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    counts = {key: 0 for key in functions}
    function = ""
    for line in sass.splitlines():
        if "Function :" in line:
            function = line.split("Function :")[1].strip()
        elif "HGMMA" in line:
            for key, names in functions.items():
                counts[key] += any(name in function for name in names)
    return counts


def gemm_yardstick(torch, batch: int, dtype) -> dict:
    """torch.matmul's ms in dtype on the GEMM shapes of window_attention_fused
    at CLAP stage 4 (M = batch * 64 tokens, C = 768): qkv [M, C] x [C, 3C]
    and proj [M, C] x [C, C]; float32 with TF32 off (exact float32, as the
    port computes) and then on (1xTF32, for contrast). A library yardstick
    the port never calls."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    m, c = batch * 64, 768
    a = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    weights = {key: torch.randn((c, n), generator=gen, device="cuda").to(dtype)
               for key, n in (("qkv", 3 * c), ("proj", c))}
    modes = (None,) if dtype == torch.bfloat16 else (False, True)
    times = {}
    for tf32 in modes:
        if tf32 is not None:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            for key, w in weights.items():
                name = key if tf32 is None else f"{key}_tf32_{'on' if tf32 else 'off'}"
                times[name] = cuda_ms(torch, lambda: torch.matmul(a, w), iters=50)
                kind = str(dtype).removeprefix("torch.") + (
                    "" if tf32 is None else f", TF32 {'on' if tf32 else 'off'}")
                print(f"torch.matmul {kind} [{m}, {c}] x [{c}, {w.shape[1]}] ({key}): "
                      f"{times[name]:.4f} ms, {2 * m * c * w.shape[1] / times[name] / 1e9:.1f} "
                      f"TFLOP/s")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    return times


def float32_swin_checks(torch, window_attn, clap, _build, batch: int) -> dict:
    """Step 3's further checks of the float32 Swin kernels: the ragged cases,
    the ptxas lines of csrc/window_attn.cu (F32_KERNEL_COUNT kernels, no
    spill), the HGMMA instructions of the kernels each launch key runs (none
    fails), and torch.matmul's float32 time on the stage-4 GEMM shapes."""
    out = {"ragged": ragged_phase(torch, window_attn, clap, torch.float32)}
    ptxas = ptxas_rows(_build.library_path().with_suffix(".log").read_text(), "window_attn_cu")
    for name, regs, spill in ptxas:
        print(f"ptxas float32: {name[:90]}: {regs} registers; {spill}")
    check(len(ptxas) == F32_KERNEL_COUNT
          and all(" 0 bytes spill stores, 0 bytes spill loads" in r[2] for r in ptxas),
          f"float32 kernels spill or are missing: {ptxas}")
    out["ptxas"] = ptxas
    out["hgmma"] = hgmma_counts(_build, F32_FUNCTIONS)
    print(f"HGMMA instructions of the float32 kernels: {out['hgmma']}")
    check(all(n > 0 for n in out["hgmma"].values()),
          f"a float32 kernel has no HGMMA: {out['hgmma']}")
    out["gemm_yardstick_ms"] = gemm_yardstick(torch, batch, torch.float32)
    return out


def numerics_phase(torch, np, calculator, launches, window_attn, clap, _build, apply_precision,
                   single_clap: float, clap_pair, batch: int) -> dict:
    """Step 10, the numerics modes. (a) Both bf16 Swin kernels against their
    plain bf16 versions at every layer shape of a CLAP forward at B = batch,
    and their ptxas lines. (b) Each family's embeddings and FAD in bf16
    (FAD_TPU_MODEL_DTYPE=bfloat16; Encodec mixed, encodec-48k forced) against
    float32 on the same NUMERICS_CLIPS a side, random weights from seed 0;
    CLAP's bf16 run is the bf16 kernels' path (counts set to 0 just before,
    read just after). (c) encodec-24k with FAD_TPU_LSTM_MATMUL=bfloat16
    against cuDNN's float32 LSTM, and both forwards' times. (d)
    FAD_TPU_PRECISION=high (TF32) for VGGish and pann-16k: FAD deltas and
    the model's device time a chunk. (e) CLAP with FAD_TPU_FUSED_BLOCK=0:
    no swin_block_fused launch, 12 window_attention_fused a chunk, the
    score within 1e-6 relative of the default route's."""
    out = {"kernels": swin_kernel_phase(torch, np, window_attn, clap, batch, torch.bfloat16)}
    out["ragged"] = ragged_phase(torch, window_attn, clap, torch.bfloat16)
    ptxas = ptxas_rows(_build.library_path().with_suffix(".log").read_text(), "window_attn_bf16")
    for name, regs, spill in ptxas:
        print(f"ptxas bf16: {name[:90]}: {regs} registers; {spill}")
    check(len(ptxas) == BF16_KERNEL_COUNT
          and all(" 0 bytes spill stores, 0 bytes spill loads" in r[2] for r in ptxas),
          f"bf16 kernels spill or are missing: {ptxas}")
    out["ptxas"] = ptxas
    out["hgmma"] = hgmma_counts(_build, BF16_FUNCTIONS)
    print(f"HGMMA instructions in the library's SASS: {out['hgmma']}")
    check(all(n > 0 for n in out["hgmma"].values()), f"a bf16 kernel has no HGMMA: {out['hgmma']}")
    out["gemm_yardstick_ms"] = gemm_yardstick(torch, batch, torch.bfloat16)

    # (b) bf16 against float32, family by family.
    rates = {"vggish": (16000, 1), "pann-16k": (16000, 1), "clap": (48000, 1),
             "encodec-24k": (24000, 1), "encodec-48k": (48000, 2)}
    clips = {}
    scores = {}
    for model, (sr, channels) in rates.items():
        if (sr, channels) not in clips:
            clips[sr, channels] = numerics_clips(np, sr, channels)
        bg, ev = clips[sr, channels]
        row = {}
        emb = {}
        for mode in ("float32", "bfloat16"):
            fad = with_env("FAD_TPU_MODEL_DTYPE", None if mode == "float32" else mode,
                           lambda: calculator(model, channels=channels))
            check(fad.pipeline.dtype == getattr(torch, mode), f"{model} {mode}: {fad.pipeline.dtype}")
            t0 = time.perf_counter()
            launches.zero()
            emb[mode] = (fad.get_embeddings(bg, sr), fad.get_embeddings(ev, sr))
            torch.cuda.synchronize()
            counts = launches.read()
            row[f"{mode}_s"] = time.perf_counter() - t0
            row[mode] = fad_of(fad, *emb[mode])
            if model == "clap" and mode == "bfloat16":
                chunks = counts["fused_pann_logmel"]
                check(chunks > 0 and counts["swin_block_fused[bf16]"] == 10 * chunks
                      and counts["window_attention_fused[bf16]"] == 2 * chunks
                      and counts["swin_block_fused"] == counts["window_attention_fused"] == 0,
                      f"the bf16 CLAP path launched {counts}")
                out["bf16_clap_launches"] = counts
                print(f"clap bf16 path launches: {counts}")
            del fad
        check(all(np.isfinite(e).all() for e in emb["bfloat16"]), f"{model} bf16 not finite")
        row.update(embedding_error(np, np.concatenate(emb["bfloat16"]), np.concatenate(emb["float32"])))
        row["abs"] = abs(row["bfloat16"] - row["float32"])
        row["rel"] = row["abs"] / abs(row["float32"])
        held = model != "encodec-48k"
        print(f"{model} bf16 vs float32 on {NUMERICS_CLIPS} + {NUMERICS_CLIPS} clips: FAD "
              f"{row['bfloat16']!r} vs {row['float32']!r}, |delta| {row['abs']:.3e} absolute, "
              f"{row['rel']:.3e} relative{'' if held else ' (printed, not held)'}; embeddings "
              f"max {row['max_rel']:.3e} of the largest, median {row['median_rel']:.3e} relative; "
              f"{row['float32_s']:.2f} s / {row['bfloat16_s']:.2f} s")
        if held:
            check(row["abs"] <= FAD_DELTA, f"{model} bf16 FAD delta {row['abs']} > {FAD_DELTA}")
        scores[model] = row
    out["scores"] = scores

    # (c) encodec-24k with bf16 LSTM operands against cuDNN's float32 LSTM.
    bg, _ = clips[24000, 1]
    fad = calculator("encodec-24k")
    ref = fad.get_embeddings(bg, 24000)
    ours = with_env("FAD_TPU_LSTM_MATMUL", "bfloat16", lambda: fad.get_embeddings(bg, 24000))
    lstm = {"embeddings": embedding_error(np, ours, ref)}
    wave = torch.from_numpy(np.stack(bg + bg)[:, None, :]).cuda()  # one 64-clip chunk
    seq = torch.randn((batch, fad.model.lstm.hidden_size, LSTM_STEPS[0]), device="cuda")
    with torch.inference_mode():
        for mode in ("float32", "bfloat16"):
            lstm[f"forward_ms_{mode}"] = with_env(
                "FAD_TPU_LSTM_MATMUL", mode, lambda: cuda_ms(torch, lambda: fad.model(wave), 3, 1))
            lstm[f"lstm_ms_{mode}"] = with_env(
                "FAD_TPU_LSTM_MATMUL", mode, lambda: cuda_ms(torch, lambda: fad.model.lstm(seq), 5, 1))
        args = fad.model.lstm.bf16_operands(seq.transpose(1, 2).contiguous())
        encodec_mod = sys.modules[type(fad.model).__module__]
        lstm["lstm_ms_bfloat16_eager"] = cuda_ms(
            torch, lambda: encodec_mod.recurrence_bf16_operands(*args), 1, 1)
    print(f"encodec-24k LSTM bf16 operands vs cuDNN float32: embeddings max "
          f"{lstm['embeddings']['max_rel']:.3e} of the largest, median "
          f"{lstm['embeddings']['median_rel']:.3e}; forward of {batch} clips "
          f"{lstm['forward_ms_float32']:.2f} ms (cuDNN) / {lstm['forward_ms_bfloat16']:.2f} ms "
          f"(bf16 operands); LSTM alone at T={LSTM_STEPS[0]}: {lstm['lstm_ms_float32']:.2f} ms / "
          f"{lstm['lstm_ms_bfloat16']:.2f} ms graphed ({lstm['lstm_ms_bfloat16_eager']:.2f} ms "
          f"eager)")
    out["lstm_bf16"] = lstm
    del fad, wave, seq, args

    # (d) FAD_TPU_PRECISION=high: TF32 for cuBLAS and cuDNN.
    tf32 = {}
    inputs = {"vggish": torch.randn((10 * batch, 96, 64), device="cuda") * 2.0 - 3.0,
              "pann-16k": torch.randn((batch, 1032, 64), device="cuda") * 10.0 - 40.0}
    for model in ("vggish", "pann-16k"):
        bg, ev = clips[16000, 1]
        row = {}
        for mode in ("highest", "high"):
            fad = with_env("FAD_TPU_PRECISION", mode, lambda: calculator(model))
            check(torch.backends.cudnn.allow_tf32 is (mode == "high"), f"{mode}: cuDNN TF32 flag")
            row[mode] = fad_of(fad, fad.get_embeddings(bg, 16000), fad.get_embeddings(ev, 16000))
            with torch.inference_mode():
                row[f"chunk_ms_{mode}"] = cuda_ms(torch, lambda: fad.pipeline.forward(inputs[model]), 5, 2)
            del fad
        apply_precision()
        row["abs"] = abs(row["high"] - row["highest"])
        row["rel"] = row["abs"] / abs(row["highest"])
        print(f"{model} FAD_TPU_PRECISION=high vs highest: FAD {row['high']!r} vs "
              f"{row['highest']!r}, |delta| {row['abs']:.3e} absolute, {row['rel']:.3e} relative; "
              f"model {row['chunk_ms_highest']:.3f} ms -> {row['chunk_ms_high']:.3f} ms a chunk")
        tf32[model] = row
    check(torch.backends.cudnn.allow_tf32 is False and torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 stayed on after FAD_TPU_PRECISION was unset")
    out["tf32"] = tf32
    del inputs

    # (e) FAD_TPU_FUSED_BLOCK=0: stages 1-3 through the attention-only kernel.
    fad = calculator("clap")
    launches.zero()
    score = with_env("FAD_TPU_FUSED_BLOCK", "0", lambda: fad.score(*clap_pair))
    counts = launches.read()
    chunks = counts["fused_pann_logmel"]
    rel = abs(score - single_clap) / abs(single_clap)
    print(f"clap FAD_TPU_FUSED_BLOCK=0: {score!r} vs {single_clap!r} (relative {rel:.3e}), "
          f"launches {counts}")
    check(chunks > 0 and counts["swin_block_fused"] == 0
          and counts["window_attention_fused"] == 12 * chunks,
          f"FAD_TPU_FUSED_BLOCK=0 launched {counts}")
    check(rel <= FUSED_BLOCK_RTOL, f"FAD_TPU_FUSED_BLOCK=0 score {rel} > {FUSED_BLOCK_RTOL}")
    out["fused_block_0"] = {"fad": score, "default": single_clap, "rel": rel, "launches": counts}
    return out


def host_runtime_phase(torch, np, tmp: Path, calculator, launches, smi: str,
                       batch: int) -> dict:
    """Step 9: the host runtime on the slice's path (decode a non-WAV file,
    mix to mono, the native resampler, the existing kernels):
    (a) build the native library from this checkout into an empty directory;
    (b) write and decode step 9's corpora;
    (c) VGGish on the card: the 16 kHz FLAC pair, the mixed pair, its
        lossless part against the WAV copy (1e-6 relative) and a small pair
        against the CPU plain path;
    (d) CLAP on the 44.1 kHz mixed pair (resampled to 48 kHz in C), its three
        kernels' counts, and a small pair on the card and the CPU;
    (e) host times: decode per format, C against NumPy resampling, and the
        host preparation of one 64-clip chunk."""
    from frechet_audio_distance_exported_tpu_torch import native, pipeline
    from frechet_audio_distance_exported_tpu_torch.ops.resample import resample
    from frechet_audio_distance_exported_tpu_torch.utils import audio_io, mp3, opusogg, vorbis

    # (a) The native library, built from this checkout's source into an empty
    #     directory (the process's own copy may already be loaded: the
    #     resample paths of steps 5 and 6 build it on first use).
    build_dir = tmp / "native_build"
    os.environ["FAD_TPU_TORCH_BUILD_DIR"] = str(build_dir)
    try:
        t0 = time.perf_counter()
        built = native.build()
        build_s = time.perf_counter() - t0
    finally:
        del os.environ["FAD_TPU_TORCH_BUILD_DIR"]
    check(native.available(), "host runtime (a): the native library is not available")
    print(f"host runtime (a): native library built in {build_s:.2f} s -> {built} "
          f"(g++ {' '.join(native.CXX_FLAGS)}); loaded: {native.library_path()}")

    # (b) The corpora, by the port's own writers.
    libraries = host_libraries(vorbis, mp3, opusogg)
    for name, have in libraries.items():
        state = "present" if all(have.values()) else f"ABSENT ({have})"
        print(f"host runtime (b): system library for {name}: {state}")
    corpora = write_host_corpora(tmp, libraries)
    dirs = corpora["dirs"]
    decode_times = decode_host_corpora(np, audio_io, corpora)

    # (c) VGGish at full width on the card.
    fad = calculator("vggish")
    check(fad.pipeline.file_batch == batch, "vggish file_batch is not the CUDA default")
    calls = [
        ("flac16k", (dirs["bg16"], dirs["ev16"]), {}),
        ("mixed", (dirs["bg"], dirs["ev"]), {}),
        ("lossless", (dirs["bg"], dirs["ev_lossless"]), {}),
        ("wav_copy", (dirs["bg_wav"], dirs["ev_wav"]), {}),
        ("small", (dirs["bg_small"], dirs["ev_small"]), {}),
    ]
    scores, counts = run_path(torch, fad, calls, launches, "fused_vggish_logmel",
                              "host runtime vggish")
    check_only(counts, "fused_vggish_logmel", "host runtime vggish")
    check(counts["fused_vggish_logmel"] >= 2 * len(calls),
          f"host runtime vggish: {counts['fused_vggish_logmel']} launches for {len(calls)} pairs")
    # The lossless containers against their WAV copies: the same arrays, so
    # in one file order the same embeddings and the same score (within
    # HOST_EQUAL_RTOL). score() reads each directory in its listing order,
    # and the FAD of one set of embeddings moves with the order of its files
    # (float32 means, a near-singular float64 epilogue at a small random-
    # weight FAD): that spread is measured here, and the two directories'
    # scores are held to the FAD bar (FAD_DELTA).
    order = {}
    for name, bg_dir, ev_dir in (("containers", dirs["bg"], dirs["ev_lossless"]),
                                 ("wav_copies", dirs["bg_wav"], dirs["ev_wav"])):
        order[name] = [
            fad.get_embeddings([audio_io.load_audio(os.path.join(d, stem + ext), 16000, 1)
                                for stem, ext in stems], 16000)
            for d, stems in ((bg_dir, host_stems(dirs["bg"], dirs["bg_wav"], bg_dir)),
                             (ev_dir, host_stems(dirs["ev_lossless"], dirs["ev_wav"], ev_dir)))]
    emb_diff = max(float(np.abs(a - b).max()) for a, b in zip(order["containers"],
                                                               order["wav_copies"]))
    same = {k: fad_of(fad, *v) for k, v in order.items()}
    rel = abs(same["containers"] - same["wav_copies"]) / abs(same["wav_copies"])
    print(f"host runtime (c) vggish, one file order: containers {same['containers']!r} vs WAV "
          f"copies {same['wav_copies']!r}, relative {rel:.3e}; embeddings max abs difference "
          f"{emb_diff:.3e}")
    check(emb_diff <= EMBEDDING_ATOL, f"host runtime (c): embeddings differ by {emb_diff}")
    check(rel <= HOST_EQUAL_RTOL, f"host runtime (c): containers vs WAV copies in one order: "
                                  f"{rel} > {HOST_EQUAL_RTOL}")
    rng = np.random.default_rng(SEED + 9)
    per_file = [e.reshape(-1, int(CLIP_SECONDS / 0.96), e.shape[-1]) for e in order["containers"]]
    shuffled = [fad_of(fad, *[blocks[rng.permutation(len(blocks))].reshape(-1, blocks.shape[-1])
                                  for blocks in per_file]) for _ in range(8)]
    spread = (max(shuffled) - min(shuffled)) / abs(same["containers"])
    dir_rel = abs(scores["lossless"] - scores["wav_copy"]) / abs(scores["wav_copy"])
    print(f"host runtime (c) vggish: the same embeddings in 8 file orders span {spread:.3e} "
          f"relative; score() of the two directories (each in its listing order): "
          f"{scores['lossless']!r} vs {scores['wav_copy']!r}, relative {dir_rel:.3e}")
    check(abs(scores["lossless"] - scores["wav_copy"]) <= FAD_DELTA and dir_rel <= FAD_DELTA,
          f"host runtime (c): lossless vs WAV copy directories {dir_rel} > {FAD_DELTA}")
    cpu_vggish = calculator("vggish", "cpu")
    fad_delta(scores["small"], cpu_vggish, dirs["bg_small"], dirs["ev_small"],
              "host runtime vggish (8 a side)")
    vggish_counts = counts
    del cpu_vggish

    # (e), on the card's VGGish calculator: one 64-clip chunk of each path.
    workers = fad.audio_load_worker
    resample_paths = [os.path.join(dirs[s], f) for s in ("bg", "ev") for f in
                      sorted(os.listdir(dirs[s]))]
    int16_paths = [os.path.join(dirs[s], f) for s in ("bg16", "ev16") for f in
                   sorted(os.listdir(dirs[s]))]
    family = fad.pipeline.family
    chunks = {
        "vggish_44k_resample_c": host_chunk_prep(audio_io, resample, pipeline, resample_paths,
                                                 family, workers),
        "vggish_16k_int16_wire": host_chunk_prep(audio_io, resample, pipeline, int16_paths,
                                                 family, workers),
        "vggish_44k_resample_c_one_thread": host_chunk_prep(
            audio_io, resample, pipeline, resample_paths, family, 1),
    }
    chunks["vggish_44k_resample_numpy"] = host_chunk_prep(
        audio_io, resample, pipeline, resample_paths, family, workers, native_resample=False)
    t0 = time.perf_counter()
    audio_io.load_audio_paths(resample_paths, 16000, 1, num_workers=workers)
    chunks["vggish_44k_load_audio_paths_ms"] = (time.perf_counter() - t0) * 1e3
    del fad

    # (d) CLAP on the 44.1 kHz pair, resampled to 48 kHz by the C resampler.
    fad = calculator("clap")
    clap_scores, counts = run_path(
        torch, fad, [("mixed", (dirs["bg"], dirs["ev"]), {}),
                     ("small", (dirs["bg_clap"], dirs["ev_clap"]), {})],
        launches, "swin_block_fused", "host runtime clap")
    check_clap_counts(counts, "host runtime clap")
    clap_counts = counts
    fad_delta(clap_scores["small"], calculator("clap", "cpu"), dirs["bg_clap"], dirs["ev_clap"],
              "host runtime clap (4 a side)")
    chunks["clap_44k_resample_c"] = host_chunk_prep(audio_io, resample, pipeline,
                                                    resample_paths, fad.pipeline.family, workers)
    del fad

    # (e) One clip: decode per format, and the resampler, C against NumPy.
    decode_ms = {fmt: float(np.median(ms)) for fmt, ms in sorted(decode_times.items())}
    clip = audio_io.sf_read(resample_paths[0])[0].mean(axis=1).astype(np.float32)
    resample_ms = {}
    for target in (16000, 48000):
        fast, ms_c = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            fast = resample(clip, HOST_SR, target)
            ms_c.append((time.perf_counter() - t0) * 1e3)
        slow, ms_np = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            slow = numpy_resample(resample, clip, HOST_SR, target)
            ms_np.append((time.perf_counter() - t0) * 1e3)
        diff = float(np.abs(fast.astype(np.float64) - slow).max())
        resample_ms[str(target)] = {"c_ms": float(np.median(ms_c)), "numpy_ms": float(np.median(ms_np)),
                                    "max_abs_diff": diff, "samples_out": int(fast.size)}
        print(f"host runtime (e) resample 44.1 -> {target / 1000:g} kHz, one {CLIP_SECONDS:g} s "
              f"clip: C "
              f"{resample_ms[str(target)]['c_ms']:.2f} ms, NumPy "
              f"{resample_ms[str(target)]['numpy_ms']:.2f} ms, max |C - NumPy| {diff:.3e}")
        check(diff <= 1e-6, f"host runtime (e): C vs NumPy resample at {target}: {diff}")
    for fmt, ms in decode_ms.items():
        print(f"host runtime (e) decode {fmt}: {ms:.2f} ms a {CLIP_SECONDS:g} s clip (median)")
    for name, row in chunks.items():
        print(f"host runtime (e) chunk {name}: {row}")
    return {
        "card": smi,
        "native": {"build_s": build_s, "path": str(built.relative_to(tmp)),
                   "flags": list(native.CXX_FLAGS)},
        "libraries": libraries,
        "eval_formats": corpora["formats"],
        "vggish": {"scores": scores, "launches": vggish_counts,
                   "one_order": {**same, "rel": rel, "embedding_max_abs": emb_diff},
                   "order_spread_rel": spread, "directories_rel": dir_rel},
        "clap": {"scores": clap_scores, "launches": clap_counts},
        "decode_ms": decode_ms,
        "resample_ms": resample_ms,
        "chunk_prep_ms": chunks,
        "cpu_threads": torch.get_num_threads(),
        "cpu_count": os.cpu_count(),
    }


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
    from frechet_audio_distance_exported_tpu_torch.config import apply_precision
    from frechet_audio_distance_exported_tpu_torch.models import clap, encodec
    from frechet_audio_distance_exported_tpu_torch.ops import _build, cuda_frontend, cuda_pann_frontend
    from frechet_audio_distance_exported_tpu_torch.ops import frontends as fe
    from frechet_audio_distance_exported_tpu_torch.ops import group_norm as group_norm_ops
    from frechet_audio_distance_exported_tpu_torch.ops import launches, window_attn
    from frechet_audio_distance_exported_tpu_torch.ops import stats as stats_ops
    from frechet_audio_distance_exported_tpu_torch.parallel import embed
    from frechet_audio_distance_exported_tpu_torch.parallel import mesh as mesh_mod
    from frechet_audio_distance_exported_tpu_torch.pipeline import FAMILIES
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
    check(apply_precision() == "highest", "FAD_TPU_PRECISION is set: the kernels' checks need "
          "exact float32")
    batch = FAMILIES["vggish"].file_batch["cuda"]
    vggish = vggish_kernel_phase(torch, np, cuda_frontend, fe, batch)
    pann = pann_kernel_phase(torch, np, cuda_pann_frontend, fe, batch)
    swin = swin_kernel_phase(torch, np, window_attn, clap, batch)
    swin_f32 = float32_swin_checks(torch, window_attn, clap, _build, batch)
    gnorm = group_norm_kernel_phase(torch, group_norm_ops, encodec,
                                    _build, FAMILIES["encodec"].file_batch["cuda"])

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

        # 7. The Encodec paths through the public API. encodec-24k launches
        #    no kernel of the port, encodec-48k the GroupNorm pair 18 times
        #    a forward and nothing else. encodec-24k on mono 24 kHz
        #    corpora, encodec-48k on stereo 48 kHz ones (channels=2), each
        #    a path of its own; then encodec-48k with channels=1 on the
        #    16 kHz part: mono duplicated to two channels, each resampled.
        gn_launches, gn_forms = {}, {}
        for model, sr, channels in (("encodec-24k", 24000, 1), ("encodec-48k", 48000, 2)):
            e_bg, e_ev, e_bg_small, e_ev_small = write_encodec_corpora(
                tmp, audio_io, np, sr, channels)
            fad = calculator(model, channels=channels)
            check(fad.pipeline.file_batch == FAMILIES["encodec"].file_batch["cuda"],
                  f"{model} file_batch is not the CUDA Encodec default")
            timed_warmup(torch, fad, model, fad.pipeline.file_batch)
            forwards = counted_forwards(fad)
            scores, counts = run_path(torch, fad, pair_calls(e_bg, e_ev), launches, None, model)
            if sr == 24000:
                check_none(counts, model)
            else:
                check_group_norm_counts(counts, len(forwards), model)
                gn_launches[model] = counts["group_norm"]
                gn_forms[model] = {form: counts[f"group_norm_apply.{form}"] for form in GN_FORMS}
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
        forwards = counted_forwards(fad)
        _, counts = run_path(torch, fad, [("bg_ev", (bg_small, ev_small), {})], launches, None,
                             "encodec-48k 16 kHz")
        check_group_norm_counts(counts, len(forwards), "encodec-48k 16 kHz")
        gn_launches["encodec-48k 16 kHz"] = counts["group_norm"]
        gn_forms["encodec-48k 16 kHz"] = {form: counts[f"group_norm_apply.{form}"]
                                          for form in GN_FORMS}
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

        # 9. The host runtime: non-WAV containers decoded, mixed to mono and
        #    resampled by the native C library into the VGGish and CLAP
        #    paths; then the host's times.
        t0 = time.perf_counter()
        host = host_runtime_phase(torch, np, tmp, calculator, launches, smi[0], batch)
        host["seconds"] = time.perf_counter() - t0
        print(f"host runtime: step 9 took {host['seconds']:.1f} s")
        print(json.dumps({"host_runtime": host}))

        # 10. The numerics modes: the bf16 Swin kernels against their plain
        #     versions, each family in bf16 against float32, the bf16 LSTM
        #     operands, TF32, and FAD_TPU_FUSED_BLOCK=0.
        t0 = time.perf_counter()
        numerics = numerics_phase(torch, np, calculator, launches, window_attn, clap, _build,
                                  apply_precision, single_scores["clap"]["bg_ev"],
                                  (clap_bg, clap_ev), batch)
        numerics["seconds"] = time.perf_counter() - t0
        print(f"numerics: step 10 took {numerics['seconds']:.1f} s")
        print(json.dumps({"numerics": numerics}))

    print(json.dumps({"kernels": [
        {
            "name": "group_norm",
            "route": "cuda",
            "source": "frechet_audio_distance_exported_tpu_torch/csrc/group_norm.cu",
            "replaces": "none (XLA's fusion of "
                        "frechet_audio_distance_exported_tpu/models/common.py:100 group_norm_full)",
            "launches": gn_launches["encodec-48k"],
            "launches_by_path": gn_launches,
            "form_launches": gn_forms["encodec-48k"],
            "form_launches_by_path": gn_forms,
            "max_abs_err": gnorm["max_abs_err"],
            "err_of": "the forms' outputs, absolute",
            "ms": gnorm["ms"],
            "plain_ms": gnorm["plain_ms"],
            "unfused_ms": gnorm["unfused_ms"],
            "bound_ms": gnorm["bound_ms"],
            "bound_by": "bytes",
            "bound_gb": gnorm["gb"],
            "library_ms": gnorm["library_ms"],
            "arith": "fp32 sums a thread, fp64 across; fp32 fma, expm1f",
            "bound_flops_per_s": F32_FLOPS,
            "at": "one 64-clip encodec-48k chunk: the 14 applies (18 norms) of a forward",
            "shapes": gnorm["rows"],
            "bf16": gnorm["bf16"],
            "ptxas": gnorm["ptxas"],
        },
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
                "tflops": swin[name]["tflops"],
                "device_ms": swin[name]["device_ms"],
                "split_ms": swin[name]["split_ms"],
                "library_ms": None,
                "arith": "3xtf32 wgmma (attention: mma.sync)",
                "hgmma": swin_f32["hgmma"][name],
                "ragged": [r for r in swin_f32["ragged"] if r["kernel"] == name],
                **({"gemm_yardstick_ms": swin_f32["gemm_yardstick_ms"]}
                   if name == "window_attention_fused" else {}),
                "bound_flops_per_s": TF32X3_FLOPS,
                "at": "one 64-clip CLAP chunk: every launch of a forward",
                "shapes": swin[name]["shapes"],
            }
            for name, line in (("swin_block_fused", 152), ("window_attention_fused", 217))
        ),
        *(
            {
                "name": f"{name}[bf16]",
                "route": "cuda",
                "source": "frechet_audio_distance_exported_tpu_torch/csrc/window_attn_bf16.cu",
                "replaces": f"frechet_audio_distance_exported_tpu/ops/pallas_window_attn.py:{line}",
                "launches": numerics["bf16_clap_launches"][f"{name}[bf16]"],
                "launches_of": "step 10's bf16 CLAP path (FAD_TPU_MODEL_DTYPE=bfloat16)",
                "max_abs_err": numerics["kernels"][name]["max_abs_err"],
                "max_err_ulps": numerics["kernels"][name]["max_err_ulps"],
                "within_one_ulp": numerics["kernels"][name]["within_one_ulp"],
                "err_of": "block output vs the plain bf16 version; ulps of its largest magnitude",
                "ms": numerics["kernels"][name]["ms"],
                "plain_ms": numerics["kernels"][name]["plain_ms"],
                "bound_ms": numerics["kernels"][name]["bound_ms"],
                "bound_by": numerics["kernels"][name]["bound_by"],
                "tflops": numerics["kernels"][name]["tflops"],
                "library_ms": None,
                "arith": "bf16 wgmma (attention: mma.sync)",
                "hgmma": numerics["hgmma"][f"{name}[bf16]"],
                "ragged": [r for r in numerics["ragged"] if r["kernel"] == name],
                **({"gemm_yardstick_ms": numerics["gemm_yardstick_ms"]}
                   if name == "window_attention_fused" else {}),
                "bound_flops_per_s": BF16_FLOPS,
                "at": "one 64-clip CLAP chunk: every launch of a forward",
                "shapes": numerics["kernels"][name]["shapes"],
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
