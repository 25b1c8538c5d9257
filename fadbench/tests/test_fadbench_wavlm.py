"""The wavlm-large configuration and its cell: the FLOP counter against a count
by hand, the cell's files found by name, the readers of its layers on a
hand-built trace, and on the card the lower-precision controls against the
cell's limits."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, make_root, tiny_traffic

from fadbench.counts import wavlm as wavlm_counts

CELL = "wavlm-large.corpus"
TINY = "tiny.wavlm"


def config():
    return json.loads((ROOT / "fadbench" / "configs" / "wavlm-large.json").read_text())


def test_wavlm_layers_by_hand():
    # 10 s at 16 kHz: 160,000 samples, 31,999 frames after the first
    # convolution, halved six times to 499.
    frames = [31999, 15999, 7999, 3999, 1999, 999, 499]
    assert wavlm_counts.frames(config(), 160000) == frames
    convs = [2 * 10 * 1 * 512 * 31999] + [2 * 3 * 512 * 512 * t for t in frames[1:5]] + [
        2 * 2 * 512 * 512 * t for t in frames[5:]]
    t, c = 499, 1024
    layer = (2 * t * c * 3 * c + 2 * t * c * 8 + 2 * 2 * t * t * c + 2 * t * c * c
             + 2 * 2 * t * c * 4096)
    hand = ([(f"conv{i}", f) for i, f in enumerate(convs)]
            + [("projection", 2 * t * 512 * c), ("pos_conv", 2 * 128 * 64 * c * t)]
            + [(f"layer{i}", layer) for i in range(24)])
    cfg = config()
    assert wavlm_counts.layers(cfg, 160000) == hand
    total = sum(f for _, f in hand)
    assert total == pytest.approx(384.0e9, rel=1e-3)  # 384.0 GFLOP a 10 s clip
    assert sum(convs) == pytest.approx(49.07e9, rel=1e-3)
    assert layer == pytest.approx(13.58e9, rel=1e-3)
    assert wavlm_counts.model_flops_per_clip(cfg, 160000) == total


def test_gemm_work_by_hand():
    flops, act, weights = wavlm_counts.gemm_work(config(), 160000)
    t, c, f = 499, 1024, 4096
    per_layer = 2 * t * c * (3 * c + 8) + 2 * t * c * c + 2 * 2 * t * c * f
    assert flops == 2 * t * 512 * c + 24 * per_layer
    # Rows in and out (and the residual) of each product, float32.
    assert act == 4 * t * (512 + c + 24 * ((c + 3200) + 3 * c + (c + f) + (f + 2 * c)))
    assert weights == 4 * (513 * c + 24 * (1025 * 3200 + 1025 * c + 1025 * f + 4097 * c))
    # The FLOPs bound it: the bytes of a 64-clip chunk at HBM bandwidth take
    # under half the FLOPs' time at the TF32 rate (17.4 against 39.1 ms).
    assert (64 * act + weights) / 3.35e12 < 64 * flops / 495e12 / 2


def test_the_cell_finds_every_file_by_name():
    from fadbench import spec

    cell = spec.load_cell(CELL)
    assert cell.entry["chips"] == 1 and cell.config["model_name"] == "wavlm-large"
    assert cell.traffic["sample_rate"] == cell.config["sample_rate"] == 16000
    assert cell.traffic["clips_per_call"] == {"background": 512, "eval": 512}
    assert set(cell.limits) == {"fad_rel", "mean_rel", "cov_rel"}
    assert [m["name"] for m in cell.end_to_end] == ["device_s_per_audio_h", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "audio_min_per_s.wavlm", "step_mfu.wavlm", "device_idle_pct.wavlm",
        "device_peak_gib.wavlm", "wavlm_attention_ms_per_clip", "wavlm_gemm_roofline_pct"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    ref = cell.reference()
    assert all(callable(getattr(ref, f)) for f in ("build", "init_state", "embed"))
    assert cell.counter().frames(cell.config, 160000)[-1] == cell.config["frames_per_clip"] == 499
    assert cell.counter().model_flops_per_clip(cell.config, 160000) == pytest.approx(384.0e9,
                                                                                   rel=1e-3)
    assert cell.config["reduced"] == []


def test_the_layer_readers_on_a_hand_built_trace():
    from fadbench import devtrace, harness, peaks, spec

    cell = spec.load_cell(CELL)
    calls = [{"failed": False, "clips": 1024}, {"failed": True, "clips": 1024}]
    run = harness.Run(cell=cell, setup_s=1.0, window_s=50.0, calls=calls, peak_window_bytes=0)
    attention, roofline = (cell.reader(n) for n in ("wavlm_attention_ms_per_clip",
                                                    "wavlm_gemm_roofline_pct"))
    assert attention.read(run) is None and roofline.read(run) is None  # no trace
    kernel_s = {
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma_"
        "aligna4_alignc4_execute_kernel__5x_cublas": 1.0,
        "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x64x8_stage3_warpsize2x2x1_ffma_"
        "aligna4_alignc4_execute_kernel__5x_cublas": 0.75,
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::"
        "native::addcmul_cuda_kernel(...)": 1.0,
        "void (anonymous namespace)::softmax_warp_forward<float, float, float, 9, false, false>"
        "(...)": 0.5,
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::"
        "native::direct_copy_kernel_cuda(...)": 2.0,
        "void (anonymous namespace)::gemm_tf32_kernel<128, 0, 1>(...)": 6.0,
        "void (anonymous namespace)::gemm_tf32_kernel<128, 1, 2>(...)": 3.0,
        "(anonymous namespace)::row_stats_kernel(float const*, float2*, int, int)": 0.5,
        "(anonymous namespace)::split_weights_kernel(float const*, float*, int, int)": 0.5,
        "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw": 9.0,
    }
    run.trace = devtrace.Trace(window_s=50.0, busy_s=24.25, kernel_s=kernel_s, idle_by_frame={})
    # Only the completed call's 1024 clips count; the failed call's kernels do.
    assert attention.read(run) == pytest.approx(1000.0 * 3.25 / 1024)
    flops, _, _ = wavlm_counts.gemm_work(cell.config, 160000)
    assert roofline.read(run) == pytest.approx(100.0 * 1024 * flops / peaks.TF32_FLOPS / 10.0)
    run.trace.kernel_s = {"sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw": 9.0}
    assert attention.read(run) is None and roofline.read(run) is None  # such kernels off the path


CONTROLS = [
    ({}, True),
    ({"FAD_TPU_PRECISION": "high"}, False),
    ({"FAD_TPU_MODEL_DTYPE": "bfloat16"}, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("env,correct", CONTROLS)
def test_lower_precision_fails_the_cells_limits(cuda_card, tmp_path, env, correct):
    """float32 with TF32 off comes out correct against the reference on the
    cell's limits; TF32 products and a bf16 model come out not correct, on
    24 + 24 ten-second clips, 16 a side a call. Each run has a process of
    its own, as each benchmark run has: in one process a later torch.profiler
    session can miss the tracer's marker kernel (seen on an H100)."""
    root = make_root(tmp_path, "wavlm-large", TINY, limits_of=CELL)
    traffic = tiny_traffic(16000, 10.0)
    traffic["pools"] = {side: dict(law, clips=24) for side, law in traffic["pools"].items()}
    traffic["clips_per_call"] = {"background": 16, "eval": 16}
    traffic["fad"] = {}
    (root / "fadbench" / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    code = (
        "import json, sys, time; from pathlib import Path; sys.path.insert(0, %r)\n"
        "from fadbench import harness\n"
        "r = harness.run_cell(%r, %d, 0.5, False, time.perf_counter(), device='cuda', "
        "root=Path(%r), bench_dir=Path(%r))\n"
        "print(json.dumps({k: r[k] for k in ('failed', 'correct', 'checks')}))\n"
    ) % (str(ROOT), TINY, 2**31 + 23, str(root), str(root / "fadbench"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, cwd=root, env={**os.environ, **env})
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["failed"] == 0
    assert result["correct"] is correct, result["checks"]


@pytest.mark.cuda
def test_only_the_attention_launches_the_attention_readers_kernels(cuda_card, tmp_path):
    """wavlm_attention_ms_per_clip reads kernels by name. In a step of the
    cell's shape (64 clips of 10 s through score()'s pipeline: two forwards,
    the first and a later statistics step at d = 1024), every launch whose
    name the reader matches is one of the 24 layers' attention: the step
    launches each such name 2 x 24 times as often as one layer's attention
    alone does, and no other."""
    from collections import Counter

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fadbench.metrics import wavlm_attention_ms_per_clip as reader
    from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance

    fad = FrechetAudioDistance(model_name="wavlm-large", weights="random", device="cuda",
                               ckpt_dir=str(tmp_path))
    rng = np.random.default_rng(5)
    clips = [(0.1 * rng.standard_normal(160000)).astype(np.float32) for _ in range(64)]
    model = fad.model
    b, t = 64, 499
    gen = torch.Generator(device="cuda").manual_seed(5)
    qkvg = torch.randn((b * t, model.encoder.layers[0].attention.qkvg_w.shape[1]),
                       generator=gen, device="cuda")
    bias = model.encoder.position_bias(t)

    def step():
        state = fad.pipeline.accumulate_stats(clips, 16000)
        fad.pipeline.accumulate_stats(clips, 16000, state=state)

    def attention():
        with torch.inference_mode():
            model.encoder.layers[0].attention(qkvg, b, t, bias)

    def launched(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
        return Counter(n for n in names if any(k in n for k in reader.KERNELS))

    alone = launched(attention)
    assert alone, "the attention alone launched none of the reader's kernels"
    assert launched(step) == Counter({name: 2 * 24 * n for name, n in alone.items()})
