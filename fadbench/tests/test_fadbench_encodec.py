"""The encodec-48k configuration and its cell: the FLOP counter against a
count by hand, the cell's files found by name, a tiny run on the CPU that
comes out correct, the two readers of its layers on a hand-built trace, and
on the card the three lower-precision controls against the cell's limits."""

from __future__ import annotations

import json
import time

import pytest

from conftest import ROOT, make_root, tiny_traffic

from fadbench.counts import encodec as encodec_counts

CELL = "encodec-48k.corpus"
TINY = "tiny.encodec48k"
SEED = 2**31 + 19


def config():
    return json.loads((ROOT / "fadbench" / "configs" / "encodec-48k.json").read_text())


def test_encodec_layers_by_hand():
    # 10 s at 48 kHz, two channels in; widths 32-64-128-256-512, strides 2, 4, 5, 8.
    def conv(cin, cout, k, t):
        return 2 * k * cin * cout * t

    hand = [("conv_in", conv(2, 32, 7, 480000))]
    for i, (dim, r, t) in enumerate([(32, 2, 480000), (64, 4, 240000), (128, 5, 60000),
                                     (256, 8, 12000)]):
        hand += [(f"stage{i + 1}.conv1", conv(dim, dim // 2, 3, t)),
                 (f"stage{i + 1}.conv2", conv(dim // 2, dim, 1, t)),
                 (f"stage{i + 1}.shortcut", conv(dim, dim, 1, t)),
                 (f"stage{i + 1}.down", conv(dim, 2 * dim, 2 * r, t // r))]
    # Two layers of 1500 steps, each an input and a recurrent 512 x 2048 product.
    hand += [("lstm", 2 * 1500 * 2 * 2 * 512 * 2048), ("conv_out", conv(512, 128, 7, 1500))]
    cfg = config()
    assert encodec_counts.layers(cfg) == hand
    total = sum(f for _, f in hand)
    assert total == 59_805_696_000  # 59.8 GFLOP a 10 s clip
    assert sum(f for n, f in hand if n not in ("lstm", "conv_out")) == 45_846_528_000
    # Every clip runs padded to 10 s: the count does not depend on its length.
    assert encodec_counts.model_flops_per_clip(cfg, 480000) == total
    assert encodec_counts.model_flops_per_clip(cfg, 24000) == total


def test_the_cell_finds_every_file_by_name():
    from fadbench import spec

    cell = spec.load_cell(CELL)
    assert cell.entry["chips"] == 1 and cell.config["model_name"] == "encodec-48k"
    assert cell.traffic["sample_rate"] == cell.config["sample_rate"] == 48000
    assert set(cell.limits) == {"fad_rel", "mean_rel", "cov_rel"}
    assert [m["name"] for m in cell.end_to_end] == ["device_s_per_audio_h", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "audio_min_per_s.encodec48k", "step_mfu.encodec48k", "device_idle_pct.encodec48k",
        "device_peak_gib.encodec48k", "encodec_groupnorm_ms_per_clip", "encodec_lstm_ms_per_clip"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    ref = cell.reference()
    assert all(callable(getattr(ref, f)) for f in ("build", "init_state", "embed"))
    assert cell.counter().model_flops_per_clip(cell.config, 480000) == 59_805_696_000


def test_a_tiny_encodec48k_cell_runs_on_the_cpu_and_is_correct(tmp_path):
    """Three clips of 0.5 s a side, two a side a call, two files a device
    program; every clip is still padded to 10 s and encoded whole."""
    from fadbench import harness

    root = make_root(tmp_path, "encodec-48k", TINY, limits_of=CELL)
    traffic = tiny_traffic(48000, 0.5)
    traffic["pools"] = {side: dict(law, clips=3) for side, law in traffic["pools"].items()}
    traffic["clips_per_call"] = {"background": 2, "eval": 2}
    (root / "fadbench" / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    result = harness.run_cell(TINY, SEED, 0.1, True, time.perf_counter(), device="cpu",
                              root=root, bench_dir=root / "fadbench")
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["correct"], result["checks"]
    m = result["metrics"]
    assert m["audio_min_per_s.encodec48k"]["value"] > 0
    assert 0 < m["step_mfu.encodec48k"]["value"] < 100
    # The CPU has no device trace: the layers' readers find nothing to read.
    assert "encodec_groupnorm_ms_per_clip" not in m and "encodec_lstm_ms_per_clip" not in m


def test_the_layer_readers_on_a_hand_built_trace():
    from fadbench import devtrace, harness, spec

    cell = spec.load_cell(CELL)
    calls = [{"failed": False, "clips": 1024}, {"failed": True, "clips": 1024}]
    run = harness.Run(cell=cell, setup_s=1.0, window_s=50.0, calls=calls, peak_window_bytes=0)
    gn, lstm = (cell.reader(n) for n in ("encodec_groupnorm_ms_per_clip",
                                          "encodec_lstm_ms_per_clip"))
    assert gn.read(run) is None and lstm.read(run) is None  # no trace
    kernel_s = {
        "void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>(long, float, "
        "float const*, float*, float*)": 2.0,
        "void at::native::(anonymous namespace)::ComputeFusedParamsCUDAKernel<float>(...)": 0.25,
        "void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::"
        "GroupNormKernelImplInternal<float, float>(...)::{lambda(float, float, float)#1}>": 1.5,
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_"
        "aligna4_alignc4_execute_kernel__5x_cublas": 3.0,
        "void elemWiseRNNcell<float, float, float, (cudnnRNNMode_t)2, (cudnnRNNBiasMode_t)2>"
        "(...)": 0.5,
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nt_align1>(...)": 0.125,
        "sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw": 9.0,
        "Memcpy HtoD (Pageable -> Device)": 1.0,
    }
    run.trace = devtrace.Trace(window_s=50.0, busy_s=17.375, kernel_s=kernel_s, idle_by_frame={})
    # Only the completed call's 1024 clips count; the failed call's kernels do.
    assert gn.read(run) == pytest.approx(1000.0 * 3.75 / 1024)
    assert lstm.read(run) == pytest.approx(1000.0 * 3.5 / 1024)
    run.trace.kernel_s = {"sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw": 9.0}
    assert gn.read(run) is None and lstm.read(run) is None  # such kernels off the path


CONTROLS = [
    ({}, True),
    ({"FAD_TPU_PRECISION": "high"}, False),
    ({"FAD_TPU_MODEL_DTYPE": "bfloat16"}, False),
    ({"FAD_TPU_LSTM_MATMUL": "bfloat16"}, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("env,correct", CONTROLS)
def test_lower_precision_fails_the_cells_limits(cuda_card, tmp_path, monkeypatch, env, correct):
    """float32 with TF32 off comes out correct against the reference on the
    cell's limits; TF32 products, a forced bf16 model and bf16 LSTM operands
    come out not correct, on 24 + 24 ten-second clips. The card is not
    traced: under torch.profiler the bf16 LSTM's CUDA-graph replays lost the
    trace's marker kernel on an H100, and the answers are what is held."""
    from fadbench import harness

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    root = make_root(tmp_path, "encodec-48k", TINY, limits_of=CELL)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for metric in bench["end_to_end"]:
        if metric["source"] == "device_trace":
            metric["workloads"].remove(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = tiny_traffic(48000, 10.0)
    traffic["pools"] = {side: dict(law, clips=24) for side, law in traffic["pools"].items()}
    traffic["clips_per_call"] = {"background": 16, "eval": 16}
    traffic["fad"] = {"audio_load_worker": 2}
    (root / "fadbench" / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    result = harness.run_cell(TINY, 2**31 + 11, 0.5, False, time.perf_counter(), device="cuda",
                              root=root, bench_dir=root / "fadbench")
    assert result["failed"] == 0
    assert result["correct"] is correct, result["checks"]
