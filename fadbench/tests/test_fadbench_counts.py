"""The FLOP and byte counters behind step_mfu and the kernel rooflines,
against layer-by-layer counts worked out by hand at the published shapes."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT

from fadbench.counts import clap as clap_counts
from fadbench.counts import vggish as vggish_counts


def config(name):
    return json.loads((ROOT / "fadbench" / "configs" / f"{name}.json").read_text())


def load_metric(name):
    from fadbench import spec

    return spec.Cell(name="", entry={}, config={}, traffic={}, limits={}, end_to_end=[],
                     per_layer=[], bench_dir=ROOT / "fadbench").reader(name)


def test_vggish_layers_by_hand():
    # 3x3 convolutions, 2 FLOPs a multiply-add, at 96x64, 48x32, 24x16, 12x8.
    hand = [
        ("conv1", 2 * 9 * 1 * 64 * 96 * 64),
        ("conv2", 2 * 9 * 64 * 128 * 48 * 32),
        ("conv3", 2 * 9 * 128 * 256 * 24 * 16),
        ("conv4", 2 * 9 * 256 * 256 * 24 * 16),
        ("conv5", 2 * 9 * 256 * 512 * 12 * 8),
        ("conv6", 2 * 9 * 512 * 512 * 12 * 8),
        ("fc1", 2 * 512 * 6 * 4 * 4096),
        ("fc2", 2 * 4096 * 4096),
        ("fc3", 2 * 4096 * 128),
    ]
    cfg = config("vggish")
    assert vggish_counts.layers(cfg) == hand
    per_patch = sum(f for _, f in hand)
    assert per_patch == 1_727_791_104  # about 1.73 GFLOP a 0.96 s patch
    # 10 s at 16 kHz: 998 frames, 10 complete patches.
    assert vggish_counts.model_flops_per_clip(cfg, 160000) == 10 * per_patch
    assert vggish_counts.model_flops_per_clip(cfg, 15000) == 0


def test_clap_layers_by_hand():
    def block(t, c):  # qkv, q k^T, p v, proj, fc1, fc2 over windows of 64 tokens
        return 2 * t * c * 3 * c + 2 * 2 * t * 64 * c + 2 * t * c * c + 2 * 2 * t * c * 4 * c

    hand = [
        ("patch_embed", 2 * 16 * 96 * 4096),
        ("stage1_blocks", 2 * block(4096, 96)),
        ("merge1", 2 * 1024 * 384 * 192),
        ("stage2_blocks", 2 * block(1024, 192)),
        ("merge2", 2 * 256 * 768 * 384),
        ("stage3_blocks", 6 * block(256, 384)),
        ("merge3", 2 * 64 * 1536 * 768),
        ("stage4_blocks", 2 * block(64, 768)),
        ("projection", 2 * 768 * 512 + 2 * 512 * 512),
    ]
    cfg = config("clap")
    assert clap_counts.layers(cfg) == hand
    assert clap_counts.model_flops_per_clip(cfg, 480000) == sum(f for _, f in hand)
    assert sum(f for _, f in hand) == pytest.approx(11.82e9, rel=1e-3)


def test_vggish_logmel_bytes_by_hand():
    metric = load_metric("vggish_logmel_roofline_pct")
    flops, nbytes = metric.clip_work(config("vggish"), 160000)
    # 960 frames read 959 * 160 + 400 float32 samples and write 960 x 64 float32.
    assert nbytes == 4 * (959 * 160 + 400) + 4 * 960 * 64
    # 64 clips: the 55.1 MB of the kernel's byte bound in PERF.md's kernel table.
    assert 64 * nbytes == pytest.approx(55.1e6, rel=1e-3)
    # The bytes bound it: the FLOPs at the TF32 rate take under a fifth of the time.
    assert flops / 495e12 < 0.2 * nbytes / 3.35e12


def test_swin_kernel_flops_by_hand():
    metric = load_metric("swin_roofline_pct")
    flops, act, weights = metric.work(config("clap"))

    def attention(t, c):
        return 2 * t * c * 3 * c + 2 * 2 * t * 64 * c + 2 * t * c * c

    whole = 2 * (attention(4096, 96) + 2 * 2 * 4096 * 96 * 384)
    whole += 2 * (attention(1024, 192) + 2 * 2 * 1024 * 192 * 768)
    whole += 6 * (attention(256, 384) + 2 * 2 * 256 * 384 * 1536)
    assert flops == whole + 2 * attention(64, 768)
    # swin_block_fused alone on a 64-clip chunk: the 609 GFLOP of PERF.md.
    assert 64 * whole == pytest.approx(609e9, rel=1e-3)
    # The FLOPs bound it: bytes at HBM bandwidth take under a third of the time.
    assert act / 3.35e12 < flops / 495e12 / 3
