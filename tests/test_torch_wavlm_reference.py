"""The port's WavLM encoder (models/wavlm.py) against the benchmark's plain
reference (fadbench/reference/wavlm.py), on the CPU at a small size: hidden
64, 4 heads of 16, 2 layers, 32 channels in the feature extractor, the
published kernels, strides, positional convolution and buckets, on 0.5 s
clips (24 frames) of the benchmark's own kind (noise falling as 1/f^tilt,
-36 to -18 dBFS).

The reference is written from HF's WavLMModel with none of the port: the
bucket function as HF writes it, the weight norm, the gate and the softmax
each forward, the gated bias materialised [B * H, T, T]. One state_dict
serves both; the port folds the weight norm and the gate's block-diagonal
columns once a load. The state is the benchmark's law with every LayerNorm's
affine and each gru_rel_pos_const drawn too, so that each parameter shows.

The bar on the rows is 1e-5 of the largest: float32 reads 8.4e-7 here (the
two sides sum the attention and the norms in other orders, and the port's
products run gemm_tf32's plain version), and each planted fault reads 0.13
or more.

The card cases (``cuda``) hold gemm_tf32's kernel to its plain version at the
encoder's shapes, 1024 deep with LN on load and 4096 deep with GELU on load.
"""

import ast
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fadbench import corpus
from fadbench.reference import stats as ref_stats
from fadbench.reference import wavlm as ref
from frechet_audio_distance_exported_tpu_torch import fad as fad_module
from frechet_audio_distance_exported_tpu_torch import pipeline
from frechet_audio_distance_exported_tpu_torch.models import wavlm
from frechet_audio_distance_exported_tpu_torch.ops import launches, window_attn

torch.set_num_threads(2)
REPO_ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((REPO_ROOT / "fadbench" / "configs" / "wavlm-large.json").read_text())
SMALL = dict(CFG, conv_dim=[32] * 7, hidden_size=64, num_attention_heads=4,
             num_hidden_layers=2, intermediate_size=256)
PORT_SMALL = wavlm.WavLMConfig(conv_dim=(32,) * 7, hidden=64, layers=2, heads=4, intermediate=256)
# 12 times the 8.4e-7 that float32 reads, 1.4e4 times below the nearest fault.
BAR = 1e-5


def clips(samples: int, seed: int = 5) -> torch.Tensor:
    """int16 [2, samples]: one background-like and one eval-like clip."""
    traffic = json.loads((REPO_ROOT / "fadbench" / "traffic" / "corpus512_16k.json").read_text())
    traffic = dict(traffic, clip_seconds=samples / 16000,
                   pools={s: dict(v, clips=1) for s, v in traffic["pools"].items()})
    pools = corpus.make_pools(traffic, seed, "cpu")
    return torch.from_numpy(np.concatenate([pools["background"], pools["eval"]]))


def random_state(seed: int = 1) -> dict:
    gen = torch.Generator().manual_seed(seed)
    state = ref.init_state(SMALL, gen, "cpu")
    for key, value in state.items():
        if key.endswith("layer_norm.weight") or key.endswith("gate_const"):
            state[key] = 1.0 + 0.2 * torch.randn(value.shape, generator=gen)
        elif key.endswith("layer_norm.bias"):
            state[key] = 0.1 * torch.randn(value.shape, generator=gen)
    return state


def models(state):
    port = wavlm.WavLM(PORT_SMALL).eval()
    port.load_state_dict(state)
    plain = ref.build(SMALL, "cpu")
    plain.load_state_dict(state)
    return port, plain


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.fixture(scope="module")
def reference_rows():
    """The reference's rows of two 0.5 s clips, its model and the state."""
    state = random_state()
    _, plain = models(state)
    pcm = clips(8000)
    with torch.inference_mode():
        return state, plain, pcm, ref.embed(plain, pcm)


@pytest.mark.parametrize("samples", [8000, 7777, 4000])
def test_port_matches_the_reference(samples):
    """0.5 s, a length every stride leaves a remainder of, and 0.25 s."""
    state = random_state(samples)
    port, plain = models(state)
    pcm = clips(samples, seed=samples)
    with torch.inference_mode():
        want = ref.embed(plain, pcm)
        got = port(pcm.to(torch.float32) / 32768.0)
    frames = wavlm.num_frames(samples, PORT_SMALL)
    assert got.shape == want.shape == (2, frames, 64)
    assert rel_err(got, want) < BAR


def test_state_keys_are_shared():
    port, plain = models(random_state())
    assert list(port.state_dict()) == list(plain.state_dict())


@pytest.mark.parametrize("rel, bucket", [
    (0, 0), (1, 161), (-1, 1), (79, 239), (-79, 79), (80, 240), (-80, 80), (81, 240),
    (-81, 80), (498, 303), (-498, 143), (900, 319), (-900, 159),
])
def test_bucket_by_hand(rel, bucket):
    """160 buckets a side (s > t the upper half), exact below 80, then 80 +
    trunc(ln(|r| / 80) / ln(10) * 80) up to 159: 81 -> 80 (0.43), 498 -> 143
    (63.5), 900 -> 164, clamped to 159."""
    r = torch.tensor([rel])
    assert wavlm.relative_bucket(r).item() == bucket
    assert ref.relative_bucket(r, 320, 800).item() == bucket


def test_bucket_port_equals_reference_everywhere():
    r = torch.arange(-4000, 4001)
    assert torch.equal(wavlm.relative_bucket(r), ref.relative_bucket(r, 320, 800))


def test_position_bias_gathers_the_table():
    port, _ = models(random_state())
    table = port.encoder.rel_attn_embed
    bias = port.encoder.position_bias(30)
    assert bias.shape == (4, 30, 30)
    for t, s in ((0, 0), (3, 29), (29, 3), (10, 11)):
        bucket = wavlm.relative_bucket(torch.tensor(s - t)).item()
        assert torch.equal(bias[:, t, s], table[bucket])


def test_weight_norm_and_gate_fold():
    """The port's folded positional weight is torch's weight_norm(dim=2) of
    (g, v); its qkvg columns are qkv's, then each head's gate block."""
    port, plain = models(random_state())
    conv = torch.nn.Conv1d(64, 64, 128, padding=64, groups=16)
    conv = torch.nn.utils.parametrizations.weight_norm(conv, dim=2)
    with torch.no_grad():
        conv.parametrizations.weight.original0.copy_(plain.encoder.pos_conv.weight_g)
        conv.parametrizations.weight.original1.copy_(plain.encoder.pos_conv.weight_v)
        assert rel_err(port.encoder.pos_conv.weight, conv.weight) < 1e-6
    a = port.encoder.layers[1].attention
    assert torch.equal(a.qkvg_w[:, :192], a.qkv.w)
    assert torch.equal(a.qkvg_b[:192], a.qkv.b)
    for h in range(4):
        assert torch.equal(a.qkvg_w[16 * h : 16 * h + 16, 192 + 8 * h : 200 + 8 * h], a.gate.w)
        assert torch.equal(a.qkvg_b[192 + 8 * h : 200 + 8 * h], a.gate.b)
    assert int((a.qkvg_w[:, 192:] != 0).sum()) == int((a.gate.w != 0).sum()) * 4


def _gate_one(self, h, position_bias):
    """The reference's attention with the gate held at 1."""
    b, t, c = h.shape
    heads, d = self.heads, c // self.heads
    bias = position_bias.unsqueeze(0).repeat(b, 1, 1, 1).view(b * heads, t, t)
    q, k, v = self.qkv(h).split(c, dim=-1)

    def split(z):
        return z.view(b, t, heads, d).transpose(1, 2).reshape(b * heads, t, d)

    probs = torch.softmax(torch.baddbmm(bias, split(q) * d ** -0.5, split(k).transpose(1, 2)), -1)
    ctx = torch.bmm(probs, split(v)).view(b, heads, t, d).transpose(1, 2)
    return self.out(ctx.reshape(b, t, c))


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, as TF32 products take their operands."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("fault, factor", [
    ("gated_bias_dropped", 100), ("gate_at_one", 100), ("layer_skipped", 100),
    ("tf32_products", 10),
])
def test_planted_faults_fail_the_bar(reference_rows, monkeypatch, fault, factor):
    """Each fault, planted in the reference, moves its rows far past the bar:
    the gated bias dropped (0.30), the gate held at 1 (0.14), the last layer
    skipped (0.44); TF32 operands in the linear products (about 1e-3), ten
    bars or more: so the comparison holds the float32 path."""
    state, plain, pcm, want = reference_rows
    if fault == "gated_bias_dropped":
        forward = ref.Attention.forward
        monkeypatch.setattr(ref.Attention, "forward",
                            lambda self, h, pb: forward(self, h, torch.zeros_like(pb)))
    elif fault == "gate_at_one":
        monkeypatch.setattr(ref.Attention, "forward", _gate_one)
    elif fault == "layer_skipped":
        monkeypatch.setattr(plain.encoder, "layers", plain.encoder.layers[:1])
    else:
        monkeypatch.setattr(ref.Dense, "forward",
                            lambda self, x: torch.matmul(_tf32(x), _tf32(self.w)) + self.b)
    with torch.inference_mode():
        got = ref.embed(plain, pcm)
    assert rel_err(got, want) > factor * BAR


def test_reference_embed_reads_pcm16(reference_rows):
    """embed() hands the model k / 32768."""
    _, plain, pcm, want = reference_rows
    with torch.inference_mode():
        assert torch.equal(plain(pcm.to(torch.float32) / 32768.0), want)


class _SmallFamily(pipeline.WavLMFamily):
    build = staticmethod(lambda rate: wavlm.WavLM(PORT_SMALL))


def _small_fad(monkeypatch, state, tmp_path, **kwargs):
    monkeypatch.setitem(pipeline.FAMILIES, "wavlm", _SmallFamily)
    monkeypatch.setattr(fad_module.weight_store, "get_params",
                        lambda *a, **k: {key: v.clone() for key, v in state.items()})
    return fad_module.FrechetAudioDistance(model_name="wavlm-large", weights="random",
                                           device="cpu", ckpt_dir=str(tmp_path / "ck"), **kwargs)


@pytest.mark.parametrize("device_stats", [False, True])
def test_score_end_to_end(monkeypatch, tmp_path, device_stats):
    """score() on WAV directories (three 0.5 s clips and a 0.3 s one a side)
    through FAMILIES["wavlm"] equals the FAD of the reference's rows."""
    state = random_state(3)
    pcm = {side: clips(8000, seed=s) for side, s in (("bg", 11), ("ev", 12))}
    short = clips(4800, seed=13)
    dirs = {}
    for side, arr in pcm.items():
        d = tmp_path / side
        d.mkdir()
        files = [arr[0], arr[1], arr[0] // 3, short[0 if side == "bg" else 1]]
        for i, x in enumerate(files):
            (d / f"{i}.wav").write_bytes(corpus.wav_bytes(x.numpy(), 16000))
        dirs[side] = (d, files)
    fad = _small_fad(monkeypatch, state, tmp_path, file_batch=2)
    launches.zero()
    score = fad.score(str(dirs["bg"][0]), str(dirs["ev"][0]), device_stats=device_stats)
    assert launches.read()["wavlm_gemm"] == 0  # the plain version does not count
    _, plain = models(state)
    moments = []
    with torch.inference_mode():
        for side in ("bg", "ev"):
            rows = torch.cat([ref.embed(plain, x[None]).reshape(-1, 64) for x in dirs[side][1]])
            assert rows.shape[0] == 3 * 24 + 14
            moments += ref_stats.mean_cov(rows)
    want = ref_stats.frechet_distance(*moments)
    assert want > 1.0
    assert math.isclose(score, want, rel_tol=1e-4)


def test_family_groups_by_exact_length_and_caps_long_files():
    family = pipeline.WavLMFamily(16000, torch.device("cpu"))
    items = [pipeline.Item(i, 0, np.zeros(n, np.int16), wavlm.num_frames(n))
             for i, n in enumerate([160000, 160000, 80000, 160001, 480000, 160000])]
    chunks = family.chunks(items, 64, 0)
    assert [([it.file for it in c], b, length) for c, b, length in chunks] == [
        ([2], 1, 80000), ([0, 1, 5], 4, 160000), ([3], 1, 160001), ([4], 1, 480000)]
    # 30 s files: T = 1499, so a ninth of the batch.
    assert family.group(items[4], 64, 0) == (480000, 7)
    with pytest.raises(ValueError, match="too short"):
        family.prep(np.zeros(399, np.int16), 16000, True)
    row, frames = family.prep(np.zeros(400, np.int16), 16000, True)
    assert frames == 1 and row.dtype == np.int16


@pytest.mark.parametrize("kwargs, error", [
    (dict(gelu=True), ValueError),  # GELU on load takes the residual
    (dict(residual="r", ln="ln"), ValueError),  # LN on load takes none
    (dict(), ValueError),  # nothing on load takes the residual
    (dict(residual="r", dtype=torch.float64), TypeError),
    (dict(residual="r", k=48, w_k=32), ValueError),
])
def test_gemm_refusals(kwargs, error):
    k, n, m = kwargs.pop("k", 64), 32, 5
    dtype = kwargs.pop("dtype", torch.float32)
    a = torch.randn(m, k, dtype=dtype)
    w = torch.randn(kwargs.pop("w_k", k), n)
    if kwargs.get("residual") == "r":
        kwargs["residual"] = torch.randn(m, n)
    if kwargs.get("ln") == "ln":
        kwargs["ln"] = (torch.ones(k), torch.zeros(k))
    with pytest.raises(error):
        window_attn.gemm_tf32(a, w, torch.zeros(n), key="wavlm_gemm", **kwargs)


def test_gemm_plain_forms():
    gen = torch.Generator().manual_seed(0)
    a, w, b, r = (torch.randn(s, generator=gen) for s in ((6, 32), (32, 64), (64,), (6, 64)))
    g, beta = torch.randn(32, generator=gen), torch.randn(32, generator=gen)
    ln = torch.nn.functional.layer_norm(a, (32,), g, beta, 1e-5)
    launches.zero()
    got = window_attn.gemm_tf32(a, w, b, key="wavlm_gemm", ln=(g, beta))
    assert torch.allclose(got, ln @ w + b, atol=1e-5)
    got = window_attn.gemm_tf32(a, w, b, key="wavlm_gemm", gelu=True, residual=r)
    assert torch.allclose(got, r + (torch.nn.functional.gelu(a) @ w + b), atol=1e-5)
    assert torch.equal(window_attn.gemm_tf32(a, w, b, key="wavlm_gemm", residual=r),
                       r + (a @ w + b))
    assert launches.read()["wavlm_gemm"] == 0  # the plain version launches nothing


def test_reference_imports_neither_jax_nor_the_port():
    source = REPO_ROOT / "fadbench" / "reference" / "wavlm.py"
    tops = set()
    for node in ast.walk(ast.parse(source.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    assert tops == {"__future__", "math", "typing", "torch"}
    forbidden = {"jax", "jaxlib", "flax", "frechet_audio_distance_exported_tpu",
                 "frechet_audio_distance_exported_tpu_torch"}
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import fadbench.reference.wavlm\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))") % (
        str(REPO_ROOT), forbidden)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---- on the card ----

# name -> (M, K, N, form): the encoder's products at a 64-clip chunk's 31936
# rows cut to 4 clips' 1996 (a ragged last tile of 128 rows).
CARD_CASES = {
    "qkvg_ln_k1024": (1996, 1024, 3200, "ln"),
    "fc2_gelu_k4096": (1996, 4096, 1024, "gelu"),
    "proj_residual_k1024": (1996, 1024, 1024, "plain"),
    "projection_ln_k512": (1996, 512, 1024, "ln"),
}
CARD_ATOL = 1e-4  # kernel against the plain version on the card: float32 both, other sum orders


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_gemm_kernel_matches_its_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m, k, n, form = CARD_CASES[case]
    gen = torch.Generator().manual_seed(k + n)
    dev = torch.device("cuda")

    def draw(*shape, scale=1.0, offset=0.0):
        return (offset + scale * torch.randn(shape, generator=gen)).to(dev)

    a, w, b = draw(m, k), draw(k, n, scale=k ** -0.5), draw(n, scale=0.1)
    kwargs = {}
    if form == "ln":
        kwargs["ln"] = (draw(k, scale=0.2, offset=1.0), draw(k, scale=0.1))
    else:
        kwargs.update(residual=draw(m, n), gelu=form == "gelu")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        launches.zero()
        ln = None
        if form == "ln":
            ln = wavlm.LayerNorm(k).to(dev)
            ln.weight.copy_(kwargs["ln"][0])
            ln.bias.copy_(kwargs["ln"][1])
        got = wavlm._linear(a, w, b, ln=ln, gelu=kwargs.get("gelu", False),
                            residual=kwargs.get("residual"))
        assert launches.read()["wavlm_gemm"] == 1
        want = window_attn.gemm_tf32_reference(a, w, b, kwargs.get("ln"),
                                               kwargs.get("gelu", False), kwargs.get("residual"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert (got - want).abs().max().item() < CARD_ATOL
    again = window_attn.gemm_tf32(a, w, b, key="wavlm_gemm", **kwargs)
    assert torch.equal(got, again)
    assert launches.read()["wavlm_gemm"] == 2
    # No rows: nothing launches, and nothing is counted.
    empty = window_attn.gemm_tf32(a[:0], w, b, key="wavlm_gemm", **{
        name: t[:0] if name == "residual" else t for name, t in kwargs.items()})
    assert empty.shape == (0, n) and launches.read()["wavlm_gemm"] == 2
