"""The port's Swin window kernels (ops/window_attn.py) against the JAX package's.

The same numpy inputs go through the JAX Pallas kernels in interpret mode
(as tests/test_pallas_window_attn.py runs them on the CPU) and through the
port's plain torch versions, which its wrappers run for CPU tensors:
- swin_block_fused at stage 1 (C 96, 4 heads, 64 windows per image; shifted
  and not) and stage 3 (C 384, 16 heads, 4 windows, shifted);
- window_attention_fused at stage 4 (C 768, 32 heads, 1 window) and at
  stage 1 (shifted).
Inputs are scaled as in test_pallas_window_attn.py:22-34 (x 0.5, weights
0.05, biases 0.01, LayerNorm gamma 1 +- 0.1 and beta 0.1).

Bound: atol 2e-5. Both sides are float32; they differ in summation order,
in the LayerNorm's form and in the Pallas kernel's Abramowitz-Stegun erf
(about 1.5e-7) against torch's exact erf. The JAX suite holds its two paths
to 2-3e-6 at C = 96, and C = 768 sums eight times longer.

The CUDA kernels run only on the card: their cases carry the `cuda` marker
and skip without one. Their arithmetic, 3xTF32 products on the tensor cores
(csrc/window_attn.cu), is emulated here against float64 at every GEMM shape
they run: in torch, each product folded once a 32-deep slab, and in a numpy
float32 model of gemm_tf32_kernel (the weights split once by tf32_split,
K-major; the activations split by split_tf32's integer bits after the
LayerNorm applied on load; the slab fold; the epilogues). The plain
tf32_split and the wrapper's checks (the split's refusals, the scratch of
window_attention_fused, every card case) are held to what the kernels take.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from frechet_audio_distance_exported_tpu_torch.models.clap import (  # noqa: E402
    _relative_position_index,
    _shift_attn_mask,
)
from frechet_audio_distance_exported_tpu_torch.ops import launches, window_attn  # noqa: E402

N, WS = 64, 8
ATOL = 2e-5
CARD_ATOL = 1e-4  # kernel vs plain on the card: float32 both, other sum orders

# name -> (kernel, C, heads, windows per image, shifted, batch)
CASES = {
    "block_stage1": ("swin_block_fused", 96, 4, 64, False, 1),
    "block_stage1_shifted": ("swin_block_fused", 96, 4, 64, True, 1),
    "block_stage3_shifted": ("swin_block_fused", 384, 16, 4, True, 2),
    "attention_stage4": ("window_attention_fused", 768, 32, 1, False, 2),
    "attention_stage1_shifted": ("window_attention_fused", 96, 4, 64, True, 1),
}


def make_inputs(c, heads, nw, shifted, batch, seed=0):
    """Keyword arguments of swin_block_fused as float32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale, offset=0.0):
        return (offset + scale * rng.standard_normal(shape)).astype(np.float32)

    table = normal(((2 * WS - 1) ** 2, heads), 0.1)
    idx = _relative_position_index(WS).reshape(-1)
    bias = np.ascontiguousarray(table[idx].reshape(N, N, heads).transpose(2, 0, 1))
    res = WS * int(round(np.sqrt(nw)))
    mask = _shift_attn_mask(res, WS, WS // 2) if shifted else np.zeros((1, N, N), np.float32)
    return {
        "x_windows": normal((batch * nw, N, c), 0.5),
        "w_qkv": normal((c, 3 * c), 0.05), "b_qkv": normal((3 * c,), 0.01),
        "w_proj": normal((c, c), 0.05), "b_proj": normal((c,), 0.01),
        "bias": bias, "mask": mask,
        "gamma1": normal((c,), 0.1, 1.0), "beta1": normal((c,), 0.1),
        "gamma2": normal((c,), 0.1, 1.0), "beta2": normal((c,), 0.1),
        "w_fc1": normal((c, 4 * c), 0.05), "b_fc1": normal((4 * c,), 0.01),
        "w_fc2": normal((4 * c, c), 0.05), "b_fc2": normal((c,), 0.01),
    }


ATTENTION_KEYS = ("x_windows", "w_qkv", "b_qkv", "w_proj", "b_proj", "bias", "mask",
                  "gamma1", "beta1")


def operands(kernel, arrays, device="cpu"):
    keys = ATTENTION_KEYS if kernel == "window_attention_fused" else tuple(arrays)
    return {k: torch.from_numpy(arrays[k]).to(device) for k in keys}


# (stage, product) -> (K, N) of the kernels' GEMMs on one window (64 rows):
# qkv C -> 3C, proj C -> C, fc1 C -> 4C, fc2 4C -> C at stages 1-3 (C 96,
# 192, 384); qkv and proj at stage 4 (C 768, window_attention_fused).
GEMMS = {
    f"stage{i + 1}_{name}": shape
    for i, c in enumerate((96, 192, 384))
    for name, shape in (("qkv", (c, 3 * c)), ("proj", (c, c)), ("fc1", (c, 4 * c)),
                        ("fc2", (4 * c, c)))
}
GEMMS.update(stage4_qkv=(768, 3 * 768), stage4_proj=(768, 768))
SPLIT_RTOL = 2e-6


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does: add half a TF32 ulp to the magnitude
    bits, then clear the 13 low bits (the kernels' split_tf32 forms hi so)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a: torch.Tensor, b: torch.Tensor, split: bool, fold: int = 32) -> torch.Tensor:
    """a @ b as the kernels form it, in folds of `fold` deep (32: one slab,
    as gemm_tf32_kernel folds; 8: one k-step, as the attention's mma.sync
    products fold): each fold's products summed exactly (float64),
    rounded to float32 and added to a float32 accumulator. split: 3xTF32
    (a_lo b_hi + a_hi b_lo + a_hi b_hi with hi = tf32(x), lo = tf32(x - hi));
    otherwise plain 1xTF32 (a_hi b_hi)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    k = a.shape[1]

    def steps(x, y):  # [K/fold, M, N]: the product of each fold
        return torch.einsum("msk,skn->smn", x.double().reshape(-1, k // fold, fold),
                            y.double().reshape(k // fold, fold, -1))

    partial = steps(a_hi, b_hi)
    if split:
        partial = steps(a_lo, b_hi) + steps(a_hi, b_lo) + partial
    acc = torch.zeros(partial.shape[1:], dtype=torch.float32)
    for step in partial.float():
        acc += step
    return acc


@pytest.mark.parametrize("gemm", sorted(GEMMS))
def test_3xtf32_products_keep_float32_accuracy(gemm):
    """At each GEMM shape of the kernels, on one window's 64 rows, inputs
    scaled as the smoke run's (x after LayerNorm about 1, weights 0.05): the
    3xTF32 product, folded once a 32-deep slab as gemm_tf32_kernel folds, is
    within 2e-6 of a float64 matmul, relative to its largest entry, and
    1xTF32 is not (about 1e-3): the split is what keeps the port's float32
    rule."""
    k, n = GEMMS[gemm]
    rng = np.random.default_rng(k + n)
    a = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32))
    b = torch.from_numpy((0.05 * rng.standard_normal((k, n))).astype(np.float32))
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    split_err = float((_tf32_product(a, b, True).double() - exact).abs().max()) / scale
    plain_err = float((_tf32_product(a, b, False).double() - exact).abs().max()) / scale
    assert split_err <= SPLIT_RTOL, f"3xTF32 {split_err:.3e}"
    assert plain_err > 100 * SPLIT_RTOL, f"1xTF32 {plain_err:.3e}"


@pytest.mark.parametrize("gemm", ["qkv", "proj"])
def test_3xtf32_token_tile_gemm_keeps_float32_accuracy(gemm):
    """window_attention_fused's GEMMs at stage 4 on one [128, 768] token tile
    (gemm_3xtf32_kernel's BM rows), each slab of 32 folded as the kernel
    does, with the epilogue (+ bias; proj also + the residual x): within
    SPLIT_RTOL of float64, relative to the largest output. A is LN1(x) (about
    1) for qkv and attn (softmax averages of v, about 0.3) for proj."""
    c = 768
    n = 3 * c if gemm == "qkv" else c
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.standard_normal((128, c)).astype(np.float32))
    if gemm == "proj":
        a = a * 0.3
    b = torch.from_numpy((0.05 * rng.standard_normal((c, n))).astype(np.float32))
    bias = torch.from_numpy((0.01 * rng.standard_normal(n)).astype(np.float32))
    x = torch.from_numpy((0.5 * rng.standard_normal((128, n))).astype(np.float32))
    ours = _tf32_product(a, b, True, fold=32) + bias
    exact = a.double() @ b.double() + bias.double()
    if gemm == "proj":
        ours, exact = x + ours, x.double() + exact
    err = float((ours.double() - exact).abs().max()) / float(exact.abs().max())
    assert err <= SPLIT_RTOL, f"{gemm}: 3xTF32 {err:.3e}"


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp / 2 - 2 ** -23, -(1.0 + one_ulp / 2),
                      1.0 + 3 * one_ulp / 2], dtype=torch.float32)
    expected = torch.tensor([1.0, 1.0 + one_ulp, 1.0, -(1.0 + one_ulp), 1.0 + 2 * one_ulp])
    assert torch.equal(_tf32(x), expected)


# ---------------------------------------------------------------------------
# gemm_tf32_kernel's arithmetic as a numpy float32 model
# ---------------------------------------------------------------------------

def _split_np(a: np.ndarray) -> tuple:
    """(hi, lo) of float32 a by split_tf32's two integer operations each
    (csrc/wgmma_tf32.cuh): hi = tf32(a), lo = tf32(a - hi), to nearest with
    ties away from zero."""
    def rna(v):
        bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)

    hi = rna(a)
    return hi, rna((a - hi).astype(np.float32))


def _gemm_model(a, w_split, bias, stats=None, gamma=None, beta=None, on_load=None,
                residual=None):
    """gemm_tf32_kernel in float32: op(a) as A is read (on_load "ln": (v -
    mean) * rstd * gamma + beta; "gelu": GELU(v); both float32), split in
    registers; the weight as tf32_split gives it ([2, N, K], K-major); per
    32-deep slab the three products (a_lo b_hi + a_hi b_lo + a_hi b_hi)
    summed exactly and rounded once (a fresh accumulator), folded into a
    float32 total; then + bias (and the residual), in float32."""
    if on_load == "ln":
        mean, rstd = stats[:, :1], stats[:, 1:]
        a = ((a - mean) * rstd * gamma + beta).astype(np.float32)
    elif on_load == "gelu":
        a = _gelu(torch.from_numpy(a)).numpy()
    a_hi, a_lo = _split_np(a)
    b_hi, b_lo = (w_split[i].T.astype(np.float64) for i in (0, 1))
    total = np.zeros((a.shape[0], w_split.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 32):
        sl = slice(k0, k0 + 32)
        hi, lo = a_hi[:, sl].astype(np.float64), a_lo[:, sl].astype(np.float64)
        part = lo @ b_hi[sl] + hi @ b_lo[sl] + hi @ b_hi[sl]
        total = (total + part.astype(np.float32)).astype(np.float32)
    out = (total + bias).astype(np.float32)
    if residual is not None:
        out = (residual + out).astype(np.float32)
    return out


def _gelu(t):
    """Exact (erf) GELU, torch's, on a tensor."""
    return torch.nn.functional.gelu(t)


def _stats(x: np.ndarray) -> np.ndarray:
    """row_stats_kernel's (mean, 1 / sqrt(var + eps)), two-pass, in float32."""
    mean = x.mean(axis=1, dtype=np.float32)
    var = ((x - mean[:, None]) ** 2).mean(axis=1, dtype=np.float32)
    return np.stack([mean, 1.0 / np.sqrt(var + np.float32(1e-5))], axis=1).astype(np.float32)


# (kernel's GEMM) -> (input width, output width, applied on load, residual, input scale) at
# stage 3's width (C 384) and stage 4's (C 768) on one [128, *] token tile. fc2 reads fc1's
# output before GELU (about 1) and applies GELU as it loads it.
MODEL_GEMMS = {
    "stage3_qkv": (384, 3 * 384, "ln", False, 0.5),
    "stage3_proj": (384, 384, None, True, 0.3),
    "stage3_fc1": (384, 4 * 384, "ln", False, 0.5),
    "stage3_fc2": (4 * 384, 384, "gelu", True, 1.0),
    "stage4_qkv": (768, 3 * 768, "ln", False, 0.5),
    "stage4_proj": (768, 768, None, True, 0.3),
}


@pytest.mark.parametrize("gemm", sorted(MODEL_GEMMS))
def test_wgmma_3xtf32_gemm_model_keeps_float32_accuracy(gemm):
    """The model of gemm_tf32_kernel, with the weight split once by the
    plain tf32_split, is within SPLIT_RTOL of float64 (the LayerNorm, the
    product, the bias and the epilogue in float64 on the same inputs),
    relative to the largest output, at each GEMM of stage 3 and stage 4."""
    k, n, on_load, has_residual, scale = MODEL_GEMMS[gemm]
    rng = np.random.default_rng(k + n)
    a = (scale * rng.standard_normal((128, k))).astype(np.float32)
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    bias = (0.01 * rng.standard_normal(n)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(k)).astype(np.float32)
    residual = (0.5 * rng.standard_normal((128, n))).astype(np.float32) if has_residual else None
    w_split = window_attn.tf32_split(torch.from_numpy(w)).numpy()
    stats = _stats(a) if on_load == "ln" else None
    ours = _gemm_model(a, w_split, bias, stats, gamma, beta, on_load, residual)

    exact = a.astype(np.float64)
    if on_load == "ln":
        mean = exact.mean(axis=1, keepdims=True)
        var = ((exact - mean) ** 2).mean(axis=1, keepdims=True)
        exact = (exact - mean) / np.sqrt(var + 1e-5) * gamma + beta
    elif on_load == "gelu":
        exact = _gelu(torch.from_numpy(exact)).numpy()
    exact = exact @ w.astype(np.float64) + bias
    if has_residual:
        exact = residual + exact
    err = float(np.abs(ours - exact).max()) / float(np.abs(exact).max())
    assert err <= SPLIT_RTOL, f"{gemm}: {err:.3e}"


@pytest.mark.parametrize("gemm", sorted(GEMMS))
def test_tf32_split_plain_version_is_the_kernels_layout(gemm):
    """tf32_split on the CPU: [2, out, in], hi = tf32(w^T) and lo =
    tf32(w^T - hi) (the test's own rounding), each TF32-exact (13 low bits
    clear), hi + lo within 2^-22 of w^T, and the numpy model's split of w^T
    gives the same bits."""
    k, n = GEMMS[gemm]
    rng = np.random.default_rng(k * n)
    w = torch.from_numpy((0.05 * rng.standard_normal((k, n))).astype(np.float32))
    split = window_attn.tf32_split(w)
    assert split.shape == (2, n, k) and split.dtype == torch.float32 and split.is_contiguous()
    hi, lo = split
    assert torch.equal(hi, _tf32(w.T.contiguous()))
    assert torch.equal(lo, _tf32(w.T.contiguous() - hi))
    assert not bool((split.view(torch.int32) & 0x1FFF).any())
    rel = ((hi.double() + lo.double() - w.T.double()).abs() / w.T.double().abs().clamp_min(1e-30))
    assert float(rel.max()) <= 2.0 ** -22
    np_hi, np_lo = _split_np(w.T.contiguous().numpy())
    assert np.array_equal(np_hi, hi.numpy()) and np.array_equal(np_lo, lo.numpy())


@pytest.mark.parametrize("bad, message", [
    (lambda w: w.double(), "float32"),
    (lambda w: w[0], "float32 \\[in, out\\]"),
    (lambda w: w[:, :48], "multiples of 32"),
    (lambda w: w[:80], "multiples of 32"),
    (lambda w: w.to("meta"), "CPU or CUDA"),
])
def test_tf32_split_refuses_what_the_kernel_does_not_take(bad, message):
    w = torch.zeros((96, 288), dtype=torch.float32)
    with pytest.raises(ValueError, match=message):
        window_attn.tf32_split(bad(w))


# name -> (kernel, C, heads, windows per image, shifted, images): every CLAP width, and ragged
# BWs (nine windows an image, a 24 x 24 token grid shifted: nine masks, window w using
# mask[w % 9]) whose token count leaves the GEMMs' last 128-row tile half empty.
CARD_CASES = {
    "block_c96": ("swin_block_fused", 96, 4, 64, True, 2),
    "block_c96_ragged": ("swin_block_fused", 96, 4, 9, True, 7),
    "block_c192": ("swin_block_fused", 192, 8, 16, True, 4),
    "block_c192_ragged": ("swin_block_fused", 192, 8, 9, True, 3),
    "block_c384": ("swin_block_fused", 384, 16, 4, False, 8),
    "block_c384_ragged": ("swin_block_fused", 384, 16, 9, True, 1),
    "attention_c768": ("window_attention_fused", 768, 32, 1, False, 4),
    "attention_c768_ragged": ("window_attention_fused", 768, 32, 9, True, 3),
    "attention_c96_ragged": ("window_attention_fused", 96, 4, 9, True, 1),
    "attention_c384": ("window_attention_fused", 384, 16, 4, True, 2),
}


@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_float32_kernel_checks_pass_the_card_cases(case):
    """Every float32 card case below passes the wrapper's checks, and each
    weight of it the split's, on the CPU (the checks read shapes, strides and
    addresses, not the device)."""
    kernel, c, heads, nw, shifted, images = CARD_CASES[case]
    args = operands(kernel, make_inputs(c, heads, nw, shifted, images, seed=4))
    x = args.pop("x_windows")
    window_attn._check(kernel, x, heads, nw, args)
    window_attn._check_kernel_shapes(kernel, x, heads, args)
    for key in ("w_qkv", "w_proj", "w_fc1", "w_fc2"):
        if key in args:
            assert window_attn.tf32_split(args[key]).shape == (2, *args[key].T.shape)
    assert x.shape == (images * nw, N, c) and (images * nw * N) % 128 == (
        64 if "ragged" in case else 0)


@pytest.fixture
def cuda_device():
    """Decided per test, not at import: every xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_pallas_interpret(case):
    jnp = pytest.importorskip("jax.numpy")
    from frechet_audio_distance_exported_tpu.ops import pallas_window_attn as jax_kernels

    kernel, c, heads, nw, shifted, batch = CASES[case]
    arrays = make_inputs(c, heads, nw, shifted, batch)
    args = operands(kernel, arrays)
    ref = getattr(jax_kernels, kernel)(
        *(jnp.asarray(arrays[k]) for k in args), heads=heads, num_windows=nw, interpret=True
    )
    before = launches.read()
    ours = getattr(window_attn, kernel)(**args, heads=heads, num_windows=nw)
    assert launches.read() == before  # a CPU tensor takes the plain version
    plain = getattr(window_attn, f"{kernel}_reference")(**args, heads=heads, num_windows=nw)
    assert torch.equal(ours, plain)
    assert ours.shape == (batch * nw, N, c) and torch.isfinite(ours).all()
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_shift_mask_reaches_the_output():
    """The same inputs with and without the shift mask differ (by far more than
    the bound), and the JAX kernel agrees in both; so the mask's window
    indexing (window w uses mask[w % nW]) is held to the JAX kernel's."""
    kernel = "swin_block_fused"
    shifted = operands(kernel, make_inputs(96, 4, 64, True, 1))
    plain = {**shifted, "mask": torch.zeros((1, N, N))}
    a = window_attn.swin_block_fused(**shifted, heads=4, num_windows=64)
    b = window_attn.swin_block_fused(**plain, heads=4, num_windows=64)
    assert float((a - b).abs().max()) > 100 * ATOL


def test_wrappers_reject_what_the_kernels_do_not_take():
    kernel = "swin_block_fused"
    args = operands(kernel, make_inputs(96, 4, 64, False, 1))
    fused = window_attn.swin_block_fused
    with pytest.raises(TypeError, match="float32"):
        fused(**{**args, "x_windows": args["x_windows"].double()}, heads=4, num_windows=64)
    with pytest.raises(TypeError, match="w_fc2"):
        fused(**{**args, "w_fc2": args["w_fc2"].half()}, heads=4, num_windows=64)
    with pytest.raises(ValueError, match=r"\[BW, N, C\]"):
        fused(**{**args, "x_windows": args["x_windows"][0]}, heads=4, num_windows=64)
    with pytest.raises(ValueError, match="heads"):
        fused(**args, heads=5, num_windows=64)
    with pytest.raises(ValueError, match="num_windows"):
        fused(**args, heads=4, num_windows=48)
    with pytest.raises(ValueError, match="mask"):
        fused(**{**args, "mask": torch.zeros((4, N, N))}, heads=4, num_windows=64)
    with pytest.raises(ValueError, match="bias"):
        fused(**{**args, "bias": args["bias"][:2]}, heads=4, num_windows=64)
    with pytest.raises(ValueError, match="w_qkv"):
        fused(**{**args, "w_qkv": args["w_qkv"].T.contiguous()}, heads=4, num_windows=64)
    with pytest.raises(ValueError, match="meta"):
        fused(**{**args, "b_fc1": torch.empty(384, device="meta")}, heads=4, num_windows=64)
    attention = operands("window_attention_fused", make_inputs(96, 4, 64, False, 1))
    with pytest.raises(ValueError, match="x_windows"):
        window_attn.window_attention_fused(
            **{**attention, "x_windows": torch.empty((64, N, 96), device="meta")},
            heads=4, num_windows=64,
        )


def test_attention_scratch_checks_refuse_what_the_kernels_do_not_take():
    """window_attention_fused's scratch (attention_scratch) passes its check;
    another shape, type, a missing buffer or a view off 16-byte alignment
    raises, and so does a BW past the GEMM's grid."""
    bw, c = 3, 96
    scratch = window_attn.attention_scratch(bw, c, "cpu")
    assert {k: tuple(t.shape) for k, t in scratch.items()} == {
        "a": (bw * N, c), "qkv": (bw * N, 3 * c)}
    window_attn._check_scratch(scratch, bw, c, "cpu")
    check = window_attn._check_scratch
    with pytest.raises(ValueError, match="qkv must be"):
        check({**scratch, "qkv": torch.empty((bw * N, c))}, bw, c, "cpu")
    with pytest.raises(ValueError, match="a must be"):
        check(scratch, bw + 1, c, "cpu")
    with pytest.raises(ValueError, match="float32"):
        check({**scratch, "a": scratch["a"].double()}, bw, c, "cpu")
    with pytest.raises(ValueError, match="scratch must be"):
        check({k: v for k, v in scratch.items() if k != "qkv"}, bw, c, "cpu")
    off = torch.empty(bw * N * c + 1)[1:].reshape(bw * N, c)  # 4 bytes past an aligned start
    with pytest.raises(ValueError, match="aligned"):
        check({**scratch, "a": off}, bw, c, "cpu")
    wide = torch.empty((1, N, c)).expand(window_attn.KERNEL_MAX_WINDOWS + 1, N, c)
    with pytest.raises(ValueError, match="at most"):
        window_attn._check_kernel_shapes("window_attention_fused", wide, 4, {})


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version_on_the_card(cuda_device, case):
    kernel, c, heads, nw, shifted, batch = CASES[case]
    args = operands(kernel, make_inputs(c, heads, nw, shifted, batch, seed=1), cuda_device)
    before = launches.read()[kernel]
    out = getattr(window_attn, kernel)(**args, heads=heads, num_windows=nw)
    torch.cuda.synchronize()
    assert launches.read()[kernel] == before + 1
    ref = getattr(window_attn, f"{kernel}_reference")(**args, heads=heads, num_windows=nw)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= CARD_ATOL


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    args = operands("swin_block_fused", make_inputs(96, 4, 64, False, 1), cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        window_attn.swin_block_fused(
            **{**args, "w_qkv": args["w_qkv"].T.contiguous().T}, heads=4, num_windows=64
        )
    with pytest.raises(ValueError, match="head_dim"):
        window_attn.swin_block_fused(  # head_dim 48
            **{**args, "bias": args["bias"][:2].contiguous()}, heads=2, num_windows=64
        )
    with pytest.raises(ValueError, match="on cpu"):
        window_attn.swin_block_fused(**{**args, "bias": args["bias"].cpu()}, heads=4,
                                     num_windows=64)


@pytest.mark.cuda
def test_attention_intermediates_on_the_card(cuda_device):
    """The launch with the test's own scratch gives the wrapper's output, and
    leaves q, k, v (with b_qkv) and attn in it within the card bound of the
    plain version's."""
    from frechet_audio_distance_exported_tpu_torch.ops import _build

    c, heads, nw = 96, 4, 64
    args = operands("window_attention_fused", make_inputs(c, heads, nw, True, 1, seed=2),
                    cuda_device)
    x = args.pop("x_windows")
    scratch = window_attn.attention_scratch(x.shape[0], c, cuda_device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    err = window_attn.launch_attention(_build.load_library(), x, args, heads, scratch, out,
                                       window_attn.ctypes.c_void_p(stream))
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(out, window_attn.window_attention_fused(x, **args, heads=heads,
                                                               num_windows=nw))
    h = window_attn._layer_norm(x, args["gamma1"], args["beta1"]).reshape(-1, c)
    qkv = torch.matmul(h, args["w_qkv"]) + args["b_qkv"]
    assert float((scratch["qkv"] - qkv).abs().max()) <= CARD_ATOL
    attn = torch.matmul(scratch["a"], args["w_proj"]) + args["b_proj"] + x.reshape(-1, c)
    assert float((attn - out.reshape(-1, c)).abs().max()) <= CARD_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_float32_kernel_matches_plain_version_at_every_width(cuda_device, case):
    """Each float32 kernel against its plain version at every CLAP width and
    at ragged BWs, within CARD_ATOL; one launch counted, under its own key
    only."""
    kernel, c, heads, nw, shifted, images = CARD_CASES[case]
    args = operands(kernel, make_inputs(c, heads, nw, shifted, images, seed=5), cuda_device)
    before = launches.read()
    out = getattr(window_attn, kernel)(**args, heads=heads, num_windows=nw)
    torch.cuda.synchronize()
    after = launches.read()
    assert after[kernel] == before[kernel] + 1
    assert {k: v for k, v in after.items() if k != kernel} == {
        k: v for k, v in before.items() if k != kernel}
    ref = getattr(window_attn, f"{kernel}_reference")(**args, heads=heads, num_windows=nw)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= CARD_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("gemm", sorted(GEMMS))
def test_tf32_split_kernel_gives_the_plain_bits(cuda_device, gemm):
    k, n = GEMMS[gemm]
    rng = np.random.default_rng(k + 7 * n)
    w = torch.from_numpy((0.05 * rng.standard_normal((k, n))).astype(np.float32))
    ours = window_attn.tf32_split(w.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(ours.cpu(), window_attn.tf32_split_reference(w))


@pytest.mark.cuda
def test_float32_block_kernel_is_deterministic_and_leaves_its_inputs(cuda_device):
    """Two calls give the same bits (no atomics, no race between the
    warpgroups), and the inputs are not written."""
    args = operands("swin_block_fused", make_inputs(192, 8, 9, True, 3, seed=6), cuda_device)
    copies = {k: v.clone() for k, v in args.items()}
    first = window_attn.swin_block_fused(**args, heads=8, num_windows=9)
    second = window_attn.swin_block_fused(**args, heads=8, num_windows=9)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert all(torch.equal(args[k], copies[k]) for k in args)
