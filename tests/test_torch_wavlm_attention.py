"""WavLM's gated relative-position attention (ops/wavlm_attn.py,
csrc/wavlm_attn.cu) against float64 and against models/wavlm.py's ATen path.

On the CPU: the plain version (wavlm_attention_reference) against
Attention.forward's ATen path and against a float64 softmax written out
term by term, over T (multiples of 64 and not) and B; the [H, 2T - 1]
relative table against position_bias's [H, T, T] at every (t, s), where the
buckets are exact (|r| < 80), logarithmic and clamped (|r| >= 800); a
float32 model of the kernel's tiling (128 query rows a block, 64 keys a
tile, the span of the relative table a tile stages, the masks, the online
softmax in the log2 domain, 3xTF32 products with a fold each 32 deep)
against float64; and the wrapper's refusals.

On the card (``cuda``): the kernel against the float64 attention at T in
{1, 7, 63, 64, 65, 128, 499, 1000} and B in {1, 3, 64}, with the same
attention in 1xTF32 as the control the bar must fail; its launch count; its
refusals of card tensors; and Attention.forward on the card against its CPU
ATen path.
"""

import math

import pytest
import torch

from frechet_audio_distance_exported_tpu_torch.models import wavlm
from frechet_audio_distance_exported_tpu_torch.ops import launches
from frechet_audio_distance_exported_tpu_torch.ops import wavlm_attn
from frechet_audio_distance_exported_tpu_torch.ops.window_attn import _tf32

torch.set_num_threads(2)
HEADS = 16  # WavLM-Large: 16 heads of 64
# The plain version in float32 against float64 or against the ATen path, on
# outputs of order 1: only float32's rounding of scores, exponentials and sums
# (at most 1.8e-6 and 9.5e-7 here).
PLAIN_BAR = 1e-5
# The kernel (and its CPU model) against float64: 3xTF32 products keep about
# 2^-20 of each product, the rest is float32 (the model reads at most 1.2e-6,
# the kernel on an H100 at most 2.7e-6); the same attention with 1xTF32
# products misses by 0.9e-3 to 1.5e-3, 45 times the bar or more.
KERNEL_BAR = 2e-5
LOG2E = 1.4426950408889634


def config(heads: int = HEADS) -> wavlm.WavLMConfig:
    return wavlm.WavLMConfig(hidden=64 * heads, heads=heads, layers=1, intermediate=64,
                             conv_dim=(32,) * 7)


def encoder(heads: int = HEADS, seed: int = 0) -> wavlm.Encoder:
    """An encoder whose relative-position table is the weight law's N(0, 1)."""
    enc = wavlm.Encoder(config(heads))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        enc.rel_attn_embed.copy_(torch.randn(enc.rel_attn_embed.shape, generator=gen))
    return enc


def attention(heads: int = HEADS, seed: int = 0) -> wavlm.Attention:
    """A layer's attention with gru_rel_pos_const drawn around 1 (the rest of
    its state is not read by forward, which takes qkvg)."""
    att = wavlm.Attention(config(heads))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        att.gate_const.copy_(1.0 + 0.2 * torch.randn(heads, generator=gen))
    return att


def draw_qkvg(b: int, t: int, heads: int = HEADS, seed: int = 0, device="cpu") -> torch.Tensor:
    """qkvg rows: q, k and v ~ N(0, 1) (scores q k^T / 8 of order 1, as a
    layer's are) and the gate's logits ~ N(0, 1)."""
    gen = torch.Generator().manual_seed(1000 * b + t + seed)
    return torch.randn((b * t, 3 * 64 * heads + 8 * heads), generator=gen).to(device)


def float64_attention(qkvg, rel, gate_const, b: int, t: int) -> torch.Tensor:
    """The gated attention in float64, written out: each row's softmax as
    exp(score - max) over the sum of the same, the gate from its logits."""
    qkvg, rel, gate_const = (x.double() for x in (qkvg, rel, gate_const))
    heads = gate_const.shape[0]
    c = 64 * heads
    x = qkvg.view(b, t, -1)
    out = torch.empty((b, t, c), dtype=torch.float64, device=qkvg.device)
    idx = wavlm_attn.relative_index(t, qkvg.device)
    for h in range(heads):
        q, k, v = (x[:, :, i * c + 64 * h:i * c + 64 * h + 64] for i in range(3))
        logits = x[:, :, 3 * c + 8 * h:3 * c + 8 * h + 8]
        ga = 1.0 / (1.0 + torch.exp(-logits[..., :4].sum(-1)))
        gb = 1.0 / (1.0 + torch.exp(-logits[..., 4:].sum(-1)))
        gate = ga * (gb * gate_const[h] - 1.0) + 2.0  # [B, T]
        scores = torch.einsum("btd,bsd->bts", q, k) / 8.0 + gate[..., None] * rel[h][idx]
        e = torch.exp(scores - scores.amax(-1, keepdim=True))
        out[:, :, 64 * h:64 * h + 64] = torch.einsum("bts,bsd->btd", e / e.sum(-1, keepdim=True), v)
    return out.view(b * t, c)


def one_tf32_attention(qkvg, rel, gate_const, b: int, t: int) -> torch.Tensor:
    """The same attention with its two products in 1xTF32: q, k, the
    probabilities and v rounded to TF32 as the tensor core takes them, the
    rest in float64."""
    heads = gate_const.shape[0]
    c = 64 * heads
    rows = qkvg.clone()
    rows[:, :3 * c] = _tf32(rows[:, :3 * c])
    x = rows.double().view(b, t, -1)
    rel, gate_const = rel.double(), gate_const.double()
    out = torch.empty((b, t, c), dtype=torch.float64, device=qkvg.device)
    idx = wavlm_attn.relative_index(t, qkvg.device)
    for h in range(heads):
        q, k, v = (x[:, :, i * c + 64 * h:i * c + 64 * h + 64] for i in range(3))
        logits = x[:, :, 3 * c + 8 * h:3 * c + 8 * h + 8]
        ga, gb = torch.sigmoid(logits[..., :4].sum(-1)), torch.sigmoid(logits[..., 4:].sum(-1))
        gate = ga * (gb * gate_const[h] - 1.0) + 2.0
        scores = torch.einsum("btd,bsd->bts", q, k) / 8.0 + gate[..., None] * rel[h][idx]
        probs = _tf32(torch.softmax(scores, dim=-1).float()).double()
        out[:, :, 64 * h:64 * h + 64] = torch.einsum("bts,bsd->btd", probs, v)
    return out.view(b * t, c)


# ---- on the CPU ----

@pytest.mark.parametrize("t", [1, 7, 63, 64, 65, 130])
@pytest.mark.parametrize("b", [1, 3])
def test_reference_matches_the_aten_path(t, b):
    """wavlm_attention_reference (relative table, bias materialised [B, H, T,
    T]) against Attention.forward's ATen path (position_bias [H, T, T],
    addcmul_ in place) on the same rows: the same float32 arithmetic in
    other orders."""
    heads = 4
    enc, att = encoder(heads, seed=t), attention(heads, seed=t)
    qkvg = draw_qkvg(b, t, heads)
    want = att(qkvg, b, t, enc.position_bias(t))
    got = wavlm_attn.wavlm_attention_reference(qkvg, enc.relative_table(t), att.gate_const, b, t)
    assert got.shape == want.shape == (b * t, 64 * heads)
    assert (got - want).abs().max().item() < PLAIN_BAR


@pytest.mark.parametrize("t", [1, 5, 64, 100, 257])
def test_reference_matches_float64(t):
    heads, b = 4, 2
    enc, att = encoder(heads, seed=t), attention(heads, seed=t)
    qkvg, rel = draw_qkvg(b, t, heads), enc.relative_table(t)
    want = float64_attention(qkvg, rel, att.gate_const, b, t)
    got = wavlm_attn.wavlm_attention_reference(qkvg, rel, att.gate_const, b, t)
    assert (got.double() - want).abs().max().item() < PLAIN_BAR
    # In float64 the plain version is the written-out one to float64's rounding.
    got64 = wavlm_attn.wavlm_attention_reference(qkvg.double(), rel.double(),
                                                 att.gate_const.double(), b, t)
    assert (got64 - want).abs().max().item() < 1e-12


@pytest.mark.parametrize("t", [1, 2, 80, 499, 1700])
def test_relative_table_gathers_position_bias(t):
    """Every (t, s) of position_bias's [H, T, T] (the CPU's form) is the
    relative table's column s - t + T - 1, bit for bit: T = 80 reaches the
    first logarithmic bucket (|r| = 80), 1700 the clamped ones (|r| >= 800)."""
    enc = encoder(4, seed=t)
    rel = enc.relative_table(t)
    assert rel.shape == (4, 2 * t - 1) and rel.is_contiguous()
    assert torch.equal(wavlm_attn.expand_relative(rel, t), enc.position_bias(t))
    r = torch.arange(1 - t, t)
    assert torch.equal(rel, enc.rel_attn_embed[wavlm.relative_bucket(r)].t())


def kernel_model(qkvg, rel, gate_const, b: int, t: int, tf32x3: bool = True) -> torch.Tensor:
    """A float32 model of wavlm_attention_kernel's arithmetic and tiling:
    blocks of 128 query rows, key tiles of 64, the span of rel a tile stages
    (192 values from s0 - t0 - 127, 0 outside the table), the gate of each row
    (0 past T), scores fma(q k^T, log2 e / 8, gate log2 e * rel), keys past T
    at -inf, the running max and sum, exp2, p v in two 32-key halves. Each
    32-deep part of a product is a fresh float32 sum of its three TF32
    products (tf32x3; with tf32x3 False only hi * hi, 1xTF32): hi rounded to
    TF32, lo = a - hi truncated to TF32 as the tensor core reads it."""
    heads = gate_const.shape[0]
    c = 64 * heads
    x = qkvg.view(b, t, -1)

    def truncated(x):  # the top 19 bits, as the tensor core reads a float32 operand
        return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)

    def product(a, bt):  # a [m, 32] @ bt [n, 32]^T
        a_hi, b_hi = _tf32(a), _tf32(bt)
        out = a_hi @ b_hi.t()
        if tf32x3:
            out = a_hi @ truncated(bt - b_hi).t() + out
            out = truncated(a - a_hi) @ b_hi.t() + out
        return out

    def fma(p, s, add):  # one rounding, as the kernel's fmaf
        return (p.double() * s + add.double()).float()

    out = torch.zeros((b, t, c))
    for bb in range(b):
        for h in range(heads):
            for t0 in range(0, t, 128):
                rows = torch.arange(t0, t0 + 128)
                valid_q = rows < t
                q = torch.zeros(128, 64)
                q[valid_q] = x[bb, rows[valid_q], 64 * h:64 * h + 64]
                logits = torch.zeros(128, 8)
                logits[valid_q] = x[bb, rows[valid_q], 3 * c + 8 * h:3 * c + 8 * h + 8]
                ga, gb = (1.0 / (1.0 + torch.exp(-logits[:, 4 * i:4 * i + 4].sum(-1)))
                          for i in range(2))
                gate = torch.where(valid_q, ga * (gb * gate_const[h] - 1.0) + 2.0,
                                   torch.zeros(()))
                gate_log2 = gate * LOG2E
                o = torch.zeros(128, 64)
                run_max = torch.full((128,), -math.inf)
                run_sum = torch.zeros(128)
                for s0 in range(0, t, 64):
                    keys = torch.arange(s0, s0 + 64)
                    valid_k = keys < t
                    k, v = torch.zeros(64, 64), torch.zeros(64, 64)
                    k[valid_k] = x[bb, keys[valid_k], c + 64 * h:c + 64 * h + 64]
                    v[valid_k] = x[bb, keys[valid_k], 2 * c + 64 * h:2 * c + 64 * h + 64]
                    first = s0 - t0 - 127 + t - 1
                    idx = torch.arange(first, first + 192)
                    span = torch.where((idx >= 0) & (idx < 2 * t - 1),
                                       rel[h][idx.clamp(0, 2 * t - 2)], torch.zeros(()))
                    s = product(q[:, :32], k[:, :32]) + product(q[:, 32:], k[:, 32:])
                    cols, rws = torch.arange(64)[None, :], torch.arange(128)[:, None]
                    bias = span[cols - rws + 127]
                    s = fma(s, 0.125 * LOG2E, gate_log2[:, None] * bias)
                    s = torch.where(valid_k[None, :], s, torch.full((), -math.inf))
                    new_max = torch.maximum(run_max, s.amax(-1))
                    corr = torch.exp2(run_max - new_max)
                    run_max = new_max
                    p = torch.exp2(s - run_max[:, None])
                    run_sum = run_sum * corr + p.sum(-1)
                    vt = v.t()
                    o = fma(o, corr[:, None], product(p[:, :32], vt[:, :32]))
                    o = o + product(p[:, 32:], vt[:, 32:])
                o = o / run_sum[:, None]
                out[bb, rows[valid_q], 64 * h:64 * h + 64] = o[valid_q]
    return out.view(b * t, c)


@pytest.mark.parametrize("t", [1, 63, 65, 130, 200])
def test_kernel_model_matches_float64(t):
    """The kernel's tiling and arithmetic, modelled in float32 on the CPU,
    within KERNEL_BAR of float64 at ragged T (one key, a part tile, two query
    blocks); the same model with 1xTF32 products misses it."""
    heads, b = 2, 2
    enc, att = encoder(heads, seed=t), attention(heads, seed=t)
    qkvg, rel = draw_qkvg(b, t, heads, seed=7), enc.relative_table(t)
    want = float64_attention(qkvg, rel, att.gate_const, b, t)
    err = (kernel_model(qkvg, rel, att.gate_const, b, t).double() - want).abs().max().item()
    assert err < KERNEL_BAR
    if t > 1:  # one key: the output is v itself, whatever the rounding of p
        one = (kernel_model(qkvg, rel, att.gate_const, b, t, tf32x3=False).double()
               - want).abs().max().item()
        assert one > 10 * KERNEL_BAR


def test_the_one_tf32_control_misses_the_bar():
    """one_tf32_attention, the card tests' control, misses KERNEL_BAR by ten
    times or more on a layer's shapes cut to 2 clips."""
    b, t = 2, 499
    enc, att = encoder(seed=3), attention(seed=3)
    qkvg, rel = draw_qkvg(b, t, seed=3), enc.relative_table(t)
    want = float64_attention(qkvg, rel, att.gate_const, b, t)
    err = (one_tf32_attention(qkvg, rel, att.gate_const, b, t) - want).abs().max().item()
    assert err > 10 * KERNEL_BAR


def refusal_cases(device):
    """(name, qkvg, rel, gate_const, b, t, error) the wrapper must refuse."""
    b, t, heads = 2, 5, 2
    qkvg = draw_qkvg(b, t, heads, device=device)
    rel = torch.zeros((heads, 2 * t - 1), device=device)
    gc = torch.ones(heads, device=device)
    wide = torch.zeros((b * t, qkvg.shape[1] + 4), device=device)
    return [
        ("bf16", qkvg.to(torch.bfloat16), rel, gc, b, t, TypeError),
        ("bf16 rel", qkvg, rel.to(torch.bfloat16), gc, b, t, TypeError),
        ("width", wide, rel, gc, b, t, ValueError),
        ("rows", qkvg[:-1], rel, gc, b, t, ValueError),
        ("rel length", qkvg, rel[:, :-1].contiguous(), gc, b, t, ValueError),
        ("heads", qkvg, rel, torch.ones(heads + 1, device=device), b, t, ValueError),
        ("strided", wide[:, :qkvg.shape[1]], rel, gc, b, t, ValueError),
        ("no rows", qkvg[:0], rel, gc, 0, t, ValueError),
    ]


@pytest.mark.parametrize("case", range(len(refusal_cases("cpu"))))
def test_wrapper_refuses(case):
    name, qkvg, rel, gc, b, t, error = refusal_cases("cpu")[case]
    launches.zero()
    with pytest.raises(error):
        wavlm_attn.wavlm_attention(qkvg, rel, gc, b, t)
    assert launches.read()["wavlm_attention"] == 0, name


def test_wrapper_refuses_cpu_tensors():
    """A float32 CPU call of the right shapes: the wrapper is the card's
    (the model sends the CPU to ATen), so it raises and counts nothing."""
    b, t, heads = 2, 5, 2
    launches.zero()
    with pytest.raises(ValueError, match="card"):
        wavlm_attn.wavlm_attention(draw_qkvg(b, t, heads), torch.zeros((heads, 2 * t - 1)),
                                   torch.ones(heads), b, t)
    assert launches.read()["wavlm_attention"] == 0


def test_cpu_model_keeps_the_aten_attention():
    """On the CPU position_bias gives [H, T, T] and Attention.forward runs
    ATen: no launch is counted."""
    enc, att = encoder(2), attention(2)
    launches.zero()
    bias = enc.position_bias(9)
    assert bias.shape == (2, 9, 9)
    assert att(draw_qkvg(3, 9, 2), 3, 9, bias).shape == (27, 128)
    assert launches.read()["wavlm_attention"] == 0


# ---- on the card ----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_T = (1, 7, 63, 64, 65, 128, 499, 1000)
CARD_B = (1, 3, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("t", CARD_T)
@pytest.mark.parametrize("b", CARD_B)
def test_kernel_matches_float64(b, t):
    """16 heads of 64, random qkvg rows and gate logits, the relative table of
    a drawn [320, 16] table: within KERNEL_BAR of the float64 attention, where
    the same attention with 1xTF32 products misses it (T > 1: with one key
    the output is v, exact in any precision)."""
    dev = _card()
    enc, att = encoder(seed=t).to(dev), attention(seed=t).to(dev)
    qkvg, rel = draw_qkvg(b, t, device=dev), enc.relative_table(t)
    assert rel.shape == (HEADS, 2 * t - 1)
    launches.zero()
    got = wavlm_attn.wavlm_attention(qkvg, rel, att.gate_const, b, t)
    again = wavlm_attn.wavlm_attention(qkvg, rel, att.gate_const, b, t)
    torch.cuda.synchronize()
    assert launches.read()["wavlm_attention"] == 2
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    err, one = 0.0, 0.0
    step = max(1, 4 * 499 // t)  # clips a float64 piece: its scores stay under 0.5 GB
    for b0 in range(0, b, step):
        n = min(step, b - b0)
        rows = slice(b0 * t, (b0 + n) * t)
        want = float64_attention(qkvg[rows], rel, att.gate_const, n, t)
        err = max(err, (got[rows].double() - want).abs().max().item())
        if t > 1:
            ctrl = one_tf32_attention(qkvg[rows], rel, att.gate_const, n, t)
            one = max(one, (ctrl - want).abs().max().item())
    print(f"B {b} T {t}: kernel {err:.3e}, 1xTF32 {one:.3e}")
    assert err < KERNEL_BAR
    if t > 1:
        assert one > KERNEL_BAR


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(refusal_cases("cpu"))))
def test_wrapper_refuses_on_the_card(case):
    dev = _card()
    name, qkvg, rel, gc, b, t, error = refusal_cases(dev)[case]
    launches.zero()
    with pytest.raises(error):
        wavlm_attn.wavlm_attention(qkvg, rel, gc, b, t)
    assert launches.read()["wavlm_attention"] == 0, name


@pytest.mark.cuda
def test_wrapper_refuses_a_cpu_operand_beside_card_ones():
    dev = _card()
    b, t, heads = 2, 5, 2
    qkvg = draw_qkvg(b, t, heads, device=dev)
    with pytest.raises(ValueError):
        wavlm_attn.wavlm_attention(qkvg, torch.zeros((heads, 2 * t - 1)),
                                   torch.ones(heads, device=dev), b, t)


@pytest.mark.cuda
@pytest.mark.parametrize("b, t", [(3, 499), (2, 65)])
def test_attention_forward_on_the_card_matches_the_cpu(b, t):
    """Attention.forward on the card (position_bias's relative table, one
    wavlm_attention launch) against the same module's ATen path on the CPU,
    on the same rows."""
    dev = _card()
    enc, att = encoder(seed=b), attention(seed=b)
    qkvg = draw_qkvg(b, t, seed=11)
    want = att(qkvg, b, t, enc.position_bias(t))
    enc_card, att_card = encoder(seed=b).to(dev), attention(seed=b).to(dev)
    bias = enc_card.position_bias(t)
    assert bias.shape == (HEADS, 2 * t - 1)
    launches.zero()
    got = att_card(qkvg.to(dev), b, t, bias)
    torch.cuda.synchronize()
    assert launches.read()["wavlm_attention"] == 1
    assert (got.cpu() - want).abs().max().item() < KERNEL_BAR
