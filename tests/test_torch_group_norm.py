"""The port's GroupNorm(1, C) (ops/group_norm.py, csrc/group_norm.cu).

On the CPU the wrapper runs its plain version, which is held here to
float64 nn.GroupNorm(1, C) and to the JAX package's one-pass
group_norm_full (models/common.py:100) at the 18 norms of a 48 kHz Encodec
forward (T cut to a hundredth), a length that is no multiple of the
kernels' vector, B = 1, rows whose mean^2 / var reaches 1e4, an affine that
is not the identity, and bf16 input. Bounds: the plain version's rounding
of y = x * a + b in float32 (a and b each rounded once, then the sum),
stated per case below; against JAX, the distance of JAX itself from
float64 besides. Also on the CPU: a float32 model of the kernels' sums (the
shift is what keeps the variance), the grid the wrapper picks, and the
wrapper's refusals.

The four forms of the apply (plain, elu, split, residual: the norm with the
convolution's bias added first and ELU, the residual sum and the reflect
pad after) are held to ATen's composition of the same steps bit for bit,
on the CPU at every norm shape (T cut to a hundredth) and on the card at
every norm shape of a 48 kHz chunk; the multiply and shift that stand for a
division by T, to floor division.

The kernels run only on the card (the `cuda` cases, which skip without
one): kernel against plain at every norm shape at B = 8 and once at a whole
64-clip chunk's largest, bf16 in bf16 ulps, bit-identical launches, the
launch count, each form against the composition (bf16 within one ulp), the
residual form with two affines at odd T and pads of 1 to 4, and a full
48 kHz Encodec forward against the same model's chain on ATen's
nn.GroupNorm.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.nn.functional as F  # noqa: E402

from frechet_audio_distance_exported_tpu_torch.models import encodec  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import group_norm as gn  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import launches  # noqa: E402

EPS = 1e-5
SM_COUNT = 132  # an H100's SMs
CARD_ATOL = 1e-5  # kernel vs plain, float32: only the moments' summation order differs


NORMS = encodec.group_norm_shapes(480000)  # a 10 s clip at 48 kHz
SHORT = [(c, t // 100) for c, t in NORMS]  # T cut to a hundredth for the CPU
# Odd cases: C*T no multiple of the vector (4 floats, 8 bf16), T = 1, tiny rows.
RAGGED = [(3, 1001), (7, 33), (5000, 1), (1, 5)]


def inputs(batch, channels, t, seed, ratio=4.0, dtype=torch.float32, device="cpu",
           identity=False):
    """x [batch, channels, t] with channel offsets and a common offset such
    that each row's mean^2 / var is about ``ratio``; gamma and beta [C]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn((batch, channels, t), generator=gen, device=device)
    offsets = 0.3 * torch.randn((1, channels, 1), generator=gen, device=device)
    x = noise + offsets + float(np.sqrt(ratio))
    if identity:
        gamma = torch.ones(channels, device=device)
        beta = torch.zeros(channels, device=device)
    else:
        gamma = 1.0 + 0.2 * torch.randn(channels, generator=gen, device=device)
        beta = 0.3 * torch.randn(channels, generator=gen, device=device)
    return x.to(dtype), gamma.to(dtype), beta.to(dtype)


def float64_group_norm(x, gamma, beta):
    return F.group_norm(x.double(), 1, gamma.double(), beta.double(), EPS)


def fused_bound(x, gamma, beta):
    """What y = x * a + b in float32 may lose against float64: a and b each
    rounded once, the sum rounded once, and one ulp for the plain version's
    second rounding; per element, from the float64 moments."""
    xd = x.double()
    mean = xd.mean(dim=(1, 2), keepdim=True)
    var = ((xd - mean) ** 2).mean(dim=(1, 2), keepdim=True)
    a = gamma.double()[:, None] / torch.sqrt(var + EPS)
    b = beta.double()[:, None] - mean * a
    y = xd * a + b
    return 2.0 ** -22 * ((xd * a).abs() + b.abs() + y.abs())


def bf16_ulp(v):
    """The spacing of bf16 values at |v| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


@pytest.fixture(scope="module")
def jax_group_norm():
    jnp = pytest.importorskip("jax.numpy")
    from frechet_audio_distance_exported_tpu.models import common

    def run(x, gamma, beta):
        """The JAX function on [B, T, C], back to [B, C, T] as float64."""
        jdt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32

        def arr(t):
            return jnp.asarray(t.float().numpy(), dtype=jdt)

        out = common.group_norm_full(arr(x.transpose(1, 2)), arr(gamma), arr(beta), EPS)
        return torch.from_numpy(np.asarray(out, dtype=np.float64).transpose(0, 2, 1).copy())

    return run


def check_float32(x, gamma, beta, jax_group_norm):
    ours = gn.group_norm(x, gamma, beta, EPS)
    assert ours.dtype == torch.float32 and ours.shape == x.shape
    ref = float64_group_norm(x, gamma, beta)
    err = (ours.double() - ref).abs()
    assert bool((err <= fused_bound(x, gamma, beta)).all()), float(err.max())
    theirs = jax_group_norm(x, gamma, beta)
    jax_err = float((theirs - ref).abs().max())
    bound = float(fused_bound(x, gamma, beta).max())
    assert float((ours.double() - theirs).abs().max()) <= jax_err + bound


@pytest.mark.parametrize("channels,t", SHORT + RAGGED,
                         ids=[f"{c}x{t}" for c, t in SHORT + RAGGED])
def test_plain_matches_float64_and_jax_at_every_norm(channels, t, jax_group_norm):
    x, gamma, beta = inputs(2, channels, t, seed=channels * 7 + t)
    check_float32(x, gamma, beta, jax_group_norm)


@pytest.mark.parametrize("ratio", [1.0, 1e2, 1e4])
@pytest.mark.parametrize("channels,t", [(32, 4800), (512, 15), (3, 1001)])
def test_plain_holds_rows_far_from_zero(channels, t, ratio, jax_group_norm):
    """mean^2 / var up to 1e4, where E[x^2] - mean^2 would cancel in
    float32; JAX's one-pass float32 moments lose digits there, the plain
    version's float64 ones do not."""
    x, gamma, beta = inputs(2, channels, t, seed=t, ratio=ratio)
    check_float32(x, gamma, beta, jax_group_norm)


def test_plain_at_b1_and_the_identity_affine(jax_group_norm):
    x, gamma, beta = inputs(1, 64, 2400, seed=1, identity=True)
    check_float32(x, gamma, beta, jax_group_norm)
    x, gamma, beta = inputs(1, 64, 2400, seed=2)
    check_float32(x, gamma, beta, jax_group_norm)


@pytest.mark.parametrize("channels,t", [(32, 4800), (256, 120), (3, 1001)])
def test_plain_bf16_within_one_ulp(channels, t, jax_group_norm):
    """bf16 in, bf16 out: each element within one bf16 ulp of its own, plus
    what float32 loses before that rounding, of the float64 norm of the
    same bf16 values; and within one bf16 ulp of the largest output of JAX's
    bf16 group_norm_full (which loses more than an element's ulp where y
    nears zero: its float32 (x - mean) * rstd * gamma + beta cancels)."""
    x, gamma, beta = inputs(3, channels, t, seed=t, dtype=torch.bfloat16)
    ours = gn.group_norm(x, gamma, beta, EPS)
    assert ours.dtype == torch.bfloat16
    ref = float64_group_norm(x, gamma, beta)
    err = (ours.double() - ref).abs()
    assert bool((err <= bf16_ulp(ref) + fused_bound(x, gamma, beta)).all())
    theirs = jax_group_norm(x, gamma, beta)
    assert float((ours.double() - theirs).abs().max()) <= float(bf16_ulp(theirs.abs().max()))


def kernel_sums_model(x: np.ndarray, shift: bool, threads: int = 1024) -> float:
    """The variance from sums as the moments kernel takes them: each thread
    sums its elements in float32, one after another (here: a contiguous
    share, the same count), then float64 across threads."""
    k = np.float32(x[0]) if shift else np.float32(0.0)
    d = (x.astype(np.float32) - k).reshape(threads, -1)
    s1 = np.cumsum(d, axis=1, dtype=np.float32)[:, -1].astype(np.float64).sum()
    s2 = np.cumsum(d * d, axis=1, dtype=np.float32)[:, -1].astype(np.float64).sum()
    m1 = s1 / x.size
    return max(s2 / x.size - m1 * m1, 0.0)


def test_the_shift_keeps_the_variance_in_float32_sums():
    """At mean^2 / var = 1e4 and about 900 elements a thread (the largest
    norm's share at B = 64), float32 sums of x - x[0] keep the variance to
    1e-5; float32 sums of x itself lose it at least ten times as far."""
    rng = np.random.default_rng(0)
    x = (100.0 + rng.standard_normal(1024 * 900)).astype(np.float32)
    exact = float(np.var(x.astype(np.float64)))
    shifted = abs(kernel_sums_model(x, True) - exact) / exact
    plain = abs(kernel_sums_model(x, False) - exact) / exact
    assert shifted <= 1e-5
    assert plain >= 10 * shifted


@pytest.mark.parametrize("batch", [64, 8, 1])
@pytest.mark.parametrize("channels,t", NORMS + RAGGED,
                         ids=[f"{c}x{t}" for c, t in NORMS + RAGGED])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_grid_covers_every_row_and_fills_the_card(batch, channels, t, dtype):
    """geometry(): every element in exactly one non-empty slice of whole
    vectors (but the last), no slice wider than the apply's channel table,
    and, where a row is large enough, at least one block for every SM's
    resident blocks and at most WAVES waves of them."""
    vec = gn.ALIGN // (4 if dtype == torch.float32 else 2)
    n = channels * t
    for per_sm in (5, 8):
        resident = SM_COUNT * per_sm
        chunk, splits = gn.geometry(batch, n, t, vec, resident)
        assert chunk % vec == 0 and 0 < chunk
        assert (splits - 1) * chunk < n <= splits * chunk
        assert (chunk - 1) // t + 2 <= gn.MAX_TABLE
        assert splits * batch <= max(gn.WAVES * resident, batch)
        if batch * n >= gn.WAVES * resident * gn.MIN_SLICE:
            assert splits * batch >= resident


def test_every_norm_of_the_48k_forward_is_listed(monkeypatch):
    """group_norm_shapes against the shapes the model's 18 GroupNorms see."""
    seen = []
    reference = gn.group_norm_reference

    def record(x, *args):
        seen.append(tuple(x.shape))
        return reference(x, *args)

    monkeypatch.setattr(gn, "group_norm_reference", record)
    model = encodec.encodec_for_rate(48000).eval()
    with torch.inference_mode():
        model(torch.zeros((1, 2, 3200)))
    assert seen == [(1, c, t) for c, t in encodec.group_norm_shapes(3200)]
    assert len(seen) == 18


def test_sconv_keeps_group_norm_keys_and_uses_the_op():
    conv = encodec.SConv(8, 16, 3, causal=False, group_norm=True)
    assert isinstance(conv.gn, torch.nn.GroupNorm)
    assert {"gn.weight", "gn.bias"} <= set(conv.state_dict())
    x, gamma, beta = inputs(2, 16, 300, seed=3)
    with torch.no_grad():
        conv.gn.weight.copy_(gamma)
        conv.gn.bias.copy_(beta)
    before = launches.read()
    with torch.inference_mode():
        out = conv.gn(x)
    assert torch.equal(out, gn.group_norm_reference(x, gamma, beta, EPS))
    assert launches.read() == before  # the plain version counts no launch


@pytest.mark.parametrize("case", ["non_contiguous", "rank2", "rank4", "float64", "int16",
                                  "weight_dtype", "weight_shape", "bias_shape", "conv_bias_dtype",
                                  "conv_bias_shape", "pad_of_t", "padded_plain", "negative_pad",
                                  "residual_shapes"])
def test_wrapper_refuses(case):
    x, gamma, beta = inputs(2, 8, 64, seed=4)
    error = ValueError
    norm = gn.Norm(x, beta.clone(), gamma, beta, EPS)
    form = {"conv_bias_dtype": lambda: gn.plain(norm._replace(conv_bias=beta.double())),
            "conv_bias_shape": lambda: gn.split(norm._replace(conv_bias=beta[:-1]), 1, 1),
            "pad_of_t": lambda: gn.elu_pad(norm, 64, 0),
            "padded_plain": lambda: gn._epilogue("plain", (norm,), 1, 1),
            "negative_pad": lambda: gn.split(norm, -1, 1),
            "residual_shapes": lambda: gn.residual(norm, norm._replace(y=x[:1].contiguous()),
                                                    1, 1)}
    if case in form:
        with pytest.raises(TypeError if case == "conv_bias_dtype" else ValueError):
            form[case]()
        return
    if case == "non_contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "rank2":
        x = x[0]
    elif case == "rank4":
        x = x[..., None]
    elif case == "float64":
        x, gamma, beta, error = x.double(), gamma.double(), beta.double(), TypeError
    elif case == "int16":
        x, error = x.to(torch.int16), TypeError
    elif case == "weight_dtype":
        gamma, error = gamma.to(torch.bfloat16), TypeError
    elif case == "weight_shape":
        gamma = gamma[:-1]
    else:
        beta = torch.cat([beta, beta])
    with pytest.raises(error):
        gn.group_norm(x, gamma, beta, EPS)


def test_empty_input_gives_an_empty_output():
    x, gamma, beta = inputs(1, 4, 8, seed=5)
    assert gn.group_norm(x[:0], gamma, beta, EPS).shape == (0, 4, 8)
    assert gn.group_norm(x[:, :, :0].contiguous(), gamma, beta, EPS).shape == (1, 4, 0)


@pytest.mark.parametrize("t", [1, 2, 3, 5, 7, 10, 15, 1000, 1500, 1501, 12000, 60000, 240000,
                               480000, 480006, 2**20, 2**31 - 1])
def test_divisor_is_floor_division(t):
    """The kernels' channel of a row element, (e * mul) >> shift, is e // t
    for every e below 2**31, with mul in 32 bits: checked at the multiples
    of t and their neighbours up to the largest row, and at random e."""
    mul, shift = gn.divisor(t)
    assert 0 < mul < 2**32
    top = gn.MAX_ROW
    rng = np.random.default_rng(t)
    edges = np.arange(0, top, t, dtype=np.int64)[: 1 << 16]
    e = np.concatenate([edges, edges + 1, edges - 1, edges + t - 1,
                        np.arange(top - 4096, top + 1, dtype=np.int64),
                        rng.integers(0, top + 1, 1 << 16)])
    e = np.unique(e[(e >= 0) & (e <= top)]).astype(np.uint64)
    # e * mul < 2**31 * 2**32: exact in 64 bits.
    assert np.array_equal((e * np.uint64(mul)) >> np.uint64(shift), e // np.uint64(t))


def composed(form, norms, left, right):
    """ATen's chain that each form folds into the apply: the convolution's
    bias added as ATen's add_ adds it, the norm alone (group_norm), then the
    residual sum, F.elu and F.pad as the form has them."""
    g = [gn.group_norm(n.y + n.conv_bias[:, None], n.weight, n.bias, n.eps) for n in norms]
    if form == "plain":
        return g[0]
    act = F.elu(g[0] + g[1] if form == "residual" else g[0])
    if left or right:
        act = F.pad(act, (left, right), mode="reflect")
    return (g[0], act) if form == "split" else act


def fused(form, norms, left, right):
    if form == "plain":
        return gn.plain(norms[0])
    if form == "elu":
        return gn.elu_pad(norms[0], left, right)
    if form == "split":
        return gn.split(norms[0], left, right)
    return gn.residual(norms[0], norms[1], left, right)


# The pads each form takes in the 48 kHz encoder (conv2 k=1; conv1 k=3; a
# strided conv, here stage 2's k=10, s=5).
FORM_PADS = {"plain": (0, 0), "elu": (0, 0), "split": (1, 1), "residual": (3, 2)}


def form_norms(form, batch, channels, t, seed, dtype=torch.float32, device="cpu"):
    """One norm (two for the residual, each with its own input, conv bias and
    affine) on inputs() with a conv bias drawn beside."""
    out = []
    for k in range(2 if form == "residual" else 1):
        y, gamma, beta = inputs(batch, channels, t, seed + 1000 * k, dtype=dtype, device=device)
        gen = torch.Generator(device=device).manual_seed(seed + 1000 * k + 1)
        conv_bias = (0.5 * torch.randn(channels, generator=gen, device=device)).to(dtype)
        out.append(gn.Norm(y, conv_bias, gamma, beta, EPS))
    return out


def same_outputs(got, want):
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    return len(got) == len(want) and all(
        a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("form", gn.FORMS)
@pytest.mark.parametrize("channels,t", SHORT, ids=[f"{c}x{t}" for c, t in SHORT])
def test_plain_forms_are_the_aten_composition(form, channels, t):
    norms = form_norms(form, 2, channels, t, seed=channels + t)
    before = launches.read()
    out = fused(form, norms, *FORM_PADS[form])
    assert launches.read() == before  # the plain version counts no launch
    assert same_outputs(out, composed(form, norms, *FORM_PADS[form]))


@pytest.fixture
def cuda_device():
    """Decided per test, not at import: every xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernels have no CPU mode)")
    return torch.device("cuda")


def card_case(batch, channels, t, seed, dtype=torch.float32):
    return inputs(batch, channels, t, seed, dtype=dtype, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("channels,t", NORMS + RAGGED,
                         ids=[f"{c}x{t}" for c, t in NORMS + RAGGED])
def test_kernel_matches_plain_on_the_card(cuda_device, channels, t):
    x, gamma, beta = card_case(8, channels, t, seed=channels + t)
    out = gn.group_norm(x, gamma, beta, EPS)
    torch.cuda.synchronize()
    ref = gn.group_norm_reference(x, gamma, beta, EPS)
    torch.testing.assert_close(out, ref, rtol=0, atol=CARD_ATOL)


@pytest.mark.cuda
def test_kernel_at_a_whole_chunk_of_the_largest_norm(cuda_device):
    x, gamma, beta = card_case(64, *NORMS[0], seed=6)
    out = gn.group_norm(x, gamma, beta, EPS)
    ref = gn.group_norm_reference(x, gamma, beta, EPS)
    torch.testing.assert_close(out, ref, rtol=0, atol=CARD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("channels,t", [NORMS[0], NORMS[-1], (3, 1001)])
def test_bf16_kernel_within_one_ulp_of_plain(cuda_device, channels, t):
    x, gamma, beta = card_case(8, channels, t, seed=7, dtype=torch.bfloat16)
    out = gn.group_norm(x, gamma, beta, EPS)
    ref = gn.group_norm_reference(x, gamma, beta, EPS)
    assert out.dtype == torch.bfloat16
    both = torch.maximum(out.float().abs(), ref.float().abs())
    assert bool(((out.float() - ref.float()).abs() <= bf16_ulp(both)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_two_launches_give_the_same_bits_and_count_once(cuda_device, dtype):
    x, gamma, beta = card_case(8, *NORMS[4], seed=8, dtype=dtype)
    suffix = "" if dtype == torch.float32 else "[bf16]"
    keys = ("group_norm" + suffix, "group_norm_apply.plain" + suffix)
    before = launches.read()
    first = gn.group_norm(x, gamma, beta, EPS)
    second = gn.group_norm(x, gamma, beta, EPS)
    after = launches.read()
    assert torch.equal(first, second)
    assert all(after[key] == before[key] + 2 for key in keys)
    assert {k: v for k, v in after.items() if k not in keys} == {
        k: v for k, v in before.items() if k not in keys}


@pytest.mark.cuda
def test_wrapper_refuses_a_misaligned_card_tensor(cuda_device):
    x = torch.zeros(1 + 8 * 64, device=cuda_device)[1:].reshape(1, 8, 64)
    gamma, beta = torch.ones(8, device=cuda_device), torch.zeros(8, device=cuda_device)
    assert x.is_contiguous()
    with pytest.raises(ValueError, match="16 bytes"):
        gn.group_norm(x, gamma, beta, EPS)


@pytest.mark.cuda
@pytest.mark.parametrize("form", gn.FORMS)
@pytest.mark.parametrize("channels,t", NORMS, ids=[f"{c}x{t}" for c, t in NORMS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_forms_are_the_composition_on_the_card(cuda_device, form, channels, t, dtype):
    """Each form at each norm shape of a 48 kHz chunk (B = 4): float32 the
    composition's bits, bf16 within one bf16 ulp of it."""
    norms = form_norms(form, 4, channels, t, seed=channels + t, dtype=dtype, device="cuda")
    got = fused(form, norms, *FORM_PADS[form])
    want = composed(form, norms, *FORM_PADS[form])
    if dtype == torch.float32:
        assert same_outputs(got, want)
        return
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16
        both = torch.maximum(a.float().abs(), b.float().abs())
        assert bool(((a.float() - b.float()).abs() <= bf16_ulp(both)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("left,right", [(1, 1), (2, 2), (3, 2), (4, 4), (1, 4), (4, 1)])
@pytest.mark.parametrize("channels,t", [(64, 1001), (5, 997), (128, 37), (3, 5)],
                         ids=["64x1001", "5x997", "128x37", "3x5"])
def test_residual_with_two_affines_odd_t_and_every_pad(cuda_device, channels, t, left, right):
    """The residual form of two norms with their own conv biases and
    affines, at odd T (rows whose channels start anywhere in a 16-byte
    vector) and pads of 1 to 4 (the padded interior misaligned every way):
    the composition's bits, and the same bits from a second launch; the
    elu and split forms at the same pads."""
    norms = form_norms("residual", 3, channels, t, seed=t + left, device="cuda")
    first = gn.residual(norms[0], norms[1], left, right)
    assert same_outputs(first, composed("residual", norms, left, right))
    assert torch.equal(first, gn.residual(norms[0], norms[1], left, right))
    for form in ("elu", "split"):
        assert same_outputs(fused(form, norms[:1], left, right),
                            composed(form, norms[:1], left, right))


@pytest.mark.cuda
def test_encodec48k_forward_matches_aten_group_norm(cuda_device, monkeypatch):
    """A 48 kHz forward of 8 clips of 10 s through the kernels against the
    same model's chain with ATen's nn.GroupNorm, within the bar that
    test_torch_encodec48k_reference.py holds the port to the plain reference."""
    from test_torch_encodec48k_reference import BAR, clips, random_state
    from test_torch_encodec_norm_forms import chain_forward

    model = encodec.Encodec(channels=2, causal=False).eval()
    model.load_state_dict(random_state())
    model = model.to(cuda_device)
    x = clips(480000).repeat(4, 1, 1).to(cuda_device)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    with torch.inference_mode():
        before = launches.read()["group_norm"]
        ours = model(x)
        assert launches.read()["group_norm"] == before + 18
        aten = chain_forward(model, x, lambda y, norm: F.group_norm(
            y, 1, norm.weight, norm.bias, norm.eps))
    err = ((ours - aten).abs().max() / aten.abs().max()).item()
    assert ours.shape == (8, 1500, 128)
    assert err < BAR, err
