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

The kernels run only on the card (the `cuda` cases, which skip without
one): kernel against plain at every norm shape at B = 8 and once at a whole
64-clip chunk's largest, bf16 in bf16 ulps, bit-identical launches, the
launch count, and a full 48 kHz Encodec forward against the same model on
ATen's nn.GroupNorm.
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


def test_every_norm_of_the_48k_forward_is_listed():
    """group_norm_shapes against the shapes the model's 18 GroupNorms see."""
    seen = []
    model = encodec.encodec_for_rate(48000).eval()
    for module in model.modules():
        if isinstance(module, encodec.GroupNorm1):
            module.register_forward_hook(lambda m, args, out: seen.append(tuple(args[0].shape)))
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
                                  "weight_dtype", "weight_shape", "bias_shape"])
def test_wrapper_refuses(case):
    x, gamma, beta = inputs(2, 8, 64, seed=4)
    error = ValueError
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
    key = "group_norm" if dtype == torch.float32 else "group_norm[bf16]"
    before = launches.read()
    first = gn.group_norm(x, gamma, beta, EPS)
    second = gn.group_norm(x, gamma, beta, EPS)
    after = launches.read()
    assert torch.equal(first, second)
    assert after[key] == before[key] + 2
    assert {k: v for k, v in after.items() if k != key} == {
        k: v for k, v in before.items() if k != key}


@pytest.mark.cuda
def test_wrapper_refuses_a_misaligned_card_tensor(cuda_device):
    x = torch.zeros(1 + 8 * 64, device=cuda_device)[1:].reshape(1, 8, 64)
    gamma, beta = torch.ones(8, device=cuda_device), torch.zeros(8, device=cuda_device)
    assert x.is_contiguous()
    with pytest.raises(ValueError, match="16 bytes"):
        gn.group_norm(x, gamma, beta, EPS)


@pytest.mark.cuda
def test_encodec48k_forward_matches_aten_group_norm(cuda_device, monkeypatch):
    """A 48 kHz forward of 8 clips of 10 s through the kernels against the
    same model with ATen's nn.GroupNorm, within the bar that
    test_torch_encodec48k_reference.py holds the port to the plain reference."""
    from test_torch_encodec48k_reference import BAR, clips, random_state

    model = encodec.Encodec(channels=2, causal=False).eval()
    model.load_state_dict(random_state())
    model = model.to(cuda_device)
    x = clips(480000).repeat(4, 1, 1).to(cuda_device)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    with torch.inference_mode():
        before = launches.read()["group_norm"]
        ours = model(x)
        assert launches.read()["group_norm"] == before + 18
        monkeypatch.setattr(encodec.GroupNorm1, "forward", torch.nn.GroupNorm.forward)
        aten = model(x)
    err = ((ours - aten).abs().max() / aten.abs().max()).item()
    assert ours.shape == (8, 1500, 128)
    assert err < BAR, err
