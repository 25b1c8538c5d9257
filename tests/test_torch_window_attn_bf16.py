"""The bf16 Swin window kernels (csrc/window_attn_bf16.cu): what the wrapper
refuses before a launch, on the CPU, and each kernel against its plain bf16
version on the card.

The kernels are warp-specialised: two consumer warpgroups of 64 rows (one
window each in swin_block_fused, half of a 128-row token tile in
window_attention_fused's GEMMs) share every weight slab a producer stages.
A BW that is odd leaves a block's last window pair, or the GEMMs' last
128-row tile, half empty: the ragged cases below (nine windows an image, a
24 x 24 token grid shifted: nine masks, window w using mask[w % 9]).

Bound on the card, as tests/test_torch_precision.py holds the plain bf16
versions to the Pallas kernels: 2 bf16 ulps of the output's largest
magnitude, and 90 % of the elements within one ulp of their own value. Both
sides round at the same points; float32 sums in another order, and the
kernel's GELU (the Pallas kernel's Abramowitz-Stegun erf, within 1.5e-7 of
erf), move a value across a bf16 rounding boundary now and then.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from frechet_audio_distance_exported_tpu_torch.ops import launches, window_attn  # noqa: E402
from test_torch_clap_window_attn import make_inputs, operands  # noqa: E402

N = 64
ULPS = 2.0
WITHIN = 0.9

# name -> (kernel, C, heads, windows per image, shifted, images)
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


def bf16_operands(kernel, c, heads, nw, shifted, images, device="cpu", seed=3):
    args = operands(kernel, make_inputs(c, heads, nw, shifted, images, seed=seed), device)
    return {k: v if k == "mask" else v.to(torch.bfloat16) for k, v in args.items()}


def _ulp(v):
    """The spacing of bf16 values at |v|."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


# ---------------------------------------------------------------------------
# What the wrapper refuses before a launch (checked on CPU tensors: the
# checks read shapes, strides and addresses, not the device)
# ---------------------------------------------------------------------------

def _misaligned(t):
    """t's values in a view 2 bytes (one bf16) past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)[1:1 + t.numel()]
    flat.copy_(t.reshape(-1))
    return flat.reshape(t.shape)


REFUSALS = {
    # the block kernel keeps a whole block on chip only at CLAP's stage 1-3 widths
    "block_width": ("swin_block_fused", 288, 12, lambda a: a, "takes C in"),
    "head_dim": ("swin_block_fused", 96, 2, lambda a: a, "head_dim"),
    "heads_in_fours": ("window_attention_fused", 48, 2, lambda a: a, "a multiple of 4"),
    "x_alignment": ("swin_block_fused", 96, 4,
                    lambda a: {**a, "x_windows": _misaligned(a["x_windows"])}, "aligned"),
    "weight_alignment": ("window_attention_fused", 96, 4,
                         lambda a: {**a, "w_qkv": _misaligned(a["w_qkv"])}, "aligned"),
    "contiguous": ("swin_block_fused", 96, 4,
                   lambda a: {**a, "w_fc1": a["w_fc1"].T.contiguous().T}, "contiguous"),
    "windows": ("window_attention_fused", 96, 4,
                lambda a: {**a, "x_windows": a["x_windows"][:1].expand(
                    window_attn.KERNEL_MAX_WINDOWS + 1, N, 96)}, "at most"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_bf16_kernel_checks_refuse_what_the_kernels_do_not_take(case):
    kernel, c, heads, edit, message = REFUSALS[case]
    args = edit(bf16_operands(kernel, c, heads, 1, False, 2))
    x = args.pop("x_windows")
    with pytest.raises(ValueError, match=message):
        window_attn._check_kernel_shapes(kernel, x, heads, args)


@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_bf16_kernel_checks_pass_the_card_cases(case):
    """Every card case below passes the wrapper's checks (a view of the
    same values, aligned and contiguous, is what a launch gets)."""
    kernel, c, heads, nw, shifted, images = CARD_CASES[case]
    args = bf16_operands(kernel, c, heads, nw, shifted, images)
    x = args.pop("x_windows")
    window_attn._check(kernel, x, heads, nw, args)
    window_attn._check_kernel_shapes(kernel, x, heads, args)
    assert x.shape == (images * nw, N, c) and (images * nw) % 2 == ("ragged" in case)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """Decided per test, not at import: every xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_bf16_kernel_matches_plain_bf16_version_on_the_card(cuda_device, case):
    kernel, c, heads, nw, shifted, images = CARD_CASES[case]
    args = bf16_operands(kernel, c, heads, nw, shifted, images, cuda_device)
    key = f"{kernel}[bf16]"
    before = launches.read()
    out = getattr(window_attn, kernel)(**args, heads=heads, num_windows=nw)
    torch.cuda.synchronize()
    after = launches.read()
    assert after[key] == before[key] + 1
    assert {k: v for k, v in after.items() if k != key} == {
        k: v for k, v in before.items() if k != key}
    ref = getattr(window_attn, f"{kernel}_reference")(**args, heads=heads, num_windows=nw)
    assert out.dtype == ref.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    out, ref = out.float().cpu().numpy(), ref.float().cpu().numpy()
    diff = np.abs(out - ref)
    assert diff.max() <= ULPS * _ulp(np.abs(ref).max())
    assert (diff <= _ulp(ref)).mean() >= WITHIN


@pytest.mark.cuda
def test_bf16_block_kernel_is_deterministic_and_leaves_its_inputs(cuda_device):
    """Two calls give the same bits (no atomics, no race between the
    warpgroups), and the inputs are not written."""
    args = bf16_operands("swin_block_fused", 192, 8, 9, True, 3, cuda_device)
    copies = {k: v.clone() for k, v in args.items()}
    first = window_attn.swin_block_fused(**args, heads=8, num_windows=9)
    second = window_attn.swin_block_fused(**args, heads=8, num_windows=9)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert all(torch.equal(args[k], copies[k]) for k in args)
