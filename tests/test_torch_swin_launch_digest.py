"""CLAP's two float32 Swin launches on the card, frozen by digest.

swin_block_fused at stage 1 (C 96, 4 heads, a shifted layer of 64 windows an
image) and window_attention_fused at stage 4 (C 768, 32 heads, one window an
image), each over 64 images on seeded inputs, as CLAP's forward calls them on
a 64-clip chunk. The sha256 of every output byte was taken on the kernels
before their GEMM became a general product (gemm_tf32) with 1024-wide
LayerNorms staged in shared memory: the products, the ring, the epilogues and
the grid are to stay as they were, bit for bit.

    PYTHONPATH=. python tests/test_torch_swin_launch_digest.py

prints the digests on a card (how they were taken, on an H100 with torch
2.11.0+cu128).
"""

import hashlib

import pytest

torch = pytest.importorskip("torch")

from frechet_audio_distance_exported_tpu_torch.models.clap import _shift_attn_mask  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import window_attn  # noqa: E402

IMAGES = 64
# name -> (launch, C, heads, image side in windows of 8, shifted)
CASES = {
    "swin_block_fused.c96": ("swin_block_fused", 96, 4, 8, True),
    "window_attention_fused.c768": ("window_attention_fused", 768, 32, 1, False),
}
DIGESTS = {
    "swin_block_fused.c96": "2e1f2e43ba081db6e28a58445ece958e767601bf9ca03ac884f1ec2313195b12",
    "window_attention_fused.c768":
        "99c71bf00405bad6a0991fabae2537645540ba77d5d583bbd63415c1321c0a5b",
}


def inputs(c: int, heads: int, side: int, shifted: bool, device) -> dict:
    """Keyword arguments of the launch, drawn on the CPU from a fixed seed."""
    gen = torch.Generator().manual_seed(c)
    nw = side * side

    def normal(*shape, scale=1.0, offset=0.0):
        return (offset + scale * torch.randn(shape, generator=gen)).to(device)

    if shifted:
        mask = torch.from_numpy(_shift_attn_mask(8 * side, 8, 4)).to(device)
    else:
        mask = torch.zeros((1, 64, 64), device=device)
    args = dict(
        x_windows=normal(IMAGES * nw, 64, c, scale=0.5),
        w_qkv=normal(c, 3 * c, scale=0.05), b_qkv=normal(3 * c, scale=0.01),
        w_proj=normal(c, c, scale=0.05), b_proj=normal(c, scale=0.01),
        bias=normal(heads, 64, 64, scale=0.1), mask=mask,
        gamma1=normal(c, scale=0.1, offset=1.0), beta1=normal(c, scale=0.1),
        heads=heads, num_windows=nw,
    )
    return args


def digest(name: str, device) -> str:
    launch, c, heads, side, shifted = CASES[name]
    args = inputs(c, heads, side, shifted, device)
    if launch == "swin_block_fused":
        gen = torch.Generator().manual_seed(c + 1)
        args.update(
            gamma2=(1.0 + 0.1 * torch.randn(c, generator=gen)).to(device),
            beta2=(0.1 * torch.randn(c, generator=gen)).to(device),
            w_fc1=(0.05 * torch.randn((c, 4 * c), generator=gen)).to(device),
            b_fc1=(0.01 * torch.randn(4 * c, generator=gen)).to(device),
            w_fc2=(0.05 * torch.randn((4 * c, c), generator=gen)).to(device),
            b_fc2=(0.01 * torch.randn(c, generator=gen)).to(device),
        )
    out = getattr(window_attn, launch)(**args)
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_launch_output_is_the_frozen_digest(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert digest(name, torch.device("cuda")) == DIGESTS[name]


if __name__ == "__main__":
    for case in sorted(CASES):
        print(case, digest(case, torch.device("cuda")))
