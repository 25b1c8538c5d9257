"""Kernel launch counts of this process, one key per CUDA kernel wrapper and
dtype (the bf16 instances of the Swin kernels and of GroupNorm count as
"<name>[bf16]").

A wrapper adds one to its own key where it launches its kernel, and nowhere
else: a call that goes to the plain version does not count, and a wrapper
whose kernel runs as several CUDA launches counts one per call. GroupNorm
counts one ``group_norm`` a norm (its moments) and, where the apply writes
a convolution's epilogue, one ``group_norm_apply.<form>`` an apply
(ops/group_norm.py's FORMS). window_attn.gemm_tf32, the general product,
counts one under the key its caller passes: WavLM's products count
``wavlm_gemm``. ops/wavlm_attn.wavlm_attention counts one
``wavlm_attention`` a launch of its kernel, one a layer of a float32 WavLM
forward; a bf16 model's attention runs in ATen on the card and
models/wavlm.py counts it as ``wavlm_attention[bf16]`` (its products run in
ATen too and are not counted). Harnesses
set every count to 0 with zero() and take them all with read().
"""

from __future__ import annotations

LAUNCHES = {
    "fused_vggish_logmel": 0,
    "fused_pann_logmel": 0,
    "swin_block_fused": 0,
    "window_attention_fused": 0,
    "swin_block_fused[bf16]": 0,
    "window_attention_fused[bf16]": 0,
    "group_norm": 0,
    "group_norm[bf16]": 0,
    "group_norm_apply.plain": 0,
    "group_norm_apply.elu": 0,
    "group_norm_apply.split": 0,
    "group_norm_apply.residual": 0,
    "group_norm_apply.plain[bf16]": 0,
    "group_norm_apply.elu[bf16]": 0,
    "group_norm_apply.split[bf16]": 0,
    "group_norm_apply.residual[bf16]": 0,
    "wavlm_gemm": 0,
    "wavlm_attention": 0,
    "wavlm_attention[bf16]": 0,
}


def count(name: str) -> None:
    LAUNCHES[name] += 1


def zero() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def read() -> dict:
    """A copy of every count."""
    return dict(LAUNCHES)
