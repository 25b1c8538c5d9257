"""Numerics and device configuration: the JAX package's FAD_TPU_* knobs.

The same environment variables, spellings and errors as
frechet_audio_distance_exported_tpu/config.py, resolved to torch dtypes and
a precision name. Every value is read when it is used (a model is built, a
forward runs), never at import time: importing a library must not change
global state (the JAX package's rule, config.py:39-52).

Unset, every knob resolves to exact float32, which is what the JAX package
resolves to on every backend but the TPU ("the platform default", L121-123
and L151-153):
- FAD_TPU_PRECISION (matmul_precision): 'highest', or unset, keeps TF32 off
  for cuBLAS products and cuDNN convolutions (cuDNN would otherwise run
  float32 convolutions in TF32); 'high', 'default' or 'bfloat16' turn TF32
  on for both (apply_precision), which also reaches cuDNN's LSTM. The Swin
  kernels form their float32 products in 3xTF32 under every value.
- FAD_TPU_MODEL_DTYPE (model_dtype): 'bfloat16' runs the models in bf16
  (Encodec mixed: its LSTM and output convolution stay float32;
  pipeline.cast_model); statistics stay float32.
- FAD_TPU_LSTM_MATMUL (lstm_op_dtype): 'bfloat16' rounds Encodec's
  recurrent-product operands to bf16 (models.encodec.SLSTM); the carry,
  the gates and their sums stay float32.
- FAD_TPU_FUSED_BLOCK (fused_block): '0' runs CLAP's stages 1-3 through the
  attention-only kernel with the MLP in torch.
A reduced-precision mode is opt-in: the default stays exact float32 until
an FAD-delta measurement on the card earns another (PERF.md).
"""

from __future__ import annotations

import os

import torch

# FAD_TPU_PRECISION's names and what each means (JAX config.py:20-25): 'bfloat16'
# is another name for 'default'.
_PRECISIONS = {"highest": "highest", "high": "high", "default": "default", "bfloat16": "default"}


def matmul_precision() -> str:
    """FAD_TPU_PRECISION as 'highest', 'high' or 'default' (copied from
    frechet_audio_distance_exported_tpu/config.py:28-36, where unset means
    'high': a bf16x3 product on the TPU, exact float32 on its CPU backend).
    Unset here means 'highest', exact float32, which is what the JAX
    package's unset value computes off the TPU."""
    name = os.environ.get("FAD_TPU_PRECISION", "highest").strip().lower()
    try:
        return _PRECISIONS[name]
    except KeyError:
        raise ValueError(
            f"FAD_TPU_PRECISION={name!r}: expected one of {sorted(_PRECISIONS)}"
        ) from None


def exactness_forced() -> bool:
    """True when the user explicitly asked for the bitwise-closest numerics:
    FAD_TPU_PRECISION=highest, or an explicit FAD_TPU_MODEL_DTYPE=float32
    (copied from frechet_audio_distance_exported_tpu/config.py:60-75). It
    keeps the Encodec LSTM's operands float32 (lstm_op_dtype)."""
    if os.environ.get("FAD_TPU_PRECISION", "").strip().lower() == "highest":
        return True
    return model_dtype_is_forced() and model_dtype() == torch.float32


def model_dtype_is_forced() -> bool:
    """True when FAD_TPU_MODEL_DTYPE is set explicitly (copied from
    frechet_audio_distance_exported_tpu/config.py:83-87): encodec-48k runs
    in bf16 only then (pipeline.model_compute_dtype)."""
    return bool(os.environ.get("FAD_TPU_MODEL_DTYPE"))


def model_dtype() -> torch.dtype:
    """The models' compute dtype: FAD_TPU_MODEL_DTYPE=float32|bfloat16 forces
    it, a typo raises, unset is float32 (copied from
    frechet_audio_distance_exported_tpu/config.py:90-123, whose unset value
    is float32 off the TPU)."""
    name = os.environ.get("FAD_TPU_MODEL_DTYPE", "").strip().lower()
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "f32", "fp32"):
        return torch.float32
    if name:
        raise ValueError(f"FAD_TPU_MODEL_DTYPE={name!r}: expected 'float32' or 'bfloat16'")
    return torch.float32


def lstm_op_dtype() -> torch.dtype:
    """Operand dtype of Encodec's in-scan recurrent products:
    FAD_TPU_LSTM_MATMUL=float32|bfloat16 forces it, a typo raises, an
    exactness force keeps float32, and unset is float32 (copied from
    frechet_audio_distance_exported_tpu/config.py:126-153, whose unset
    value is float32 off the TPU)."""
    name = os.environ.get("FAD_TPU_LSTM_MATMUL", "").strip().lower()
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "f32", "fp32"):
        return torch.float32
    if name:
        raise ValueError(f"FAD_TPU_LSTM_MATMUL={name!r}: expected 'float32' or 'bfloat16'")
    # Unset: float32 whether or not exactness is forced (the force and the
    # off-TPU default agree); exactness_forced() still raises on a
    # FAD_TPU_MODEL_DTYPE typo, as the JAX package's resolution does.
    exactness_forced()
    return torch.float32


def fused_block() -> bool:
    """FAD_TPU_FUSED_BLOCK: False for 0/false/off/no, True for 1/true/on/
    yes/force or unset, a ValueError for anything else (the spellings of
    _env_flag, frechet_audio_distance_exported_tpu/models/clap.py:84-97).
    False runs CLAP's stages 1-3 through window_attention_fused with the
    MLP in torch instead of swin_block_fused."""
    val = os.environ.get("FAD_TPU_FUSED_BLOCK")
    if val is None:
        return True
    v = val.strip().lower()
    if v in ("0", "false", "off", "no"):
        return False
    if v in ("1", "true", "on", "yes", "force"):
        return True
    raise ValueError(
        f"FAD_TPU_FUSED_BLOCK={val!r}: expected 0/false/off/no or 1/true/on/yes/force"
    )


def exact_sqrtm() -> bool:
    """FAD_TPU_EXACT_SQRTM=1 selects the reference's scipy sqrtm algorithm
    bit-for-bit over the exact-but-faster Gram/eigh epilogues (copied from
    frechet_audio_distance_exported_tpu/config.py:77-80)."""
    return os.environ.get("FAD_TPU_EXACT_SQRTM", "") not in ("", "0")


def apply_precision() -> str:
    """Set cuBLAS's and cuDNN's TF32 flags from matmul_precision(): off for
    'highest' (unset), on otherwise. bf16 products keep float32 sums
    (allow_bf16_reduced_precision_reduction off), as the JAX package's
    preferred_element_type=float32 does. Returns the precision name."""
    precision = matmul_precision()
    tf32 = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return precision


def resolve_device(device) -> torch.device:
    """The torch.device to run on; a CUDA device without CUDA raises (the
    port never quietly carries on on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain CPU path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA or CPU device, got {device!r}")
    return dev
