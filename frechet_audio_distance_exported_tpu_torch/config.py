"""Numerics and device configuration.

The port computes in exact float32. A float32 matrix product on the card
already runs in full float32 by default, but cuDNN runs float32
convolutions in TF32 unless told otherwise, which would cost VGGish's six
convolutions about four decimal digits without anyone noticing. Both flags
are set by FrechetAudioDistance.__init__, never at import time: importing a
library must not change global state (the JAX package's rule,
frechet_audio_distance_exported_tpu/config.py:39-52).

Reduced precision (TF32, bf16) is not offered: it has to be earned first by
an FAD-delta measurement on the card.
"""

from __future__ import annotations

import os

import torch


def exact_sqrtm() -> bool:
    """FAD_TPU_EXACT_SQRTM=1 selects the reference's scipy sqrtm algorithm
    bit-for-bit over the exact-but-faster Gram/eigh epilogues (copied from
    frechet_audio_distance_exported_tpu/config.py:77-80)."""
    return os.environ.get("FAD_TPU_EXACT_SQRTM", "") not in ("", "0")


def set_exact_float32() -> None:
    """Turn TF32 off for cuBLAS matrix products and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
