"""GroupNorm(1, C) forward: the CUDA kernel pair's wrapper and its plain version.

group_norm launches csrc/group_norm.cu (group_norm_moments_kernel, then
group_norm_apply_kernel), whose header says what bounds it and how it is
laid out. It replaces no Pallas kernel: the JAX package leaves the op to
XLA (models/common.py:100, group_norm_full). A CPU tensor goes to
group_norm_reference, the plain torch version of the same arithmetic; a
CUDA tensor goes to the kernels or raises. There is no fallback from one
to the other.

For x [B, C, T] and each row b (one clip):
  K = x[b, 0, 0];  s1, s2 = sum (x - K), sum (x - K)^2
  mean = K + s1/N,  var = max(s2/N - (s1/N)^2, 0),  rstd = 1/sqrt(var + eps)
  a_c = gamma_c * rstd,  b_c = beta_c - mean * a_c   (float64, then float32)
  y = x * a_c + b_c   (float32, then x's type)
with N = C*T. The kernels sum within a thread in float32 and from there on
in float64; the plain version sums in float64 throughout. The shift K keeps
mean^2 out of the float32 sums, where E[x^2] - mean^2 would cancel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, launches

DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256  # a block of either kernel
WAVES = 4  # a call aims at this many full waves of blocks on every SM
MIN_SLICE = 8192  # elements a block reads at least: 32 a thread
MAX_TABLE = 1024  # channels one apply block may span (its table in shared memory)
ALIGN = 16  # bytes: the kernels load and store 16 bytes at a time
MAX_BATCH = 65535  # the rows go on gridDim.y
MAX_ROW = 2**31 - 1  # the apply kernel finds a channel by 32-bit division
REFERENCE_PIECE = 1 << 20  # elements of the plain version's float64 buffer


def geometry(batch: int, n: int, t: int, vec: int, resident: int) -> tuple:
    """(chunk, splits): each row of n elements is cut into splits slices of
    chunk elements (the last shorter, none empty), block (split, b) taking
    one. Aims at WAVES full waves of ``resident`` blocks (the card's SMs
    times the blocks an SM holds) over the batch, with at least MIN_SLICE
    elements a block; chunk is a multiple of vec (elements in 16 bytes) and
    spans at most MAX_TABLE channels of t elements."""
    splits = max(1, min(WAVES * resident // batch, n // MIN_SLICE))
    chunk = -(-n // splits)
    chunk = min(-(-chunk // vec) * vec, (MAX_TABLE - 2) * t // vec * vec)
    return chunk, -(-n // chunk)


@functools.lru_cache(maxsize=16)
def _resident_blocks(device: torch.device, dtype: torch.dtype) -> int:
    """The blocks of both kernels the card holds at once: its SMs times the
    blocks an SM holds of the busier kernel."""
    with torch.cuda.device(device):
        per_sm = _build.load_library().group_norm_blocks_per_sm(int(dtype == torch.bfloat16))
    if per_sm <= 0:
        raise RuntimeError(f"group_norm occupancy query failed with cudaError {-per_sm}")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """Plain torch version: the kernels' arithmetic with float64 row sums.
    Each row goes through one reused float64 buffer of about REFERENCE_PIECE
    elements, whole channels at a time, once for the sums and once for y:
    a float64 copy of a whole row is slow to allocate on a CPU."""
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    w64, b64 = weight.to(torch.float64), bias.to(torch.float64)
    batch, channels, t = x.shape
    n = channels * t
    step = max(1, REFERENCE_PIECE // t)  # channels a piece
    buf = torch.empty((min(step, channels), t), dtype=torch.float64, device=x.device)
    pieces = [(c0, min(step, channels - c0)) for c0 in range(0, channels, step)]
    for b in range(batch):
        shift = x[b, 0, 0].to(torch.float64)
        s1 = s2 = 0.0
        for c0, k in pieces:
            d = buf[:k].copy_(x[b, c0 : c0 + k]).sub_(shift).view(-1)
            s1, s2 = s1 + d.sum(), s2 + torch.dot(d, d)
        m1 = s1 / n
        var = torch.clamp(s2 / n - m1 * m1, min=0.0)
        mean, rstd = shift + m1, 1.0 / torch.sqrt(var + eps)
        a = w64 * rstd
        c = (b64 - mean * a).to(torch.float32).to(torch.float64)
        a = a.to(torch.float32).to(torch.float64)
        for c0, k in pieces:
            # x * a is exact in float64 (24 by 24 significant bits); the sum
            # is rounded to float64, then to float32, where the kernel's fma
            # rounds once: the two may differ by one float32 ulp.
            y = buf[:k].copy_(x[b, c0 : c0 + k])
            y.mul_(a[c0 : c0 + k, None]).add_(c[c0 : c0 + k, None])
            out[b, c0 : c0 + k] = y if x.dtype == torch.float32 else y.to(torch.float32)
    return out


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """GroupNorm(1, C) of x [B, C, T] (float32 or bfloat16, contiguous) with
    weight and bias [C] of x's dtype; a new tensor of x's dtype.

    CPU tensor: the plain version. CUDA tensor: the hand-written kernels."""
    if x.dtype not in DTYPES:
        raise TypeError(f"group_norm takes float32 or bfloat16, got {x.dtype}")
    if weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"group_norm needs weight and bias of x's dtype {x.dtype}, got "
                        f"{weight.dtype} and {bias.dtype}")
    if x.dim() != 3:
        raise ValueError(f"group_norm takes [B, C, T], got shape {tuple(x.shape)}")
    batch, channels, t = x.shape
    if weight.shape != (channels,) or bias.shape != (channels,):
        raise ValueError(f"group_norm needs weight and bias of shape ({channels},), got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    if not x.is_contiguous():
        raise ValueError("group_norm needs a contiguous x")
    if x.device.type == "cpu":
        return group_norm_reference(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on CPU or CUDA tensors, got {x.device}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError(f"group_norm needs weight and bias on {x.device}")
    if x.data_ptr() % ALIGN:
        raise ValueError(f"group_norm needs x to start on {ALIGN} bytes")
    n = channels * t
    if batch > MAX_BATCH or n > MAX_ROW:
        raise ValueError(f"group_norm takes at most {MAX_BATCH} rows of {MAX_ROW} elements, "
                         f"got {batch} of {n}")
    out = torch.empty_like(x)
    if batch == 0 or n == 0:
        return out

    bf16 = x.dtype == torch.bfloat16
    chunk, splits = geometry(batch, n, t, ALIGN // x.element_size(),
                             _resident_blocks(x.device, x.dtype))
    partial = torch.empty((batch, splits, 2), dtype=torch.float64, device=x.device)
    weight, bias = weight.contiguous(), bias.contiguous()
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.group_norm_launch(
            *(ctypes.c_void_p(p.data_ptr()) for p in (x, weight, bias, partial, out)),
            batch, n, t, chunk, splits, float(eps), int(bf16), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"group_norm kernel launch failed with cudaError {err}")
    launches.count("group_norm[bf16]" if bf16 else "group_norm")
    return out
