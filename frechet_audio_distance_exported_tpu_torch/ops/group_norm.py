"""GroupNorm(1, C) forward with a convolution's epilogue: the CUDA kernel
pair's wrapper and its plain version.

On the card each norm's moments are one launch of csrc/group_norm.cu's
group_norm_moments_kernel, and the apply, one launch of
group_norm_apply_kernel, writes what the next convolution reads (the
header of the .cu file says what bounds the pair and how it is laid out).
It replaces no Pallas kernel: the JAX package leaves the op to XLA
(models/common.py:100, group_norm_full). A CPU tensor goes to the plain
version (group_norm_reference for the norm, ATen's ops for the rest); a
CUDA tensor goes to the kernels or raises. There is no fallback from one to
the other.

For x = y + conv_bias [B, C, T] (the convolution's bias added as ATen's
add_ adds it, where the convolution left it out) and each row b (one clip):
  K = x[b, 0, 0];  s1, s2 = sum (x - K), sum (x - K)^2
  mean = K + s1/N,  var = max(s2/N - (s1/N)^2, 0),  rstd = 1/sqrt(var + eps)
  a_c = gamma_c * rstd,  b_c = beta_c - mean * a_c   (float64, then float32)
  g = x * a_c + b_c   (float32, then x's type)
with N = C*T. The kernels sum within a thread in float32 and from there on
in float64; the plain version sums in float64 throughout. The shift K keeps
mean^2 out of the float32 sums, where E[x^2] - mean^2 would cancel.

The forms (FORMS), each the apply's output as its consumer reads it: plain
g (plain()); elu reflect_pad(elu(g)) (elu_pad()); split g and
reflect_pad(elu(g)) (split()); residual reflect_pad(elu(g + g2)) of two
norms (residual()). group_norm() is plain() of a tensor that holds its
bias. On the card each call counts one ``group_norm`` a norm and one
``group_norm_apply.<form>`` (``[bf16]`` after each in bf16).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build, launches

DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256  # a block of either kernel
WAVES = 4  # a call aims at this many full waves of blocks on every SM
MIN_SLICE = 8192  # elements a block reads at least: 32 a thread
MAX_TABLE = 1024  # channels one apply block may span (its table in shared memory)
ALIGN = 16  # bytes: the kernels load and store 16 bytes at a time
MAX_BATCH = 65535  # the rows go on gridDim.y
MAX_ROW = 2**31 - 1  # the kernels find a channel by a 32-bit multiply and shift
REFERENCE_PIECE = 1 << 20  # elements of the plain version's float64 buffer
FORMS = ("plain", "elu", "split", "residual")  # csrc/group_norm.cu's PLAIN, ELU, SPLIT, RESIDUAL
MOMENTS = -1  # csrc/group_norm.cu's MOMENTS: the kernel that group_norm_blocks_per_sm names


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


@functools.lru_cache(maxsize=64)
def _resident_blocks(device: torch.device, dtype: torch.dtype, kernel: int) -> int:
    """The blocks of one kernel (MOMENTS, or the apply's form: an index of
    FORMS) the card holds at once: its SMs times the blocks an SM holds."""
    with torch.cuda.device(device):
        per_sm = _build.load_library().group_norm_blocks_per_sm(int(dtype == torch.bfloat16),
                                                                kernel)
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


class Norm(NamedTuple):
    """One GroupNorm(1, C) of a convolution's output: y [B, C, T]; the
    convolution's bias [C] where the convolution left it out (None: y holds
    it); the norm's weight and bias [C] and eps."""

    y: torch.Tensor
    conv_bias: Optional[torch.Tensor]
    weight: torch.Tensor
    bias: torch.Tensor
    eps: float


def divisor(t: int) -> tuple:
    """(mul, shift) with e // t == (e * mul) >> shift for 0 <= e < 2**31 and
    mul < 2**32: the kernels' Divisor (Granlund and Montgomery's multiply
    and shift, from ceil(log2 t))."""
    shift = 31 + (t - 1).bit_length()
    return -(-(1 << shift) // t), shift


def plain(norm: Norm) -> torch.Tensor:
    """g = GroupNorm(y + conv_bias): what the LSTM and the encoder's output take."""
    return _epilogue("plain", (norm,), 0, 0)


def elu_pad(norm: Norm, left: int, right: int) -> torch.Tensor:
    """reflect_pad(elu(g), left, right): what a convolution that follows an
    ELU takes (conv2 of a residual block, after conv1's norm)."""
    return _epilogue("elu", (norm,), left, right)


def split(norm: Norm, left: int, right: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g, reflect_pad(elu(g), left, right)): a stage's input, which the
    shortcut takes as it is and conv1 after ELU and its pad."""
    return _epilogue("split", (norm,), left, right)


def residual(norm: Norm, other: Norm, left: int, right: int) -> torch.Tensor:
    """reflect_pad(elu(g + g_other), left, right): a residual block's two
    branches (conv2's norm and the shortcut's, each with its own moments and
    affine) summed, as the strided convolution after them takes it."""
    return _epilogue("residual", (norm, other), left, right)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """GroupNorm(1, C) of x [B, C, T] (float32 or bfloat16, contiguous) with
    weight and bias [C] of x's dtype; a new tensor of x's dtype: plain()
    of x with no conv bias.

    CPU tensor: the plain version. CUDA tensor: the hand-written kernels."""
    return plain(Norm(x, None, weight, bias, eps))


def _check(norm: Norm, like: torch.Tensor) -> None:
    x = norm.y
    if x.dtype not in DTYPES:
        raise TypeError(f"group_norm takes float32 or bfloat16, got {x.dtype}")
    params = [norm.weight, norm.bias] + ([] if norm.conv_bias is None else [norm.conv_bias])
    if any(p.dtype != x.dtype for p in params):
        raise TypeError(f"group_norm needs its weight, bias and conv_bias of x's dtype {x.dtype}, "
                        f"got {[p.dtype for p in params]}")
    if x.dim() != 3:
        raise ValueError(f"group_norm takes [B, C, T], got shape {tuple(x.shape)}")
    if x.shape != like.shape or x.dtype != like.dtype or x.device != like.device:
        raise ValueError(f"a residual's two norms need one shape, dtype and device, got "
                         f"{tuple(x.shape)} and {tuple(like.shape)}")
    channels = x.shape[1]
    if any(p.shape != (channels,) for p in params):
        raise ValueError(f"group_norm needs weight, bias and conv_bias of shape ({channels},), "
                         f"got {[tuple(p.shape) for p in params]}")
    if not x.is_contiguous():
        raise ValueError("group_norm needs a contiguous x")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"group_norm runs on CPU or CUDA tensors, got {x.device}")
    if x.device.type == "cuda":
        if any(p.device != x.device for p in params):
            raise ValueError(f"group_norm needs weight, bias and conv_bias on {x.device}")
        if x.data_ptr() % ALIGN:
            raise ValueError(f"group_norm needs x to start on {ALIGN} bytes")


def _epilogue(form: str, norms: tuple, left: int, right: int):
    """The norms and the epilogue of form (FORMS) on CPU tensors (the plain
    composition) or CUDA tensors (the kernels); its outputs."""
    for norm in norms:
        _check(norm, norms[0].y)
    batch, channels, t = norms[0].y.shape
    if min(left, right) < 0 or (left or right) and (max(left, right) >= t or form == "plain"):
        raise ValueError(f"the {form} form cannot pad a row of {t} by ({left}, {right})")
    if norms[0].y.device.type == "cpu":
        return _compose(form, norms, left, right)
    return _card(form, norms, left, right)


def _compose(form: str, norms: tuple, left: int, right: int):
    """The plain version: ATen's composition, with group_norm_reference for
    each norm, the convolution's bias added as ATen's add_ adds it."""
    g = [group_norm_reference(n.y if n.conv_bias is None else n.y + n.conv_bias[:, None],
                              n.weight, n.bias, n.eps) for n in norms]
    if form == "plain":
        return g[0]
    act = F.elu(g[0] + g[1] if form == "residual" else g[0])
    if left or right:
        act = F.pad(act, (left, right), mode="reflect")
    return (g[0], act) if form == "split" else act


def _card(form: str, norms: tuple, left: int, right: int):
    y = norms[0].y
    batch, channels, t = y.shape
    n = channels * t
    if batch > MAX_BATCH or n > MAX_ROW:
        raise ValueError(f"group_norm takes at most {MAX_BATCH} rows of {MAX_ROW} elements, "
                         f"got {batch} of {n}")
    raw = torch.empty_like(y) if form in ("plain", "split") else None
    act = (torch.empty((batch, channels, left + t + right), dtype=y.dtype, device=y.device)
           if form != "plain" else None)
    outs = raw if act is None else act if raw is None else (raw, act)
    if batch == 0 or n == 0:
        return outs

    # Contiguous parameters, held until the launches are queued.
    norms = tuple(Norm(m.y, None if m.conv_bias is None else m.conv_bias.contiguous(),
                       m.weight.contiguous(), m.bias.contiguous(), m.eps) for m in norms)
    bf16 = y.dtype == torch.bfloat16
    # Each kernel's grid from its own occupancy, as (chunk, splits, width:
    # the channels a slice spans at most). The apply reads the moments'
    # splits partials a row, whatever its own grid.
    grids = []
    for kernel in (MOMENTS, FORMS.index(form)):
        chunk, splits = geometry(batch, n, t, ALIGN // y.element_size(),
                                 _resident_blocks(y.device, y.dtype, kernel))
        grids.append((chunk, splits, min(channels, (chunk - 1) // t + 2)))
    moments, grid = grids
    mul, shift = divisor(t)
    partials = []
    lib = _build.load_library()
    with torch.cuda.device(y.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(y.device).cuda_stream)
        for norm in norms:
            partial = torch.empty((batch, moments[1], 2), dtype=torch.float64, device=y.device)
            err = lib.group_norm_moments_launch(
                _ptr(norm.y), _ptr(norm.conv_bias), _ptr(partial), batch, n, t, mul, shift,
                *moments, int(bf16), stream)
            if err != 0:
                raise RuntimeError(f"group_norm moments launch failed with cudaError {err}")
            partials.append(partial)
        second = norms[-1]
        err = lib.group_norm_apply_launch(
            FORMS.index(form),
            *(_ptr(p) for p in norms[0][:4]), _ptr(partials[0]), float(norms[0].eps),
            *(_ptr(p) for p in second[:4]), _ptr(partials[-1]),
            float(second.eps), _ptr(raw), _ptr(act), left, right, batch, n, t, mul, shift,
            *grid, moments[1], int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"group_norm {form} launch failed with cudaError {err}")
    suffix = "[bf16]" if bf16 else ""
    for _ in norms:
        launches.count("group_norm" + suffix)
    launches.count(f"group_norm_apply.{form}{suffix}")
    return outs


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())
