"""CLAP's Swin window kernels: the CUDA wrappers and their plain versions.

Counterpart of frechet_audio_distance_exported_tpu/ops/pallas_window_attn.py,
with the same layout contract (one layer over partitioned 8x8 windows):

  x_windows : [BW, N, C]   BW = batch * windows per image (nW), N = 64
  w_qkv     : [C, 3C]      b_qkv [3C]       (weights are [in, out])
  w_proj    : [C, C]       b_proj [C]
  bias      : [H, N, N]    gathered relative-position bias
  mask      : [nW, N, N]   additive shift mask indexed by window-in-image
                           (window w of the BW axis uses mask[w % nW]), or
                           [1, N, N] of zeros for an unshifted layer
  w_fc1     : [C, 4C]      b_fc1 [4C];  w_fc2 [4C, C], b_fc2 [C]

- window_attention_fused: x + proj(attn(LN1(x))), the attention half
  (TPU kernel at pallas_window_attn.py:217);
- swin_block_fused: the whole pre-norm block, the attention half followed
  by x2 + fc2(GELU(fc1(LN2(x2)))) (TPU kernel at pallas_window_attn.py:152).

attn is softmax(q k^T * hd^-1/2 + bias[h] + mask) v per head, with head
columns h*hd .. h*hd + hd - 1 of q, k and v; LayerNorm is two-pass with eps
1e-5, GELU the exact erf form. A CPU tensor goes to the plain torch version
(*_reference); a CUDA tensor goes to csrc/window_attn.cu (float32) or
csrc/window_attn_bf16.cu (bfloat16), whose headers say what bounds them and
how they are laid out, or raises. There is no fallback from one to the
other, and no TPU tile argument (`group`).

A float32 call forms each weight's 3xTF32 split on the card first
(tf32_split: [in, out] -> [2, out, in], hi and lo of the transpose, the
K-major layout TF32 wgmma takes), once per weight a call: the weights are
constants of the forward pass, and the kernels then stage them with no
arithmetic.

gemm_tf32 exposes the float32 kernels' token-tile GEMM as a general product
over any number of rows, op(a) @ w + bias (+ residual) with op a LayerNorm
or a GELU applied on load, in the three forms a pre-LN transformer layer
takes (WavLM's encoder, models/wavlm.py); it has no bf16 instance.

A call is float32 throughout, or bfloat16 throughout but for a float32
mask: then the kernels compute what the Pallas kernels compute for a bf16
x (_attention_half L35-83, _block_kernel L114-146). Products take bf16
operands with float32 sums, LayerNorm, softmax and GELU run in float32, and
the values are rounded to bf16 where the Pallas kernels round them: LN1's
output, qkv after its bias, the softmax probabilities, each head's p v, the
attention residual x2 (LN2's moments are taken over the rounded x2), LN2's
output, GELU's output and the block's output. The plain versions round at
the same points, with every product formed in float32 on the bf16 operands
(exact, so they differ from JAX's preferred_element_type=float32 only in
summation order). The launch counts of the bf16 kernels are kept under
their own keys, "swin_block_fused[bf16]" and "window_attention_fused[bf16]".
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, launches

LN_EPS = 1e-5
# What the CUDA kernels take: 8x8 windows, head_dim 24 (every HTSAT-tiny
# stage), heads in groups of four (96 columns, the kernels' tile width).
KERNEL_TOKENS = 64
KERNEL_HEAD_DIM = 24
KERNEL_HEAD_GROUP = 4
# The widths whose whole block the swin_block_fused kernel keeps on chip
# (CLAP stages 1-3); stage 4 runs window_attention_fused.
KERNEL_BLOCK_WIDTHS = (96, 192, 384)
KERNEL_ALIGN = 16  # bytes: the kernels stream their operands with 16-byte cp.async or TMA
# window_attention_fused's bf16 GEMMs put their 128-token row tiles on
# gridDim.y; the float32 kernels take the same limit.
KERNEL_MAX_WINDOWS = 65535


def _layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Two-pass LayerNorm, as in the TPU kernel (pallas_window_attn.py:45-49)."""
    mean = x.mean(dim=-1, keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    return centered * torch.rsqrt(var + LN_EPS) * gamma + beta


def _rounding(dtype: torch.dtype):
    """The plain versions' rounding points: identity for a float32 call, a
    round trip through bf16 for a bfloat16 one."""
    if dtype == torch.float32:
        return lambda t: t
    return lambda t: t.to(dtype).to(torch.float32)


def _attention_half_reference(x, w_qkv, b_qkv, w_proj, b_proj, bias, mask, gamma1, beta1, heads):
    """The attention residual x + proj(attn(LN1(x))) in float32, from
    operands of x.dtype, rounded where the Pallas kernel rounds."""
    rnd = _rounding(x.dtype)
    x, w_qkv, b_qkv, w_proj, b_proj, bias, gamma1, beta1 = (
        t.to(torch.float32) for t in (x, w_qkv, b_qkv, w_proj, b_proj, bias, gamma1, beta1))
    bw, n, c = x.shape
    hd = c // heads
    h = rnd(_layer_norm(x, gamma1, beta1))
    qkv = rnd(torch.matmul(h, w_qkv) + b_qkv)
    q, k, v = qkv.reshape(bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)  # each [BW, H, N, hd]
    logits = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5) + bias
    nw = mask.shape[0]
    logits = logits.reshape(bw // nw, nw, heads, n, n) + mask[None, :, None]
    logits = logits.reshape(bw, heads, n, n)
    attn = rnd(torch.matmul(rnd(torch.softmax(logits, dim=-1)), v))
    attn = attn.transpose(1, 2).reshape(bw, n, c)
    return x + (torch.matmul(attn, w_proj) + b_proj)


def window_attention_fused_reference(
    x_windows, w_qkv, b_qkv, w_proj, b_proj, bias, mask, gamma1, beta1, heads, num_windows
):
    """Plain torch version of window_attention_fused (float32 or bf16)."""
    del num_windows  # the mask's first axis carries it
    return _attention_half_reference(
        x_windows, w_qkv, b_qkv, w_proj, b_proj, bias, mask, gamma1, beta1, heads
    ).to(x_windows.dtype)


def swin_block_fused_reference(
    x_windows, w_qkv, b_qkv, w_proj, b_proj, bias, mask, gamma1, beta1,
    gamma2, beta2, w_fc1, b_fc1, w_fc2, b_fc2, heads, num_windows,
):
    """Plain torch version of swin_block_fused (float32 or bf16)."""
    del num_windows
    rnd = _rounding(x_windows.dtype)
    x2 = rnd(_attention_half_reference(
        x_windows, w_qkv, b_qkv, w_proj, b_proj, bias, mask, gamma1, beta1, heads
    ))
    gamma2, beta2, w_fc1, b_fc1, w_fc2, b_fc2 = (
        t.to(torch.float32) for t in (gamma2, beta2, w_fc1, b_fc1, w_fc2, b_fc2))
    h2 = rnd(_layer_norm(x2, gamma2, beta2))
    hidden = rnd(F.gelu(torch.matmul(h2, w_fc1) + b_fc1))
    return (x2 + (torch.matmul(hidden, w_fc2) + b_fc2)).to(x_windows.dtype)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: add half a TF32 ulp to the magnitude bits, then clear the 13
    low bits (the kernels' split_tf32, the bits of cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split_reference(w: torch.Tensor) -> torch.Tensor:
    """Plain torch version of tf32_split."""
    wt = w.t().contiguous()
    hi = _tf32(wt)
    return torch.stack([hi, _tf32(wt - hi)])


def tf32_split(w: torch.Tensor) -> torch.Tensor:
    """The 3xTF32 form of a float32 weight w [in, out] that the float32
    kernels take: [2, out, in], hi = tf32(w^T) and lo = tf32(w^T - hi), so
    that hi + lo is w^T within 2^-22 relative and each half is TF32-exact.
    CPU tensor: the plain version; CUDA tensor: split_weights_kernel
    (csrc/window_attn.cu), which gives the same bits. in and out must be
    multiples of 32."""
    if w.dim() != 2 or w.dtype != torch.float32:
        raise ValueError(f"tf32_split takes a float32 [in, out] matrix, got {w.dtype} "
                         f"{tuple(w.shape)}")
    k, n = w.shape
    if k % 32 or n % 32 or k == 0 or n == 0:
        raise ValueError(f"tf32_split takes in and out that are multiples of 32, got {k}, {n}")
    if w.device.type == "cpu":
        return tf32_split_reference(w)
    if w.device.type != "cuda":
        raise ValueError(f"tf32_split runs on CPU or CUDA tensors, got {w.device}")
    if not w.is_contiguous() or w.data_ptr() % KERNEL_ALIGN:
        raise ValueError(f"tf32_split needs a contiguous, {KERNEL_ALIGN}-byte aligned matrix "
                         "on the card")
    out = torch.empty((2, n, k), dtype=w.dtype, device=w.device)
    lib = _build.load_library()
    with torch.cuda.device(w.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(w.device).cuda_stream)
        err = lib.tf32_split_launch(*_ptrs(w), k, n, *_ptrs(out), stream)
    if err != 0:
        raise RuntimeError(f"tf32_split kernel launch failed with cudaError {err}")
    return out


# The forms of the general product: what is applied to A as it is read, and
# whether the residual is added (a pre-LN transformer layer's four products).
GEMM_FORMS = {("ln", False), ("plain", True), ("gelu", True)}
GEMM_ON_LOAD = {"plain": 0, "ln": 1, "gelu": 2}  # csrc/window_attn.cu's OnLoad
# The widest LayerNorm the GEMM stages in shared memory (MAX_LN_WIDTH).
GEMM_MAX_LN_WIDTH = 1024


def gemm_tf32_reference(a, w, bias, ln=None, gelu=False, residual=None):
    """Plain torch version of gemm_tf32, in float32."""
    if ln is not None:
        a = _layer_norm(a, *ln)
    elif gelu:
        a = F.gelu(a)
    out = torch.matmul(a, w) + bias
    return out if residual is None else residual + out


def gemm_tf32(a, w, bias, *, key: str, ln=None, gelu: bool = False, residual=None):
    """out [M, N] = op(a) @ w + bias (+ residual), the float32 token-tile GEMM
    of the Swin kernels as a general product over any M rows: a [M, K], w
    [K, N] ([in, out]), bias [N], op a two-pass LayerNorm (``ln``: (gamma,
    beta) [K], eps 1e-5) or the erf GELU (``gelu``) applied as a is read, or
    none. It takes the three forms of a pre-LN transformer layer: LN on load
    with no residual, none or GELU on load with the residual [M, N].

    CPU tensors: the plain version. CUDA tensors: tf32_split of w, the
    LayerNorm statistics (row_stats_kernel) where ``ln`` is given, and
    gemm_tf32_kernel (csrc/window_attn.cu); the card takes K % 32 == 0, N a
    multiple of 96 or 128, K <= 1024 with ``ln``, contiguous 16-byte aligned
    tensors. A call that launches the kernels counts one under the caller's
    ``key`` (ops/launches.py); one on CPU tensors or over no rows counts none."""
    on_load = "ln" if ln is not None else ("gelu" if gelu else "plain")
    if (on_load, residual is not None) not in GEMM_FORMS:
        given = "with" if residual is not None else "without"
        raise ValueError(f"gemm_tf32 takes LN on load without the residual, or none or GELU on "
                         f"load with it; got {on_load} {given}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"gemm_tf32 takes a [M, K] and w [K, N], got {tuple(a.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = a.shape
    n = w.shape[1]
    expected = {"bias": (bias, (n,))}
    if ln is not None:
        expected.update(gamma=(ln[0], (k,)), beta=(ln[1], (k,)))
    if residual is not None:
        expected["residual"] = (residual, (m, n))
    for name, (t, shape) in {"a": (a, (m, k)), "w": (w, (k, n)), **expected}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"gemm_tf32 takes float32 tensors, got {t.dtype} for {name}")
        if t.device != a.device:
            raise ValueError(f"gemm_tf32: {name} is on {t.device}, a on {a.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"gemm_tf32: {name} must be {shape}, got {tuple(t.shape)}")
    if a.device.type == "cpu":
        return gemm_tf32_reference(a, w, bias, ln, gelu, residual)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_tf32 runs on CPU or CUDA tensors, got {a.device}")
    if k % 32 or (n % 96 and n % 128) or (ln is not None and k > GEMM_MAX_LN_WIDTH):
        raise ValueError(f"the gemm_tf32 kernel takes K % 32 == 0, N a multiple of 96 or 128 and, "
                         f"with LN on load, K <= {GEMM_MAX_LN_WIDTH}; got K {k}, N {n}")
    operands = [a, bias] + [t for t, _ in expected.values() if t is not bias]
    if not all(t.is_contiguous() for t in operands + [w]):
        raise ValueError("gemm_tf32 needs contiguous tensors on the card")
    if any(t.data_ptr() % KERNEL_ALIGN for t in operands + [w]):
        raise ValueError(f"gemm_tf32 needs {KERNEL_ALIGN}-byte aligned tensors on the card")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0:
        return out
    # The split and the statistics are held until the launches are queued (see launch_attention).
    w_split = tf32_split(w)
    stats = torch.empty((m, 2), dtype=torch.float32, device=a.device) if ln is not None else None
    null = ctypes.c_void_p(None)
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream)
        err = lib.gemm_tf32_launch(
            *_ptrs(a, w_split, bias),
            *(_ptrs(residual) if residual is not None else [null]),
            *(_ptrs(*ln, stats) if ln is not None else [null, null, null]),
            *_ptrs(out), m, n, k, GEMM_ON_LOAD[on_load], stream,
        )
    if err != 0:
        raise RuntimeError(f"gemm_tf32 kernel launch failed with cudaError {err}")
    launches.count(key)
    return out


def attention_scratch(bw: int, c: int, device, dtype: torch.dtype = torch.float32) -> dict:
    """The device scratch of window_attention_fused's kernels, allocated per
    call in the call's dtype: a [M, C] (attn; bf16: LN1(x) first) and qkv
    [M, 3C], M = BW * 64 tokens."""
    m = bw * KERNEL_TOKENS
    kind = dict(dtype=dtype, device=device)
    return {"a": torch.empty((m, c), **kind), "qkv": torch.empty((m, 3 * c), **kind)}


def _check_scratch(scratch: dict, bw: int, c: int, device,
                   dtype: torch.dtype = torch.float32) -> None:
    """Raises unless scratch holds what attention_scratch(bw, c, device,
    dtype) allocates: contiguous, 16-byte aligned tensors of its shapes."""
    m = bw * KERNEL_TOKENS
    expected = {"a": (m, c), "qkv": (m, 3 * c)}
    if set(scratch) != set(expected):
        raise ValueError(f"window_attention_fused scratch must be {sorted(expected)}, "
                         f"got {sorted(scratch)}")
    for key, t in scratch.items():
        if t.dtype != dtype or t.device != torch.device(device):
            raise ValueError(f"scratch {key} must be {str(dtype).removeprefix('torch.')} on "
                             f"{device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != expected[key]:
            raise ValueError(f"scratch {key} must be {expected[key]}, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % KERNEL_ALIGN:
            raise ValueError(f"scratch {key} must be contiguous and {KERNEL_ALIGN}-byte aligned")


def _check(name: str, x: torch.Tensor, heads: int, num_windows: int, operands: dict) -> None:
    """Types, shapes and devices of the layout contract; raises on a mismatch."""
    if x.dim() != 3:
        raise ValueError(f"{name} takes x_windows [BW, N, C], got shape {tuple(x.shape)}")
    bw, n, c = x.shape
    if heads <= 0 or c % heads:
        raise ValueError(f"{name}: C {c} is not a multiple of heads {heads}")
    if num_windows <= 0 or bw % num_windows:
        raise ValueError(f"{name}: BW {bw} is not a multiple of num_windows {num_windows}")
    mask = operands["mask"]
    if mask.dim() != 3 or mask.shape[0] not in (1, num_windows):
        raise ValueError(
            f"{name}: mask must be [{num_windows} or 1, {n}, {n}], got {tuple(mask.shape)}"
        )
    expected = {
        "w_qkv": (c, 3 * c), "b_qkv": (3 * c,), "w_proj": (c, c), "b_proj": (c,),
        "bias": (heads, n, n), "mask": (mask.shape[0], n, n), "gamma1": (c,), "beta1": (c,),
        "gamma2": (c,), "beta2": (c,), "w_fc1": (c, 4 * c), "b_fc1": (4 * c,),
        "w_fc2": (4 * c, c), "b_fc2": (c,),
    }
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16 x_windows, got {x.dtype}")
    for key, t in {"x_windows": x, **operands}.items():
        # One dtype for every operand, but a float32 mask in a bfloat16 call.
        want = torch.float32 if key == "mask" else x.dtype
        if t.dtype != want:
            raise TypeError(f"{name} takes {want} for {key} in a call on {x.dtype} "
                            f"x_windows, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: {key} is on {t.device}, x_windows on {x.device}")
        if key in expected and tuple(t.shape) != expected[key]:
            raise ValueError(f"{name}: {key} must be {expected[key]}, got {tuple(t.shape)}")


def _check_kernel_shapes(name: str, x: torch.Tensor, heads: int, operands: dict) -> None:
    _, n, c = x.shape
    if n != KERNEL_TOKENS or c != heads * KERNEL_HEAD_DIM or heads % KERNEL_HEAD_GROUP:
        raise ValueError(
            f"the {name} kernel takes N = {KERNEL_TOKENS}, head_dim {KERNEL_HEAD_DIM} and heads "
            f"a multiple of {KERNEL_HEAD_GROUP}; got N {n}, C {c}, heads {heads}"
        )
    if name == "swin_block_fused" and c not in KERNEL_BLOCK_WIDTHS:
        raise ValueError(f"the swin_block_fused kernel takes C in {KERNEL_BLOCK_WIDTHS}, got {c}")
    if name == "window_attention_fused" and x.shape[0] > KERNEL_MAX_WINDOWS:
        raise ValueError(f"the window_attention_fused kernels take at most {KERNEL_MAX_WINDOWS} "
                         f"windows, got BW {x.shape[0]}")
    if not all(t.is_contiguous() for t in (x, *operands.values())):
        raise ValueError(f"{name} needs contiguous tensors on the card")
    if any(t.data_ptr() % KERNEL_ALIGN for t in (x, *operands.values())):
        raise ValueError(f"{name} needs {KERNEL_ALIGN}-byte aligned tensors on the card")


def _ptrs(*tensors: torch.Tensor) -> list:
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def _run(name: str, x: torch.Tensor, operands: dict, heads: int, num_windows: int,
         reference, launch) -> torch.Tensor:
    """What both wrappers do: check the layout contract, send a CPU tensor to
    the plain version, and on the card call launch(lib, out, stream), which
    queues the kernels' launches and returns a cudaError code.

    launch allocates the kernels' scratch in device memory (swin_block_fused:
    float32 the LN statistics, qkv, attn, x2 and the hidden layer, bf16 only
    attn, with x2 and the hidden layer kept on chip; window_attention_fused:
    attention_scratch; the kernels' sources say why) and, for float32, the
    weights' tf32_split forms. Freed when launch returns, it is safe: the
    caching allocator reuses a block only for work queued after the kernels
    on the same stream."""
    _check(name, x, heads, num_windows, operands)
    if x.device.type == "cpu":
        return reference(x, **operands, heads=heads, num_windows=num_windows)
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {x.device}")
    _check_kernel_shapes(name, x, heads, operands)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        err = launch(lib, out, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")
    launches.count(name if x.dtype == torch.float32 else f"{name}[bf16]")
    return out


def window_attention_fused(
    x_windows, w_qkv, b_qkv, w_proj, b_proj, bias, mask, gamma1, beta1, heads: int,
    num_windows: int,
) -> torch.Tensor:
    """x + proj(attn(LN1(x))) over partitioned windows (layout in the module
    docstring). CPU tensor: the plain version. CUDA tensor: the kernels
    (float32 or bf16, by x_windows' dtype)."""
    operands = dict(w_qkv=w_qkv, b_qkv=b_qkv, w_proj=w_proj, b_proj=b_proj, bias=bias,
                    mask=mask, gamma1=gamma1, beta1=beta1)

    def launch(lib, out, stream):
        bw, _, c = x_windows.shape
        return launch_attention(lib, x_windows, operands, heads,
                                attention_scratch(bw, c, x_windows.device, x_windows.dtype),
                                out, stream)

    return _run("window_attention_fused", x_windows, operands, heads, num_windows,
                window_attention_fused_reference, launch)


def launch_attention(lib, x, operands: dict, heads: int, scratch: dict, out, stream) -> int:
    """Queue window_attention_fused's kernels (float32 or bf16, by x's dtype)
    on stream, with the given scratch (checked: attention_scratch's shapes
    and dtype, 16-byte aligned); returns the cudaError code. The wrapper's
    launch; a card test calls it with its own scratch to read the
    intermediates back."""
    bw, _, c = x.shape
    _check_scratch(scratch, bw, c, x.device, x.dtype)
    o = operands
    if x.dtype == torch.float32:
        # The splits and the LN1 statistics ([M, 2]: mean, 1 / sqrt(var + eps)) are held until
        # the launches are queued: a split freed earlier could be handed to the next split,
        # which the stream runs before the kernels that read this one.
        w_qkv, w_proj = tf32_split(o["w_qkv"]), tf32_split(o["w_proj"])
        stats = torch.empty((bw * KERNEL_TOKENS, 2), dtype=x.dtype, device=x.device)
        return lib.window_attention_launch(
            *_ptrs(x, w_qkv, o["b_qkv"], w_proj, o["b_proj"], o["bias"], o["mask"]),
            o["mask"].shape[0],
            *_ptrs(o["gamma1"], o["beta1"], stats, scratch["a"], scratch["qkv"], out),
            bw, c, heads, stream,
        )
    return lib.window_attention_bf16_launch(
        *_ptrs(x, o["w_qkv"], o["b_qkv"], o["w_proj"], o["b_proj"], o["bias"], o["mask"]),
        o["mask"].shape[0],
        *_ptrs(o["gamma1"], o["beta1"], scratch["a"], scratch["qkv"], out),
        bw, c, heads, stream,
    )


def swin_block_fused(
    x_windows, w_qkv, b_qkv, w_proj, b_proj, bias, mask, gamma1, beta1, gamma2, beta2,
    w_fc1, b_fc1, w_fc2, b_fc2, heads: int, num_windows: int,
) -> torch.Tensor:
    """Whole pre-norm Swin block over partitioned windows:
    x2 = x + proj(attn(LN1(x))); out = x2 + fc2(GELU(fc1(LN2(x2)))).
    CPU tensor: the plain version. CUDA tensor: the kernel (float32 or bf16,
    by x_windows' dtype)."""
    operands = dict(w_qkv=w_qkv, b_qkv=b_qkv, w_proj=w_proj, b_proj=b_proj, bias=bias,
                    mask=mask, gamma1=gamma1, beta1=beta1, gamma2=gamma2, beta2=beta2,
                    w_fc1=w_fc1, b_fc1=b_fc1, w_fc2=w_fc2, b_fc2=b_fc2)

    def launch(lib, out, stream):
        bw, _, c = x_windows.shape
        if x_windows.dtype == torch.float32:
            # Scratch: the LN statistics of each token (LN1, then LN2), qkv and attn (then the
            # hidden layer) [M, 4C], and x2 [M, C].
            m = bw * KERNEL_TOKENS
            kind = dict(dtype=torch.float32, device=x_windows.device)
            stats, work, x2 = (torch.empty(shape, **kind)
                               for shape in ((m, 2), (m, 4 * c), (m, c)))
            # Every split is held until the launches are queued (see launch_attention).
            splits = [tf32_split(w) for w in (w_qkv, w_proj, w_fc1, w_fc2)]
            return lib.swin_block_launch(
                *_ptrs(x_windows, splits[0], b_qkv, splits[1], b_proj, bias, mask),
                mask.shape[0],
                *_ptrs(gamma1, beta1, gamma2, beta2, splits[2], b_fc1, splits[3], b_fc2, stats,
                       work, x2, out),
                bw, c, heads, stream,
            )
        attn = torch.empty_like(x_windows)
        return lib.swin_block_bf16_launch(
            *_ptrs(x_windows, w_qkv, b_qkv, w_proj, b_proj, bias, mask), mask.shape[0],
            *_ptrs(gamma1, beta1, gamma2, beta2, w_fc1, b_fc1, w_fc2, b_fc2, attn, out),
            bw, c, heads, stream,
        )

    return _run("swin_block_fused", x_windows, operands, heads, num_windows,
                swin_block_fused_reference, launch)
