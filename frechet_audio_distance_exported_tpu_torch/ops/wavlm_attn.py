"""WavLM's gated relative-position attention: the CUDA kernel's wrapper and
its plain version.

Per clip b and head h of 64 columns, over a layer's qkvg rows [B * T, 3C +
8H] (q, k and v with their biases at columns 64 h, C + 64 h and 2C + 64 h,
the gate's 8 logits at 3C + 8 h; C = 64 H):

  out[b, t, 64 h : 64 h + 64] = softmax_s(q_t . k_s / 8 + gate[b, t, h] * rel[h, s - t]) v

with rel [H, 2T - 1] the relative-position bias (rel[h, r + T - 1] the bias
of s - t = r; models/wavlm.py gathers it from layer 0's table once a
forward) and gate = a * (b' * c_h - 1) + 2, where a and b' are the sigmoids
of the sums of logits 0-3 and 4-7 and c_h is gate_const[h] (the layer's
gru_rel_pos_const). The output [B * T, C] has head h at columns 64 h, as
the proj product reads it.

wavlm_attention runs csrc/wavlm_attn.cu's wavlm_attention_kernel, one
launch, whose header says what bounds it and how it is laid out; it takes
float32 CUDA tensors only and raises on anything else (the model keeps
ATen's attention on the CPU and in a bf16 model). Each launch counts one
``wavlm_attention`` (ops/launches.py). wavlm_attention_reference is its
plain version, in the dtype it is given.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, launches

HEAD_DIM = 64
GATE_DIM = 8  # the gate's logits a head
ALIGN = 16  # bytes: the kernel reads the rows in 16-byte pieces


def relative_index(t: int, device=None) -> torch.Tensor:
    """[T, T]: s - t + T - 1, the column of rel that (t, s) reads."""
    pos = torch.arange(t, device=device)
    return pos[None, :] - pos[:, None] + (t - 1)


def expand_relative(rel: torch.Tensor, t: int) -> torch.Tensor:
    """[H, 2T - 1] -> [H, T, T]: rel[h, s - t + T - 1] at (h, t, s)."""
    return rel[:, relative_index(t, rel.device)]


def wavlm_attention_reference(qkvg, rel, gate_const, b: int, t: int) -> torch.Tensor:
    """Plain torch version of wavlm_attention, in qkvg's dtype: the gated
    bias materialised [B, H, T, T] beside the scores."""
    heads = gate_const.shape[0]
    c = HEAD_DIM * heads
    q, k, v = (qkvg[:, i * c:(i + 1) * c].reshape(b, t, heads, HEAD_DIM).transpose(1, 2)
               for i in range(3))
    half = GATE_DIM // 2
    ga, gb = torch.sigmoid(qkvg[:, 3 * c:].reshape(b, t, heads, 2, half).sum(-1)).unbind(-1)
    gate = ga * (gb * gate_const - 1.0) + 2.0  # [B, T, H]
    scores = (torch.matmul(q, k.transpose(-1, -2)) * HEAD_DIM ** -0.5
              + gate.transpose(1, 2)[..., None] * expand_relative(rel, t))
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v).transpose(1, 2).reshape(b * t, c)


def wavlm_attention(qkvg, rel, gate_const, b: int, t: int) -> torch.Tensor:
    """The attention of the module docstring on the card: qkvg [B * T, 3C +
    8H], rel [H, 2T - 1], gate_const [H], float32 CUDA tensors, contiguous,
    16-byte aligned -> [B * T, C], C = 64 H. One wavlm_attention_kernel
    launch, counted as ``wavlm_attention``; raises on a CPU tensor, on
    another dtype and on shapes the kernel does not take."""
    if b <= 0 or t <= 0:
        raise ValueError(f"wavlm_attention takes B >= 1 and T >= 1, got B {b}, T {t}")
    if gate_const.dim() != 1 or gate_const.shape[0] == 0:
        raise ValueError(f"wavlm_attention takes gate_const [H], got {tuple(gate_const.shape)}")
    heads = gate_const.shape[0]
    c = HEAD_DIM * heads
    expected = {"qkvg": (qkvg, (b * t, 3 * c + GATE_DIM * heads)),
                "rel": (rel, (heads, 2 * t - 1)), "gate_const": (gate_const, (heads,))}
    for name, (x, shape) in expected.items():
        if x.dtype != torch.float32:
            raise TypeError(f"wavlm_attention takes float32 tensors, got {x.dtype} for {name}")
    for name, (x, shape) in expected.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"wavlm_attention: {name} must be {shape} (head dim {HEAD_DIM}, "
                             f"{GATE_DIM} gate logits a head), got {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % ALIGN:
            raise ValueError(f"wavlm_attention needs contiguous, {ALIGN}-byte aligned tensors; "
                             f"{name} is not")
    for name, (x, shape) in expected.items():
        if x.device.type != "cuda":
            raise ValueError(f"wavlm_attention runs on the card, got {name} on {x.device}")
        if x.device != qkvg.device:
            raise ValueError(f"wavlm_attention: {name} is on {x.device}, qkvg on {qkvg.device}")
    out = torch.empty((b * t, c), dtype=torch.float32, device=qkvg.device)
    lib = _build.load_library()
    with torch.cuda.device(qkvg.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(qkvg.device).cuda_stream)
        err = lib.wavlm_attention_launch(
            *(ctypes.c_void_p(x.data_ptr()) for x in (qkvg, rel, gate_const, out)),
            b, t, heads, stream)
    if err != 0:
        raise RuntimeError(f"wavlm_attention kernel launch failed with cudaError {err}")
    launches.count("wavlm_attention")
    return out
