"""Sharded statistics and the sharded scoring step over a DataMesh.

The counterpart of frechet_audio_distance_exported_tpu/parallel/embed.py.
There, one jitted shard_map program runs the model on each chip's rows and
psums the statistics. Here each rank runs the model on its own rows and
all-reduces the statistics over the process group; ``model_fn`` takes a
tensor and closes over its nn.Module (there is no params argument).

``merge_stats`` has no JAX counterpart: it merges streamed accumulators that
each rank took about its own shift (ops/stats.init_update_stats).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops import stats as stats_ops
from .mesh import DataMesh


def _row_mask(mask: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """[R] bool over the rows of emb.reshape(-1, d): mask covers emb's leading
    dims (one flag per input row masks every output row it makes)."""
    lead = emb.shape[:-1]
    keep = (mask > 0).reshape(mask.shape + (1,) * (len(lead) - mask.dim()))
    return keep.expand(lead).reshape(-1)


def make_sharded_embed_stats(
    mesh: DataMesh, model_fn: Callable[[torch.Tensor], torch.Tensor]
) -> Callable[[torch.Tensor, torch.Tensor], stats_ops.StreamingStats]:
    """Build fn(rows, mask) -> StreamingStats (JAX embed.py:52-101).

    ``rows`` [B, ...] are this rank's model inputs on its device, ``mask``
    [B] (or over more of the output's leading dims) drops padded rows. The
    result is the statistics of every rank's rows, the same on every rank.

    Numerics (JAX embed.py:81-93): the count and the sum are all-reduced
    first, the second moment is taken about that exact global mean and
    all-reduced, and s = s_raw - n·μ: a two-pass covariance in one step,
    with no float32 cancellation.
    """

    def fn(rows: torch.Tensor, mask: torch.Tensor) -> stats_ops.StreamingStats:
        with torch.inference_mode():
            emb = mesh.agree(lambda: model_fn(rows).to(torch.float32))
            keep = _row_mask(mask, emb)[:, None]
            emb = emb.reshape(-1, emb.shape[-1])
            zero = torch.zeros((), dtype=emb.dtype, device=emb.device)
            emb = torch.where(keep, emb, zero)  # where: a NaN in a padded row drops out
            head = mesh.all_reduce(torch.cat([keep.sum().to(emb.dtype)[None], emb.sum(dim=0)]))
            n, s_raw = head[0], head[1:]
            mu = s_raw / n.clamp_min(1.0)
            emb_c = torch.where(keep, emb - mu, zero)
            ss = mesh.all_reduce(emb_c.T @ emb_c)
            return stats_ops.StreamingStats(n=n, s=s_raw - n * mu, ss=ss, shift=mu)

    return fn


def make_sharded_score_step(
    mesh: DataMesh, model_fn: Callable[[torch.Tensor], torch.Tensor]
) -> Callable[..., torch.Tensor]:
    """Build step(rows_bg, mask_bg, rows_ev, mask_ev) -> FAD, a 0-d tensor on
    the device (JAX embed.py:104-123): both row sets through
    make_sharded_embed_stats, then finalize_stats and the eigh route of
    frechet_distance_torch on every rank's device."""
    embed_stats = make_sharded_embed_stats(mesh, model_fn)

    def step(rows_bg, mask_bg, rows_ev, mask_ev) -> torch.Tensor:
        mu1, sig1 = stats_ops.finalize_stats(embed_stats(rows_bg, mask_bg))
        mu2, sig2 = stats_ops.finalize_stats(embed_stats(rows_ev, mask_ev))
        return stats_ops.frechet_distance_torch(mu1, sig1, mu2, sig2)

    return step


def merge_stats(
    mesh: DataMesh, state: Optional[stats_ops.StreamingStats], dim: int
) -> Optional[stats_ops.StreamingStats]:
    """Every rank's streamed accumulator merged into the global one, in
    float64 on each rank's device, the same on every rank; None where no
    rank had a row. ``state`` is None on a rank that had no row; it still
    joins both all-reduces, with a zero state of width ``dim``.

    Each rank took its sums about its own shift, so a plain all-reduce of
    (s, ss) would add sums taken about different points. First n and
    n·shift + s are all-reduced, which gives the global mean μ; each rank
    re-centres its own sums at μ (ops/stats.recenter_stats); then those are
    all-reduced.
    """
    if state is None:
        state = stats_ops.init_stats(dim, torch.float64, device=mesh.device)
    n = state.n.double()
    head = mesh.all_reduce(torch.cat([n[None], n * state.shift.double() + state.s.double()]))
    n_all = head[0]
    if not bool(n_all > 0):  # the same on every rank
        return None
    mu = head[1:] / n_all
    local = stats_ops.recenter_stats(state, mu)
    sums = mesh.all_reduce(torch.cat([local.s[None], local.ss]))
    return stats_ops.StreamingStats(n=n_all, s=sums[0], ss=sums[1:], shift=mu)
