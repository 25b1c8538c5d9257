"""Batched embedding pipeline (VGGish) on torch tensors.

Counterpart of frechet_audio_distance_exported_tpu/pipeline.py for the VGGish
family. The host decodes, mono-mixes and resamples; waveforms are packed
into a small set of length buckets and each chunk runs

    waveform batch -> log-mel kernel -> VGGish CNN -> rows (+ masks)

on the device. Per-file patch counts P_i = floor(frames_i / 96) mask the
rows of the padded bucket; the incomplete tail is dropped like the
reference's. Row order of the concatenated embedding matrix is files in
input order, patches in time order within a file.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import registry
from .ops import frontends as fe
from .ops import stats as stats_ops
from .ops.resample import resample

# Files per device program by default. CPU keeps the JAX package's non-TPU
# default. CUDA: 64 is the largest power of two under the 102-file clamp
# that patch_chunk=1024 puts on 10 s clips (10 patches each), so full
# chunks stay full; PERF.md records its peak device memory.
DEFAULT_FILE_BATCH = {"cpu": 32, "cuda": 64}


def as_int16_exact(x: np.ndarray) -> Optional[np.ndarray]:
    """int16 view of float audio that is exactly on the k/32768 grid
    (decoded PCM16 that was never resampled or mixed), else None. Shipping
    int16 halves the host-to-device bytes; the frontend dequantises on the
    device losslessly (ops.frontends.dequant_i16)."""
    q = np.round(x * 32768.0)
    if q.size and -32768.0 <= q.min() and q.max() <= 32767.0 and np.array_equal(q / 32768.0, x):
        return q.astype(np.int16)
    return None


def _pack_wave(rows, b: int, length: int) -> np.ndarray:
    """Zero-padded batch buffer [b, length]; int16 iff every row is int16
    (mixed chunks are dequantised on the host into a float32 buffer)."""
    all_i16 = all(r.dtype == np.int16 for r in rows)
    wave = np.zeros((b, length), np.int16 if all_i16 else np.float32)
    for row, r in enumerate(rows):
        if r.dtype == np.int16 and not all_i16:
            r = r.astype(np.float32) / 32768.0
        wave[row, : r.shape[0]] = r
    return wave


def bucket_len(n: int, minimum: int = 2048) -> int:
    """Round up to a 1/16-relative grid (grain 2^(floor(log2 n) - 4)):
    padding waste <= ~6% while the number of distinct shapes stays bounded
    (uniform-duration corpora use exactly one)."""
    n = max(int(n), minimum)
    grain = 1 << max(11, n.bit_length() - 5)
    return ((n + grain - 1) // grain) * grain


def bucket_batch(n: int, cap: int) -> int:
    """Pad batch sizes to powers of two, clamped to ``cap`` (below cap too:
    rounding past a non-power-of-two cap would exceed the footprint the cap
    bounds)."""
    if n >= cap:
        return cap
    return min(cap, 1 << (int(n - 1).bit_length() if n > 1 else 0))


def _vggish_core(model: torch.nn.Module, wave: torch.Tensor, num_patches: int) -> torch.Tensor:
    """[B, S] waveform -> [B, P, 128]: log-mel patches + CNN for all P rows
    of the bucket; callers keep (or mask to) each file's first P_i rows."""
    patches = fe.vggish_patches_batch(wave, num_patches)
    emb = model(patches.reshape(-1, fe.VGGISH_PATCH_FRAMES, fe.VGGISH_MEL_BINS))
    return emb.reshape(wave.shape[0], num_patches, -1)


def _fold_stats(state, emb: torch.Tensor, mask: torch.Tensor) -> stats_ops.StreamingStats:
    emb = emb.to(torch.float32)
    if state is None:
        return stats_ops.init_update_stats(emb, mask)
    return stats_ops.update_stats(state, emb, mask)


def _fused_vggish_stats_step(model, wave, p_counts: torch.Tensor, state, num_patches: int):
    """[B, S] waveform + per-file patch counts -> updated StreamingStats."""
    emb = _vggish_core(model, wave, num_patches)  # [B, P, d]
    mask = torch.arange(emb.shape[1], device=emb.device)[None, :] < p_counts[:, None]
    return _fold_stats(state, emb, mask)


class StatsSink:
    """Sink marker: fold streaming statistics into each chunk on the device
    (embeddings never leave it)."""

    def __init__(self, state=None):
        self.state = state


class EmbeddingPipeline:
    """Embeds lists of (already decoded) waveforms for one model."""

    def __init__(
        self,
        model_name: str,
        model: torch.nn.Module,
        device: torch.device,
        file_batch: Optional[int] = None,
        patch_chunk: Optional[int] = None,
        verbose: bool = False,
    ):
        self.cfg = registry.ported_model_config(model_name)
        self.model = model
        self.device = torch.device(device)
        if file_batch is None:
            file_batch = DEFAULT_FILE_BATCH[self.device.type]
        self.file_batch = file_batch
        if patch_chunk is None:
            # The patch budget must admit file_batch full 10 s files.
            patch_chunk = max(1024, self.file_batch * 10)
        self.patch_chunk = patch_chunk
        self.verbose = verbose

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def embed_files(
        self, audio_list: List[np.ndarray], sr: int, strict: bool = False, sink=None
    ) -> List[Optional[np.ndarray]]:
        """Per-file embedding matrices, in input order.

        strict=False mirrors the reference's per-file error swallowing: a
        file whose host preprocessing fails yields None instead of raising.
        Device work is never inside that ``try``.

        sink: a StatsSink; the chunks then fold into sink.state on the
        device and the return value holds per-file row counts.
        """
        with torch.inference_mode():
            return self._embed_vggish(audio_list, sr, strict, sink)

    def embed_single(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """Single-file hook; raises on error."""
        return self.embed_files([audio], sr, strict=True)[0]

    def accumulate_stats(self, audio_list: List[np.ndarray], sr: int, state=None):
        """Single-pass device (N, Σx, Σxxᵀ) over all embedding rows.

        The shift is the masked mean of the first chunk. Pass the returned
        StreamingStats back as ``state`` to continue over further chunks of
        a corpus. Returns None if every file failed and no state was given.
        """
        sink = StatsSink(state)
        self.embed_files(audio_list, sr, strict=False, sink=sink)
        return sink.state

    def _embed_vggish(self, audio_list, sr, strict, sink=None):
        prepped: List[Optional[np.ndarray]] = []
        for audio in audio_list:
            try:
                data = np.asarray(audio)
                if data.ndim > 1:
                    data = np.mean(data, axis=1)
                if sr != fe.VGGISH_SAMPLE_RATE:
                    data = resample(data, sr, fe.VGGISH_SAMPLE_RATE)
                data = data.astype(np.float32)
                q = as_int16_exact(data)
                prepped.append(data if q is None else q)
            except Exception as e:
                if strict:
                    raise
                self._log_skip(e)
                prepped.append(None)

        per_file: List[Optional[np.ndarray]] = [None] * len(audio_list)
        # Long files are split at patch boundaries so no device program sees
        # more than ~patch_chunk patches. Framing is uncentered, so a segment
        # from sample 160*96*k0 to 160*(96*k1 - 1) + 400 reproduces exactly
        # frames [96*k0, 96*k1) of the whole file. Items are
        # (file_idx, segment_order, samples).
        seg_hop = fe.VGGISH_HOP * fe.VGGISH_PATCH_FRAMES  # samples per patch
        items: List[Tuple[int, int, np.ndarray]] = []
        for i, data in enumerate(prepped):
            if data is None:
                continue
            p = fe.vggish_num_patches(len(data))
            if p == 0:
                # Shorter than one 0.96 s patch: zero rows, not an error.
                per_file[i] = (
                    0 if sink is not None
                    else np.zeros((0, self.cfg.embedding_dim), np.float32)
                )
                continue
            if p <= self.patch_chunk:
                items.append((i, 0, data))
            else:
                for seg, k0 in enumerate(range(0, p, self.patch_chunk)):
                    k1 = min(p, k0 + self.patch_chunk)
                    end = len(data) if k1 == p else (
                        fe.VGGISH_HOP * (fe.VGGISH_PATCH_FRAMES * k1 - 1) + fe.VGGISH_WINDOW
                    )
                    items.append((i, seg, data[seg_hop * k0 : end]))

        groups: Dict[int, List[int]] = {}
        for idx, (_, _, seg_data) in enumerate(items):
            groups.setdefault(bucket_len(len(seg_data)), []).append(idx)

        parts: Dict[int, Dict[int, np.ndarray]] = {}
        counts: Dict[int, int] = {}
        pending = []
        done = 0
        for s_bucket, idxs in sorted(groups.items()):
            p_max = fe.vggish_num_patches(s_bucket)
            # Cap files per program so the CNN batch (b * p_max patches)
            # stays within a bounded activation footprint.
            b_cap = min(self.file_batch, max(1, self.patch_chunk // p_max))
            for c0 in range(0, len(idxs), b_cap):
                chunk = [items[j] for j in idxs[c0 : c0 + b_cap]]
                b = bucket_batch(len(chunk), b_cap)
                wave = self._to_device(_pack_wave([seg for _, _, seg in chunk], b, s_bucket))
                p_counts = [fe.vggish_num_patches(len(seg)) for _, _, seg in chunk]
                if isinstance(sink, StatsSink):
                    p_arr = torch.zeros((b,), dtype=torch.int64)
                    p_arr[: len(p_counts)] = torch.tensor(p_counts)
                    sink.state = _fused_vggish_stats_step(
                        self.model, wave, p_arr.to(self.device), sink.state, p_max
                    )
                    for (i, _, _), count in zip(chunk, p_counts):
                        counts[i] = counts.get(i, 0) + count
                else:
                    emb_dev = _vggish_core(self.model, wave, p_max)  # [b, p_max, 128]
                    pending.append((chunk, p_counts, emb_dev))
                done += len(chunk)
                if self.verbose:
                    print(f"[FAD-TORCH] embedded {done}/{len(items)} segments")
        # Copy back after all launches, so device work overlaps host packing.
        for chunk, p_counts, emb_dev in pending:
            emb = emb_dev.cpu().numpy()
            for row, ((i, seg, _), count) in enumerate(zip(chunk, p_counts)):
                parts.setdefault(i, {})[seg] = emb[row, :count]
        for i, segs in parts.items():
            per_file[i] = np.concatenate([segs[k] for k in sorted(segs)], axis=0)
        for i, count in counts.items():
            per_file[i] = count
        return per_file

    def _log_skip(self, e: Exception) -> None:
        if self.verbose:
            print(f"[FAD-TORCH] Error processing audio: {e}")
