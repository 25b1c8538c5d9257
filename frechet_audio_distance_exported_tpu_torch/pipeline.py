"""Batched embedding pipeline (VGGish, PANN, Encodec, CLAP) on torch tensors.

Counterpart of frechet_audio_distance_exported_tpu/pipeline.py. The host
decodes, mono-mixes, resamples and applies PANN's reflect pad; waveforms are
packed into a small set of buckets and each chunk runs

    waveform batch -> log-mel kernel -> CNN -> rows (+ masks)

on the device. Planning rules, each part of the reference numerics:
- VGGish: per-file patch counts P_i = floor(frames_i / 96) mask the rows of
  the padded bucket; the incomplete tail is dropped like the reference's.
- PANN: files are grouped by their 32k-24 time grid; log-mel rows past a
  file's frame count are zeroed in the frontend. Files on different grids
  never share a program: the grid length feeds global pooling and shows in
  the embedding. One row per file.
- CLAP: every file is truncated or zero-padded towards 10 s at 48 kHz and
  quantized on the host to int16 m = trunc(x * 32767) in float32, the round
  trip CLAP was trained with, which the device reads as m/32767; without a
  resample m is reflect-padded and shipped as it is (a PCM16 sample k gives
  m = k - sign(k)). Files group by buffer length and each runs 1001
  log-mel frames. One row per file.
- Encodec: each file becomes [C, S] at the model's rate (C = 1 at 24 kHz, 2
  at 48 kHz) and is zero-padded to 10 s; files over 10 s are refused. The
  file keeps original_samples // 320 frames, where original_samples is its
  length at the model's rate taken before the resample (JAX
  pipeline.py:885-890). One row per kept frame.
The wire is int16 wherever the samples are: audio_io.Pcm16 items (score()'s
streamed path: mono 16-bit PCM files at the model's rate) ship their decoded
k as they are, CLAP's m too; other float input that is exactly on the grid
is found by as_int16_exact. Everything else ships float32. At 48 kHz an
Encodec chunk whose files are all mono Pcm16 ships [b, 1, S] and the device
repeats the channel; any other 48 kHz chunk ships [b, 2, S].
Row order of the concatenated embedding matrix is files in input order,
patches in time order within a file. Under a mesh (set_mesh) each rank
embeds its own block of the files and the results are gathered in that
order.

The model computes in config.model_dtype() (FAD_TPU_MODEL_DTYPE; float32
unless it is set): in bfloat16 the weights are cast once (cast_model), the
inputs per call and the outputs back to float32, so the statistics stay
float32 (JAX pipeline.py:367-399).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import config, registry
from .ops import frontends as fe
from .ops import stats as stats_ops
from .ops.resample import resample
from .parallel.embed import merge_stats
from .utils import profiling
from .utils.audio_io import Pcm16
from .utils.profiling import StageTimer

# What keeps float32 in a reduced-precision model, by family: Encodec's LSTM
# and output convolution, as prefixes of parameter and buffer names (mixed
# precision: a bf16 recurrence compounds its error over hundreds of steps,
# JAX pipeline.py:141-170), and CLAP's constants, which the JAX package
# keeps out of its parameter tree: the bicubic taps and the shift masks (its
# attention mask stays float32; the gathered position bias follows the
# weights).
KEEP_FLOAT32_PREFIXES = {"encodec": ("lstm.", "conv_out.")}
KEEP_FLOAT32_BUFFERS = {"clap": ("interp_w", "attn_mask")}


def cast_model(family: str, model: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Cast every floating parameter and buffer of ``model`` to ``dtype`` in
    place (BatchNorm's running statistics too, which the JAX package casts as
    pytree leaves), but those KEEP_FLOAT32_* name for ``family``. Returns
    ``model``."""
    prefixes = KEEP_FLOAT32_PREFIXES.get(family, ())
    buffers = KEEP_FLOAT32_BUFFERS.get(family, ())
    for module_name, module in model.named_modules():
        path = f"{module_name}." if module_name else ""
        for name, param in module.named_parameters(recurse=False):
            if param.is_floating_point() and not f"{path}{name}".startswith(prefixes):
                param.data = param.data.to(dtype)
        for name, buf in module.named_buffers(recurse=False):
            keep = f"{path}{name}".startswith(prefixes) or name in buffers
            if buf.is_floating_point() and not keep:
                setattr(module, name, buf.to(dtype))
    return model


def model_compute_dtype(family: str, sample_rate: int) -> torch.dtype:
    """config.model_dtype(), but float32 for encodec-48k unless
    FAD_TPU_MODEL_DTYPE is set explicitly (JAX pipeline.py:369-385: its
    mixed-bf16 FAD delta sat too close to the 1e-3 bar to flip silently)."""
    dtype = config.model_dtype()
    if (dtype != torch.float32 and family == "encodec" and sample_rate == 48000
            and not config.model_dtype_is_forced()):
        return torch.float32
    return dtype

# Files per device program by default, per device type, for every family but
# Encodec. CPU keeps the JAX package's non-TPU default. CUDA: for VGGish, 64 is the
# largest power of two under the 102-file clamp that patch_chunk=1024 puts
# on 10 s clips (10 patches each), so full chunks stay full; for PANN, 64
# was the best of a 16/32/64/128 sweep on an H100 with pann-16k and 10 s
# clips (port_measure.py). PERF.md records both sweeps and their peak memory.
DEFAULT_FILE_BATCH = {"cpu": 32, "cuda": 64}

# Encodec's files per device program. CPU: the JAX package's non-TPU default
# (pipeline.py:319-326). CUDA: 64 was the best of a 16/32/64 sweep on an
# H100 at both rates with 10 s clips (port_measure.py; throughput rose with
# the batch, since the LSTM's steps run one after another whatever B is),
# at a peak of 7.5 GiB (24 kHz) and 18.7 GiB (48 kHz stereo). A stage-1
# activation [64, 32, 480006] stays far below 2^31 elements. PERF.md records
# the sweep.
ENCODEC_FILE_BATCH = {"cpu": 16, "cuda": 64}

# Upper bound on one PANN file's log-mel frames (JAX pipeline.py:73): beyond
# it a single file's block-1 activations are too large to run alone, and the
# file is refused loudly instead of running the device out of memory. 2^18
# frames are about 44 min at 16 kHz. pann_frame_cap lowers it to what the
# card's memory holds.
PANN_MAX_FRAMES = 1 << 18

# Bytes per log-mel frame that a lone file's program holds at its widest:
# four block-1 activation tensors of [64 channels, 64 mel bins] float32
# (convolution out, BatchNorm out, ReLU out, cuDNN workspace).
_PANN_FRAME_BYTES = 4 * 64 * 64 * 4


def pann_frame_cap(device: torch.device) -> int:
    """PANN single-file frame cap: PANN_MAX_FRAMES, or fewer where half of the
    CUDA card's memory cannot hold that many frames' block-1 activations."""
    if device.type != "cuda":
        return PANN_MAX_FRAMES
    total = torch.cuda.get_device_properties(device).total_memory
    return min(PANN_MAX_FRAMES, total // 2 // _PANN_FRAME_BYTES)


def as_int16_exact(x: np.ndarray, full_scale: float = 32768.0) -> Optional[np.ndarray]:
    """int16 view of float audio that is exactly on the k/full_scale grid,
    else None: float arrays that hold PCM16 never resampled or mixed (what
    get_embeddings is handed, a PCM16 file that was mono-mixed to the same
    samples), a resampled CLAP file that lands on the grid. Shipping int16
    halves the host-to-device bytes; the frontend dequantises on the device
    losslessly (ops.frontends.dequant_i16). audio_io.Pcm16 items and CLAP's
    own int16 round trip never come here: their int16 is known."""
    q = np.round(x * full_scale)
    if q.size and -32768.0 <= q.min() and q.max() <= 32767.0 and np.array_equal(q / full_scale, x):
        return q.astype(np.int16)
    return None


def _clap_int16_wave(data: np.ndarray, pcm16: bool, length: int, half: int) -> np.ndarray:
    """CLAP's int16 round trip of a 48 kHz clip, zero-padded to ``length``
    and reflect-padded by ``half`` on each side (fe.reflect_pad_host's
    layout for a clip longer than ``half``), written once into the buffer
    that ships. The round trip CLAP was trained with is numpy's cast of the
    float32 x * 32767, which truncates toward zero: m. The device reads
    m/32767, so m itself is the wire. For a PCM16 sample k (``pcm16``:
    ``data`` holds k, standing for k/32768) m is k - sign(k), for every
    int16 k."""
    n = max(len(data), length)
    out = np.empty(n + 2 * half, np.int16)
    m = out[half : half + len(data)]
    if pcm16:
        np.sign(data, out=m)
        np.subtract(data, m, out=m)
    else:
        m[:] = (data.astype(np.float32) * 32767.0).astype(np.int16)
    out[half + len(data) : half + n] = 0
    out[:half] = out[2 * half : half : -1]
    out[half + n :] = out[half + n - 2 : n - 2 : -1]
    return out


def _pack_wave(rows, b: int, length: int, full_scale: float = 32768.0) -> np.ndarray:
    """Zero-padded batch buffer [b, *row_dims, length] (JAX pipeline.py:53-65);
    rows are padded along their last axis. int16 iff every row is int16
    (mixed chunks are dequantised on the host into a float32 buffer)."""
    with profiling.span("pack"):
        all_i16 = all(r.dtype == np.int16 for r in rows)
        wave = np.zeros((b,) + rows[0].shape[:-1] + (length,), np.int16 if all_i16 else np.float32)
        for row, r in enumerate(rows):
            if r.dtype == np.int16 and not all_i16:
                r = r.astype(np.float32) / full_scale
            wave[row, ..., : r.shape[-1]] = r
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


def _vggish_core(model, wave: torch.Tensor, num_patches: int) -> torch.Tensor:
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
    with profiling.span("step"):
        emb = _vggish_core(model, wave, num_patches)  # [B, P, d]
        mask = torch.arange(emb.shape[1], device=emb.device)[None, :] < p_counts[:, None]
        return _fold_stats(state, emb, mask)


def _mel_cnn_core(
    model,
    wave: torch.Tensor,
    n_valid: torch.Tensor,
    target_sr: int,
    num_frames: int,
    i16_full_scale: float,
) -> torch.Tensor:
    """Reflect-padded [B, L] waveform -> [B, d]: log-mel (rows >= n_valid
    zeroed) + CNN (JAX pipeline.py:219-241)."""
    mel = fe.pann_logmel_batch(wave, target_sr, num_frames, n_valid, i16_full_scale)
    return model(mel)


def _fused_mel_cnn_stats_step(
    model, wave, n_valid, n_live: int, state, target_sr, num_frames, i16_full_scale
):
    """Mel-CNN chunk + stats update; rows >= n_live are batch padding
    (JAX pipeline.py:270)."""
    with profiling.span("step"):
        emb = _mel_cnn_core(model, wave, n_valid, target_sr, num_frames, i16_full_scale)
        mask = torch.arange(emb.shape[0], device=emb.device) < n_live
        return _fold_stats(state, emb, mask)


def _fused_encodec_stats_step(model, wave, frames: torch.Tensor, state, n_frames: int = 0):
    """Encodec chunk + stats update; per-file valid frame counts mask the
    padded tail (JAX pipeline.py:277-283). The ``step`` span counts
    ``n_frames``, the frames folded in."""
    with profiling.span("step", frames=n_frames):
        emb = model(wave)  # [B, T, d]
        mask = torch.arange(emb.shape[1], device=emb.device)[None, :] < frames[:, None]
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
        self.device = torch.device(device)
        self.dtype = model_compute_dtype(self.cfg.family, self.cfg.sample_rate)
        self.model = model if self.dtype == torch.float32 else cast_model(
            self.cfg.family, model, self.dtype)
        self.forward = self._resolve_forward()
        if file_batch is None:
            defaults = ENCODEC_FILE_BATCH if self.cfg.family == "encodec" else DEFAULT_FILE_BATCH
            file_batch = defaults[self.device.type]
        self.file_batch = file_batch
        if patch_chunk is None:
            # The VGGish patch budget must admit file_batch full 10 s files;
            # other families ignore it.
            patch_chunk = max(1024, self.file_batch * 10)
        self.patch_chunk = patch_chunk
        self.verbose = verbose
        self.mesh = None
        self.timer = StageTimer()

    def _resolve_forward(self):
        """The model as the chunk steps call it: the module itself in
        float32; in a reduced dtype, the input cast to it (Encodec casts its
        own, stage by stage) and the output cast back to float32."""
        if self.dtype == torch.float32:
            return self.model
        model, dtype = self.model, self.dtype
        cast_input = self.cfg.family != "encodec"

        def forward(x: torch.Tensor) -> torch.Tensor:
            return model(x.to(dtype) if cast_input else x).to(torch.float32)

        return forward

    def set_mesh(self, mesh) -> None:
        """Shard the files of embed_files and accumulate_stats over a
        parallel.mesh.DataMesh (JAX pipeline.py:426-466): every rank passes
        the same list, embeds its own block of it on its device, and gets
        what an unsharded call returns (every file's embeddings in input
        order, or the global statistics). set_mesh(None) restores the
        unsharded behaviour.

        Files are sharded, not rows, so no batch is padded to a multiple of
        the mesh size: the JAX rule that batch buckets divide by it (JAX
        pipeline.py:450-454, 483-489) serves its row-sharded programs and has
        no counterpart here, and file_batch and patch_chunk stay as they are.
        """
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"the mesh runs on {mesh.device}, this pipeline on {self.device}")
        self.mesh = mesh

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Every host-to-device copy of the chunk steps."""
        with profiling.span("h2d", bytes=arr.nbytes):
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

        Under a mesh, every rank must call this with the same list; each
        embeds its block (embed_local) and the per-file results are
        gathered, the statistics merged (parallel.embed.merge_stats).
        """
        mesh = self.mesh
        if mesh is None:
            return self.embed_local(audio_list, sr, strict, sink)
        part = audio_list[mesh.share(len(audio_list))]
        local = None
        if sink is not None:
            # A state passed in is already global: rank 0 carries it into the merge.
            local = StatsSink(sink.state if mesh.rank == 0 else None)
        per_file = mesh.gather(lambda: self.embed_local(part, sr, strict, local))
        if sink is not None:
            sink.state = merge_stats(mesh, local.state, self.cfg.embedding_dim)
        return per_file

    def embed_local(
        self, audio_list: List[np.ndarray], sr: int, strict: bool = False, sink=None
    ) -> List[Optional[np.ndarray]]:
        """embed_files over this process's list alone, with no collective
        whatever the mesh: the sharded score path (fad.py) calls it on this
        rank's block of a directory. Timed as the embed_files[family] stage,
        reported under verbose (JAX pipeline.py:526, 541). The streamed
        score path hands it audio_io.Pcm16 items beside arrays; the ``prep``
        span counts those that shipped their int16 as it is (``pcm16``)."""
        family = self.cfg.family
        try:
            with self.timer.stage(f"embed_files[{family}]", "embed"), torch.inference_mode():
                if family == "vggish":
                    return self._embed_vggish(audio_list, sr, strict, sink)
                if family == "clap":
                    return self._embed_clap(audio_list, sr, strict, sink)
                if family == "encodec":
                    return self._embed_encodec(audio_list, sr, strict, sink)
                return self._embed_pann(audio_list, sr, strict, sink)
        finally:
            if self.verbose:
                print(self.timer.report())

    def embed_single(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """Single-file hook; raises on error."""
        return self.embed_files([audio], sr, strict=True)[0]

    def accumulate_stats(self, audio_list: List[np.ndarray], sr: int, state=None):
        """Single-pass device (N, Σx, Σxxᵀ) over all embedding rows.

        The shift is the masked mean of the first chunk. Pass the returned
        StreamingStats back as ``state`` to continue over further chunks of
        a corpus. Returns None if every file failed and no state was given.
        Under a mesh: the statistics of every rank's files, in float64, the
        same on every rank.
        """
        sink = StatsSink(state)
        self.embed_files(audio_list, sr, strict=False, sink=sink)
        return sink.state

    def _embed_vggish(self, audio_list, sr, strict, sink=None):
        prepped: List[Optional[np.ndarray]] = []
        wire = sr == fe.VGGISH_SAMPLE_RATE
        n_pcm16 = 0
        with profiling.span("prep", files=len(audio_list)) as prep:
            for audio in audio_list:
                if wire and isinstance(audio, Pcm16):
                    prepped.append(audio.samples)
                    n_pcm16 += 1
                    continue
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
            if prep is not None:
                prep.counts["pcm16"] = n_pcm16

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
                    p_arr = np.zeros((b,), np.int64)  # padding rows: no patch
                    p_arr[: len(p_counts)] = p_counts
                    sink.state = _fused_vggish_stats_step(
                        self.forward, wave, self._to_device(p_arr), sink.state, p_max
                    )
                    for (i, _, _), count in zip(chunk, p_counts):
                        counts[i] = counts.get(i, 0) + count
                else:
                    emb_dev = _vggish_core(self.forward, wave, p_max)  # [b, p_max, 128]
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

    def _embed_mel_cnn(
        self, audio_list, sr, strict, sink, prep_fn, group_key_fn, plan_fn,
        i16_full_scale: float = 32768.0,
    ):
        """Shared scaffold of the mel-frontend CNN families (JAX
        pipeline.py:694-767).

        prep_fn(data, pcm16) -> (reflect_padded_wave, n_valid_frames); data
            is a Pcm16 item's int16 samples where pcm16 (mono, at the
            model's rate, standing for k/32768), else the item as an array;
            the wave may be int16 on the k/i16_full_scale grid
        group_key_fn(item) -> static-shape group key
        plan_fn(key) -> (buffer_len, target_sample_rate, num_frames)
        """
        prepped: List[Optional[Tuple[np.ndarray, int]]] = []
        wire = sr == self.cfg.sample_rate
        n_pcm16 = 0
        with profiling.span("prep", files=len(audio_list)) as prep:
            for audio in audio_list:
                pcm16 = wire and isinstance(audio, Pcm16)
                try:
                    prepped.append(prep_fn(audio.samples if pcm16 else np.asarray(audio), pcm16))
                    n_pcm16 += pcm16
                except Exception as e:
                    if strict:
                        raise
                    self._log_skip(e)
                    prepped.append(None)
            if prep is not None:
                prep.counts["pcm16"] = n_pcm16

        groups: Dict[int, List[int]] = {}
        for i, item in enumerate(prepped):
            if item is not None:
                groups.setdefault(group_key_fn(item), []).append(i)

        per_file: List[Optional[np.ndarray]] = [None] * len(audio_list)
        pending = []
        done = 0
        for key, idxs in sorted(groups.items()):
            length, target_sr, num_frames = plan_fn(key)
            # Bound the per-program activation footprint: the CNN's widest
            # intermediate scales with b * num_frames, so long files shrink
            # the batch; file_batch x 1032 frames (10 s clips) is the budget.
            b_cap = min(self.file_batch, max(1, (self.file_batch * 1032) // num_frames))
            for c0 in range(0, len(idxs), b_cap):
                chunk_idx = idxs[c0 : c0 + b_cap]
                b = bucket_batch(len(chunk_idx), b_cap)
                wave = self._to_device(
                    _pack_wave([prepped[i][0] for i in chunk_idx], b, length, i16_full_scale)
                )
                n_valid = np.zeros((b,), dtype=np.int32)  # padding rows: all masked
                for row, i in enumerate(chunk_idx):
                    n_valid[row] = prepped[i][1]
                n_valid = self._to_device(n_valid)
                if isinstance(sink, StatsSink):
                    sink.state = _fused_mel_cnn_stats_step(
                        self.forward, wave, n_valid, len(chunk_idx), sink.state,
                        target_sr, num_frames, i16_full_scale,
                    )
                    for i in chunk_idx:
                        per_file[i] = 1
                else:
                    emb_dev = _mel_cnn_core(
                        self.forward, wave, n_valid, target_sr, num_frames, i16_full_scale
                    )
                    pending.append((chunk_idx, emb_dev))
                done += len(chunk_idx)
                if self.verbose:
                    print(f"[FAD-TORCH] embedded {done}/{len(audio_list)} files")
        # Copy back after all launches, so device work overlaps host packing.
        for chunk_idx, emb_dev in pending:
            emb = emb_dev.cpu().numpy()
            for row, i in enumerate(chunk_idx):
                per_file[i] = emb[row : row + 1]
        return per_file

    def _embed_pann(self, audio_list, sr, strict, sink=None):
        """JAX pipeline.py:769-806: one row per file."""
        target_sr = self.cfg.sample_rate
        cfg = fe.PANN_CONFIGS[target_sr]
        n_fft, hop = cfg["window_size"], cfg["hop_size"]
        frame_cap = pann_frame_cap(self.device)

        def prep(data, pcm16):
            if not pcm16:
                if data.ndim > 1:
                    data = np.mean(data, axis=1)
                if sr != target_sr:
                    data = resample(data, sr, target_sr)
                data = data.astype(np.float32)
            t_i = fe.pann_num_frames(len(data), hop)
            if fe.pann_valid_time(t_i) < 40:
                # The CNN needs time/32 >= 1 after five floor-halving pools;
                # the torch reference errors out on such inputs too.
                raise ValueError(
                    f"Audio too short for PANN (grid {fe.pann_valid_time(t_i)} < 40 frames)"
                )
            if t_i > frame_cap:
                raise ValueError(
                    f"Audio too long for PANN ({t_i} log-mel frames > {frame_cap}): a "
                    f"single file's activations would exceed device memory. Split the "
                    f"file (PANN embeds one row per file, so scoring chunks separately "
                    f"changes the statistics rows)."
                )
            # Pad first, then check the int16 grid: the wire carries the
            # padded wave (reflection keeps PCM16 samples on the grid).
            padded = fe.reflect_pad_host(data, n_fft)
            if pcm16:
                return padded, t_i
            q = as_int16_exact(padded)
            return (padded if q is None else q), t_i

        return self._embed_mel_cnn(
            audio_list, sr, strict, sink,
            prep_fn=prep,
            # The 32k-24 grid shows in the embedding: never mix grids.
            group_key_fn=lambda item: fe.pann_valid_time(item[1]),
            plan_fn=lambda t_grid: (t_grid * hop + n_fft, target_sr, t_grid),
        )

    def _clap_prep(self, data: np.ndarray, sr: int, pcm16: bool = False):
        """One file's host steps (JAX pipeline.py:815-862), in the JAX
        package's order; each one shows in the embedding. ``data`` is float
        audio, or with ``pcm16`` a Pcm16 item's int16 samples k (mono, at
        48 kHz, standing for k/32768). Returns the reflect-padded wave
        (int16 on the k/32767 grid, unless a resample took it off the grid)
        and its frame count."""
        n_fft = fe.PANN_CONFIGS[fe.CLAP_SAMPLE_RATE]["window_size"]
        hop = fe.PANN_CONFIGS[fe.CLAP_SAMPLE_RATE]["hop_size"]
        if data.ndim > 1:
            data = np.mean(data, axis=1)
        # Frames 0..1000 of the centered STFT read only samples below
        # (1001 + 2) * hop, so a longer file is truncated there; when
        # resampling, 4096 source samples of margin keep the resampler's
        # finite support inside the kept prefix.
        need = (fe.CLAP_TIME_FRAMES + 2) * hop
        if sr != fe.CLAP_SAMPLE_RATE:
            need = int(np.ceil(need * sr / fe.CLAP_SAMPLE_RATE)) + 4096
        if len(data) > need:
            data = data[:need]
        # The waveform is zero-padded to 10 s before the mel, capped at the
        # read window.
        pad_target = min(fe.CLAP_MAX_SAMPLES, need)
        if sr == fe.CLAP_SAMPLE_RATE:
            wave = _clap_int16_wave(data, pcm16, pad_target, n_fft // 2)
            n_valid = min(fe.CLAP_TIME_FRAMES, fe.pann_num_frames(len(wave) - n_fft, hop))
            return wave, n_valid
        if len(data) < pad_target:
            data = np.pad(data, (0, pad_target - len(data)))
        # The int16 round trip, then the resample, which leaves the grid.
        m = (data.astype(np.float32) * 32767.0).astype(np.int16)
        data = resample(m.astype(np.float32) / 32767.0, sr, fe.CLAP_SAMPLE_RATE)
        data = data.astype(np.float32)
        n_valid = min(fe.CLAP_TIME_FRAMES, fe.pann_num_frames(len(data), hop))
        padded = fe.reflect_pad_host(data, n_fft)
        q = as_int16_exact(padded, 32767.0)
        return (padded if q is None else q), n_valid

    def _embed_clap(self, audio_list, sr, strict, sink=None):
        """JAX pipeline.py:812-870: one row per file, grouped by buffer length."""
        return self._embed_mel_cnn(
            audio_list, sr, strict, sink,
            prep_fn=lambda data, pcm16: self._clap_prep(data, sr, pcm16),
            group_key_fn=lambda item: bucket_len(len(item[0])),
            plan_fn=lambda s_bucket: (s_bucket, fe.CLAP_SAMPLE_RATE, fe.CLAP_TIME_FRAMES),
            i16_full_scale=32767.0,
        )

    def _encodec_prep(self, audio: np.ndarray, sr: int, pcm16: bool = False):
        """One file's host steps (JAX pipeline.py:882-899): [C, S] at the
        model's rate (int16 where it is exact) and its valid frame count.
        With ``pcm16``, ``audio`` is a Pcm16 item's int16 samples k (mono, at
        the model's rate), returned as they are, [1, S]: a 48 kHz chunk
        duplicates the channel where it packs them (_embed_encodec)."""
        target_sr = self.cfg.sample_rate
        config = fe.ENCODEC_CONFIGS[target_sr]
        if pcm16:
            pre = audio[None, :]
            original_samples = len(audio)
        else:
            audio = np.asarray(audio)
            # The length at the model's rate, taken before the resample.
            original_samples = int(len(audio) * target_sr / sr) if sr != target_sr else len(audio)
            pre = fe.preprocess_for_encodec(
                audio, sr, target_sample_rate=target_sr,
                target_channels=config["channels"], return_tensor=False,
            )  # [C, S]
        if pre.shape[-1] > config["max_samples"]:
            raise ValueError(
                f"Audio too long: {pre.shape[-1]} samples > {config['max_samples']} max samples"
            )
        if not pcm16:
            q = as_int16_exact(pre)
            pre = pre if q is None else q
        return pre, original_samples // config["hop_length"]

    def _embed_encodec(self, audio_list, sr, strict, sink=None):
        """JAX pipeline.py:876-933: every chunk padded to 10 s, frames past a
        file's count masked (device stats) or trimmed (host). A chunk of
        mono int16 rows alone ships [b, 1, S] and the device makes the
        model's channels; in any other chunk a mono row is duplicated on the
        host. The ``prep`` span counts the Pcm16 items (``pcm16``) and the
        files whose second channel the device makes (``dup``)."""
        config = fe.ENCODEC_CONFIGS[self.cfg.sample_rate]
        channels, max_samples = config["channels"], config["max_samples"]
        prepped: List[Optional[Tuple[np.ndarray, int]]] = []
        wire = sr == self.cfg.sample_rate
        n_pcm16 = 0
        with profiling.span("prep", files=len(audio_list)) as prep:
            for audio in audio_list:
                pcm16 = wire and isinstance(audio, Pcm16)
                try:
                    prepped.append(self._encodec_prep(audio.samples if pcm16 else audio, sr, pcm16))
                    n_pcm16 += pcm16
                except Exception as e:
                    if strict:
                        raise
                    self._log_skip(e)
                    prepped.append(None)
            idxs = [i for i, p in enumerate(prepped) if p is not None]
            chunks = [idxs[c0 : c0 + self.file_batch] for c0 in range(0, len(idxs), self.file_batch)]
            # Chunks whose every row is a Pcm16 item's [1, S]: the device
            # repeats the channel.
            mono = [channels > 1 and all(prepped[i][0].shape[0] == 1 for i in chunk)
                    for chunk in chunks]
            if prep is not None:
                prep.counts["pcm16"] = n_pcm16
                prep.counts["dup"] = sum(len(c) for c, m in zip(chunks, mono) if m)

        per_file: List[Optional[np.ndarray]] = [None] * len(audio_list)
        pending = []
        done = 0
        for chunk_idx, dup in zip(chunks, mono):
            b = bucket_batch(len(chunk_idx), self.file_batch)
            rows = [prepped[i][0] for i in chunk_idx]
            if not dup:
                rows = [np.broadcast_to(r, (channels, r.shape[-1])) for r in rows]
            wave = self._to_device(_pack_wave(rows, b, max_samples))
            if dup:  # preprocess_for_encodec's duplicate of a mono file, made on the device
                wave = wave.expand(-1, channels, -1).contiguous()
            frames = np.zeros((b,), np.int64)  # padding rows: all masked
            for row, i in enumerate(chunk_idx):
                frames[row] = prepped[i][1]
                per_file[i] = prepped[i][1]
            if isinstance(sink, StatsSink):
                sink.state = _fused_encodec_stats_step(
                    self.forward, wave, self._to_device(frames), sink.state, int(frames.sum())
                )
            else:
                pending.append((chunk_idx, self.forward(wave)))  # [b, T, 128]
            done += len(chunk_idx)
            if self.verbose:
                print(f"[FAD-TORCH] embedded {done}/{len(idxs)} files")
        # Copy back after all launches, so device work overlaps host packing.
        for chunk_idx, emb_dev in pending:
            emb = emb_dev.cpu().numpy()
            for row, i in enumerate(chunk_idx):
                per_file[i] = emb[row, : prepped[i][1]]
        return per_file

    def _log_skip(self, e: Exception) -> None:
        if self.verbose:
            print(f"[FAD-TORCH] Error processing audio: {e}")
