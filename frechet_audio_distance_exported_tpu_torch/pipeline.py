"""Batched embedding pipeline (VGGish, PANN, Encodec, CLAP, WavLM) on torch tensors.

Counterpart of frechet_audio_distance_exported_tpu/pipeline.py. The host
decodes, mono-mixes, resamples and applies PANN's reflect pad; waveforms are
packed into a small set of buckets and each chunk runs

    waveform batch -> log-mel kernel -> CNN -> rows (+ masks)

on the device. One loop (EmbeddingPipeline.embed_local) does this for every
model; what differs by family is one entry of FAMILIES, whose planning
rules are each part of the reference numerics.
The wire is int16 wherever the samples are: audio_io.Pcm16 items (score()'s
streamed path: mono 16-bit PCM files at the model's rate) ship their decoded
k as they are, CLAP's m too; other float input that is exactly on the grid
is found by as_int16_exact (Family.prepare decides it for every family).
Everything else ships float32. WavLM takes the wave itself and normalises
each clip on the device. At 48 kHz an Encodec chunk whose files are
all mono Pcm16 ships [b, 1, S] and the device repeats the channel; any
other 48 kHz chunk ships [b, 2, S].
Row order of the concatenated embedding matrix is files in input order,
rows in time order within a file. Under a mesh (set_mesh) each rank
embeds its own block of the files and the results are gathered in that
order.

The model computes in config.model_dtype() (FAD_TPU_MODEL_DTYPE; float32
unless it is set): in bfloat16 the weights are cast once (cast_model), the
inputs per call and the outputs back to float32, so the statistics stay
float32 (JAX pipeline.py:367-399).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import config, registry
from .models.clap import CLAP
from .models.encodec import encodec_for_rate
from .models.pann import PANN
from .models.vggish import VGGish
from .models.wavlm import WavLM, num_frames as wavlm_frames
from .ops import frontends as fe
from .ops import stats as stats_ops
from .ops.resample import resample
from .parallel.embed import merge_stats
from .utils import profiling
from .utils.audio_io import Pcm16
from .utils.profiling import StageTimer

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


def _fold_stats(state, emb: torch.Tensor, mask: torch.Tensor) -> stats_ops.StreamingStats:
    emb = emb.to(torch.float32)
    if state is None:
        return stats_ops.init_update_stats(emb, mask)
    return stats_ops.update_stats(state, emb, mask)


class Item(NamedTuple):
    """One prepared row of a file. ``seg`` orders a VGGish file's segments.
    ``valid`` ships beside the wave: out of prep, VGGish's samples (then a
    segment's patches), PANN's and CLAP's log-mel frames, Encodec's kept
    frames. An item gives min(valid, R) rows of its chunk's [b, R, d]
    embeddings: its patches or frames, or a mel file's one row (a live mel
    file has at least one frame, a padding row none)."""

    file: int
    seg: int
    row: np.ndarray
    valid: int


class Family:
    """One model family's part of the embedding loop: the class attributes
    are its facts, an instance holds the model's rate and device. A family
    builds its model (build, then on_device after the move), prepares one
    file (prep), plans the chunks (group, or chunks itself) and embeds one
    chunk (from_wire, then embed: [b, *row_dims, length] wave -> [b, R, d])."""

    # Files per device program by default, per device type: the JAX
    # package's non-TPU default on the CPU; on CUDA, for VGGish the largest
    # power of two under the 102-file clamp that patch_chunk=1024 puts on
    # 10 s clips, for PANN and CLAP as good as any in an H100 sweep
    # (PERF.md §6, the `file_batch` sweeps).
    file_batch = {"cpu": 32, "cuda": 64}
    # What cast_model keeps float32: name prefixes, and buffer names.
    keep_float32: Tuple[str, ...] = ()
    keep_float32_buffers: Tuple[str, ...] = ()
    # Model rates that compute in float32 unless FAD_TPU_MODEL_DTYPE is set.
    float32_rates: Tuple[int, ...] = ()
    cast_input = True  # a reduced-dtype forward casts its input
    full_scale = 32768.0  # the int16 wire stands for k / full_scale
    valid_dtype = np.int64
    forward_reads_valid = False  # embed reads ``valid``, masks or not
    # The verbose line counts ``unit`` out of every file handed in (failed
    # ones too) where total_of_inputs, else out of the items.
    unit = "files"
    total_of_inputs = False

    def __init__(self, rate: int, device: torch.device):
        self.rate = rate
        self.device = device

    @staticmethod
    def on_device(model: torch.nn.Module) -> None:
        pass

    def from_wire(self, wave: torch.Tensor) -> torch.Tensor:
        """The chunk as embed takes it, made from the buffer that crossed the
        wire; the loop keeps only what this returns."""
        return wave

    def prepare(self, data: np.ndarray, sr: int, pcm16: bool) -> Tuple[np.ndarray, int]:
        """prep (``data``: the file as an array, or with ``pcm16`` a Pcm16
        item's int16 samples), then the wire: a float row exactly on the
        k/full_scale grid ships as its int16 k."""
        row, valid = self.prep(data, sr, pcm16)
        if row.dtype != np.int16:
            q = as_int16_exact(row, self.full_scale)
            row = row if q is None else q
        return row, valid

    def group(self, item: Item, file_batch: int, patch_chunk: int) -> Tuple[int, int]:
        """(buffer length, files per program) of the item's group."""
        return bucket_len(len(item.row)), file_batch

    def chunks(self, items: List[Item], file_batch: int, patch_chunk: int) -> list:
        """(items, b, length) per program: groups in order of length, files
        in index order within one."""
        groups: Dict[Tuple[int, int], List[Item]] = {}
        for item in items:
            groups.setdefault(self.group(item, file_batch, patch_chunk), []).append(item)
        out = []
        for (length, cap), members in sorted(groups.items()):
            for c0 in range(0, len(members), cap):
                chunk = members[c0 : c0 + cap]
                out.append((chunk, bucket_batch(len(chunk), cap), length))
        return out

    def prep_counts(self, chunks: list) -> dict:
        return {}

    def step_counts(self, valid: np.ndarray) -> dict:
        return {}


class VGGishFamily(Family):
    """One row per 0.96 s patch; patches past a file's P_i = floor(frames_i
    / 96) are masked, the incomplete tail dropped like the reference's."""

    unit = "segments"

    build = staticmethod(lambda rate: VGGish())

    def prep(self, data, sr, pcm16):
        if not pcm16:
            if data.ndim > 1:
                data = np.mean(data, axis=1)
            if sr != fe.VGGISH_SAMPLE_RATE:
                data = resample(data, sr, fe.VGGISH_SAMPLE_RATE)
            data = data.astype(np.float32)
        return data, len(data)

    def chunks(self, items, file_batch, patch_chunk):
        # Long files are split at patch boundaries so no device program sees
        # more than ~patch_chunk patches. Framing is uncentered, so a
        # segment from sample 160*96*k0 to 160*(96*k1 - 1) + 400 reproduces
        # exactly frames [96*k0, 96*k1) of the whole file. A file shorter
        # than one patch gives none.
        hop = fe.VGGISH_HOP * fe.VGGISH_PATCH_FRAMES  # samples per patch
        segments = []
        for item in items:
            p = fe.vggish_num_patches(item.valid)
            for seg, k0 in enumerate(range(0, p, patch_chunk)):
                k1 = min(p, k0 + patch_chunk)
                end = len(item.row) if k1 == p else (
                    fe.VGGISH_HOP * (fe.VGGISH_PATCH_FRAMES * k1 - 1) + fe.VGGISH_WINDOW
                )
                segments.append(Item(item.file, seg, item.row[hop * k0 : end], k1 - k0))
        return super().chunks(segments, file_batch, patch_chunk)

    def group(self, item, file_batch, patch_chunk):
        # Cap files per program so the CNN batch (b * p_max patches) stays
        # within a bounded activation footprint.
        s = bucket_len(len(item.row))
        return s, min(file_batch, max(1, patch_chunk // fe.vggish_num_patches(s)))

    def embed(self, forward, wave, valid):
        p = fe.vggish_num_patches(wave.shape[-1])
        patches = fe.vggish_patches_batch(wave, p)
        emb = forward(patches.reshape(-1, fe.VGGISH_PATCH_FRAMES, fe.VGGISH_MEL_BINS))
        return emb.reshape(wave.shape[0], p, -1)


class MelFamily(Family):
    """The mel-frontend CNNs (JAX pipeline.py:694-767): a reflect-padded
    wave whose log-mel rows past its frame count are zeroed in the frontend;
    one row per file."""

    valid_dtype = np.int32
    forward_reads_valid = True
    total_of_inputs = True

    def embed(self, forward, wave, valid):
        mel = fe.pann_logmel_batch(
            wave, self.rate, self.num_frames(wave.shape[-1]), valid, self.full_scale
        )
        return forward(mel)[:, None]


class PannFamily(MelFamily):
    """JAX pipeline.py:769-806: files grouped by their 32k-24 time grid,
    which feeds global pooling and shows in the embedding, so grids never
    share a program."""

    build = staticmethod(lambda rate: PANN())

    def prep(self, data, sr, pcm16):
        cfg = fe.PANN_CONFIGS[self.rate]
        if not pcm16:
            if data.ndim > 1:
                data = np.mean(data, axis=1)
            if sr != self.rate:
                data = resample(data, sr, self.rate)
            data = data.astype(np.float32)
        t_i = fe.pann_num_frames(len(data), cfg["hop_size"])
        if fe.pann_valid_time(t_i) < 40:
            # The CNN needs time/32 >= 1 after five floor-halving pools;
            # the torch reference errors out on such inputs too.
            raise ValueError(
                f"Audio too short for PANN (grid {fe.pann_valid_time(t_i)} < 40 frames)"
            )
        frame_cap = pann_frame_cap(self.device)
        if t_i > frame_cap:
            raise ValueError(
                f"Audio too long for PANN ({t_i} log-mel frames > {frame_cap}): a "
                f"single file's activations would exceed device memory. Split the "
                f"file (PANN embeds one row per file, so scoring chunks separately "
                f"changes the statistics rows)."
            )
        # Reflection keeps PCM16 samples on the int16 grid.
        return fe.reflect_pad_host(data, cfg["window_size"]), t_i

    def group(self, item, file_batch, patch_chunk):
        # The CNN's widest intermediate scales with b * num_frames, so long
        # files shrink the batch; file_batch x 1032 frames (10 s clips) is
        # the budget.
        cfg = fe.PANN_CONFIGS[self.rate]
        t_grid = fe.pann_valid_time(item.valid)
        return (t_grid * cfg["hop_size"] + cfg["window_size"],
                min(file_batch, max(1, (file_batch * 1032) // t_grid)))

    def num_frames(self, length):
        cfg = fe.PANN_CONFIGS[self.rate]
        return (length - cfg["window_size"]) // cfg["hop_size"]


class ClapFamily(MelFamily):
    """JAX pipeline.py:812-870: every file truncated or zero-padded towards
    10 s at 48 kHz and quantized on the host to int16 m = trunc(x * 32767),
    the round trip CLAP was trained with, which the device reads as m/32767;
    grouped by buffer length, 1001 log-mel frames a file."""

    # Constants the JAX package keeps out of its parameter tree: the bicubic
    # taps and the shift masks (the gathered position bias follows the
    # weights).
    keep_float32_buffers = ("interp_w", "attn_mask")
    full_scale = 32767.0

    build = staticmethod(lambda rate: CLAP())

    def prep(self, data, sr, pcm16):
        """JAX pipeline.py:815-862, in the JAX package's order; each step
        shows in the embedding. Returns the reflect-padded wave (int16 on
        the k/32767 grid, float32 after a resample) and its frame count."""
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
            return wave, min(fe.CLAP_TIME_FRAMES, fe.pann_num_frames(len(wave) - n_fft, hop))
        if len(data) < pad_target:
            data = np.pad(data, (0, pad_target - len(data)))
        # The int16 round trip, then the resample, which leaves the grid.
        m = (data.astype(np.float32) * 32767.0).astype(np.int16)
        data = resample(m.astype(np.float32) / 32767.0, sr, fe.CLAP_SAMPLE_RATE)
        data = data.astype(np.float32)
        n_valid = min(fe.CLAP_TIME_FRAMES, fe.pann_num_frames(len(data), hop))
        return fe.reflect_pad_host(data, n_fft), n_valid

    def num_frames(self, length):
        return fe.CLAP_TIME_FRAMES


class EncodecFamily(Family):
    """JAX pipeline.py:876-933: chunks of file_batch in index order, each
    padded to 10 s. A chunk of mono int16 rows alone ships [b, 1, S] and the
    device makes the model's channels; in any other chunk a mono row is
    duplicated on the host. The ``prep`` span counts the files whose second
    channel the device makes (``dup``), the ``step`` span the frames folded
    in (``frames``)."""

    # CUDA: the best of a 16/32/64 sweep on an H100 at both rates with 10 s
    # clips (the LSTM's steps run one after another whatever B is), at a
    # peak of 7.5 GiB (24 kHz) and 18.7 GiB (48 kHz stereo; PERF.md §6, the
    # `file_batch` sweeps); a stage-1 activation [64, 32, 480006] stays far
    # below 2^31 elements. CPU: JAX pipeline.py:319-326.
    file_batch = {"cpu": 16, "cuda": 64}
    # A bf16 recurrence compounds its error over hundreds of steps (JAX
    # pipeline.py:141-170).
    keep_float32 = ("lstm.", "conv_out.")
    # encodec-48k's mixed-bf16 FAD delta sat too close to the 1e-3 bar to
    # flip silently (JAX pipeline.py:369-385).
    float32_rates = (48000,)
    cast_input = False  # Encodec casts its own input, stage by stage

    build = staticmethod(lambda rate: encodec_for_rate(rate))

    @staticmethod
    def on_device(model):
        # cuDNN wants the LSTM's weights in one buffer, or it warns and
        # copies them on every call.
        model.lstm.flatten_parameters()

    def prep(self, data, sr, pcm16):
        """JAX pipeline.py:882-899: [C, S] at the model's rate and its
        original_samples // 320 frames, original_samples taken at the
        model's rate before the resample; a Pcm16 item's samples as they
        are, [1, S]. Files over 10 s are refused."""
        cfg = fe.ENCODEC_CONFIGS[self.rate]
        if pcm16:
            pre = data[None, :]
            original_samples = len(data)
        else:
            original_samples = int(len(data) * self.rate / sr) if sr != self.rate else len(data)
            pre = fe.preprocess_for_encodec(
                data, sr, target_sample_rate=self.rate,
                target_channels=cfg["channels"], return_tensor=False,
            )
        if pre.shape[-1] > cfg["max_samples"]:
            raise ValueError(
                f"Audio too long: {pre.shape[-1]} samples > {cfg['max_samples']} max samples"
            )
        return pre, original_samples // cfg["hop_length"]

    def group(self, item, file_batch, patch_chunk):
        return fe.ENCODEC_CONFIGS[self.rate]["max_samples"], file_batch

    def chunks(self, items, file_batch, patch_chunk):
        channels = fe.ENCODEC_CONFIGS[self.rate]["channels"]
        out = []
        for chunk, b, length in super().chunks(items, file_batch, patch_chunk):
            if channels == 1 or any(item.row.shape[0] > 1 for item in chunk):
                # preprocess_for_encodec's duplicate of a mono file, on the host.
                chunk = [
                    item._replace(row=np.broadcast_to(item.row, (channels, item.row.shape[-1])))
                    for item in chunk
                ]
            out.append((chunk, b, length))
        return out

    def from_wire(self, wave):
        channels = fe.ENCODEC_CONFIGS[self.rate]["channels"]
        if wave.shape[1] < channels:  # the duplicate of a mono file, made on the device
            wave = wave.expand(-1, channels, -1).contiguous()
        return wave

    def embed(self, forward, wave, valid):
        return forward(wave)

    def prep_counts(self, chunks):
        channels = fe.ENCODEC_CONFIGS[self.rate]["channels"]
        return {"dup": sum(len(c) for c, _, _ in chunks if c[0].row.shape[0] < channels)}

    def step_counts(self, valid):
        return {"frames": int(valid.sum())}


class WavLMFamily(Family):
    """WavLM-Large's rows, one a 20 ms frame of the convolution chain: the
    16 kHz wave as it is (a Pcm16 item's int16 samples; other input mixed to
    mono and resampled as VGGish's), normalised per clip on the device. Files
    are grouped by their exact length, so no program pads a clip, whose
    normalisation and attention would see the padding; a long file shrinks
    its group's batch, so that the attention's [B * 16, T, T] scores stay
    within a 64-clip chunk of 10 s files. The ``step`` span counts the frames
    folded in (``frames``)."""

    cast_input = False  # the model normalises in float32, then casts
    # The frames of a 10 s clip: the batch budget of the attention's scores.
    budget_frames = wavlm_frames(160000)

    build = staticmethod(lambda rate: WavLM())

    def prep(self, data, sr, pcm16):
        if not pcm16:
            if data.ndim > 1:
                data = np.mean(data, axis=1)
            if sr != self.rate:
                data = resample(data, sr, self.rate)
            data = data.astype(np.float32)
        frames = wavlm_frames(len(data))
        if frames == 0:
            raise ValueError(f"Audio too short for WavLM ({len(data)} samples: no frame)")
        return data, frames

    def group(self, item, file_batch, patch_chunk):
        scale = (self.budget_frames / item.valid) ** 2
        return len(item.row), max(1, min(file_batch, int(file_batch * scale)))

    def embed(self, forward, wave, valid):
        return forward(fe.dequant_i16(wave, self.full_scale))

    def step_counts(self, valid):
        return {"frames": int(valid.sum())}


# The family entries, by registry.ModelConfig.family.
FAMILIES = {"vggish": VGGishFamily, "pann": PannFamily, "clap": ClapFamily,
            "encodec": EncodecFamily, "wavlm": WavLMFamily}


def cast_model(family: str, model: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Cast every floating parameter and buffer of ``model`` to ``dtype`` in
    place (BatchNorm's running statistics too, which the JAX package casts as
    pytree leaves), but those the family keeps float32. Returns ``model``."""
    prefixes = FAMILIES[family].keep_float32
    buffers = FAMILIES[family].keep_float32_buffers
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
    """config.model_dtype(), but float32 at the family's float32_rates
    (encodec-48k) unless FAD_TPU_MODEL_DTYPE is set explicitly."""
    dtype = config.model_dtype()
    if (dtype != torch.float32 and sample_rate in FAMILIES[family].float32_rates
            and not config.model_dtype_is_forced()):
        return torch.float32
    return dtype


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
        self.family = FAMILIES[self.cfg.family](self.cfg.sample_rate, self.device)
        self.dtype = model_compute_dtype(self.cfg.family, self.cfg.sample_rate)
        self.model = model if self.dtype == torch.float32 else cast_model(
            self.cfg.family, model, self.dtype)
        self.forward = self._resolve_forward()
        if file_batch is None:
            file_batch = self.family.file_batch[self.device.type]
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
        float32; in a reduced dtype, the input cast to it (where the family
        casts it) and the output cast back to float32."""
        if self.dtype == torch.float32:
            return self.model
        model, dtype = self.model, self.dtype
        cast_input = self.family.cast_input

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
        try:
            with self.timer.stage(f"embed_files[{self.cfg.family}]", "embed"), \
                    torch.inference_mode():
                return self._embed(audio_list, sr, strict, sink)
        finally:
            if self.verbose:
                print(self.timer.report())

    def _embed(self, audio_list, sr, strict, sink):
        family = self.family
        wire = sr == self.cfg.sample_rate
        # Per file: None where prep failed, else its row count (sink) or its
        # embeddings by segment.
        per_file: List = [None] * len(audio_list)
        items: List[Item] = []
        n_pcm16 = 0
        with profiling.span("prep", files=len(audio_list)) as prep:
            for i, audio in enumerate(audio_list):
                pcm16 = wire and isinstance(audio, Pcm16)
                try:
                    row, valid = family.prepare(
                        audio.samples if pcm16 else np.asarray(audio), sr, pcm16)
                except Exception as e:
                    if strict:
                        raise
                    if self.verbose:
                        print(f"[FAD-TORCH] Error processing audio: {e}")
                    continue
                n_pcm16 += pcm16
                per_file[i] = 0 if sink is not None else {}
                items.append(Item(i, 0, row, valid))
            chunks = family.chunks(items, self.file_batch, self.patch_chunk)
            if prep is not None:
                prep.counts.update(pcm16=n_pcm16, **family.prep_counts(chunks))

        total = len(audio_list) if family.total_of_inputs else sum(len(c) for c, _, _ in chunks)
        pending = []
        done = 0
        for chunk, b, length in chunks:
            wave = family.from_wire(self._to_device(
                _pack_wave([item.row for item in chunk], b, length, family.full_scale)))
            valid = np.zeros((b,), family.valid_dtype)  # padding rows: nothing valid
            valid[: len(chunk)] = [item.valid for item in chunk]
            if sink is not None:
                valid_dev = self._to_device(valid)
                with profiling.span("step", **family.step_counts(valid)):
                    emb = family.embed(self.forward, wave, valid_dev)
                    rows = torch.arange(emb.shape[1], device=emb.device)
                    mask = rows[None, :] < valid_dev[:, None]
                    sink.state = _fold_stats(sink.state, emb, mask)
                for item in chunk:
                    per_file[item.file] += min(item.valid, emb.shape[1])
                del emb, rows, mask  # folded: free the chunk's rows before the next one
            else:
                if family.forward_reads_valid:
                    valid = self._to_device(valid)
                pending.append((chunk, family.embed(self.forward, wave, valid)))
            done += len(chunk)
            if self.verbose:
                print(f"[FAD-TORCH] embedded {done}/{total} {family.unit}")
        # Copy back after all launches, so device work overlaps host packing.
        for chunk, emb_dev in pending:
            emb = emb_dev.cpu().numpy()
            for row, item in enumerate(chunk):
                per_file[item.file][item.seg] = emb[row, : item.valid]
        if sink is None:
            for i, segs in enumerate(per_file):
                if segs is not None:
                    per_file[i] = (np.concatenate([segs[k] for k in sorted(segs)]) if segs
                                   else np.zeros((0, self.cfg.embedding_dim), np.float32))
        return per_file

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

    def _clap_prep(self, data: np.ndarray, sr: int, pcm16: bool = False):
        """CLAP's host steps for one file, its wire decided (ClapFamily.prepare);
        they read no pipeline state."""
        return ClapFamily(fe.CLAP_SAMPLE_RATE, torch.device("cpu")).prepare(data, sr, pcm16)
