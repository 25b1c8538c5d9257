"""Fréchet Audio Distance on PyTorch and CUDA — public API.

Counterpart of frechet_audio_distance_exported_tpu/fad.py: the same
constructor kwargs (minus ``mesh``, plus ``device``), the same methods
(score / get_embeddings / _get_embedding_for_audio /
calculate_embd_statistics / calculate_frechet_distance / _load_audio_files /
warmup), the same -1 error sentinel and .npy embedding caches, for all
seven model names: VGGish, PANN (pann-8k/16k/32k), Encodec (encodec-24k,
encodec-48k) and CLAP.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from . import registry
from .config import resolve_device, set_exact_float32
from .models.clap import CLAP
from .models.encodec import encodec_for_rate
from .models.pann import PANN
from .models.vggish import VGGish
from .ops import stats as stats_ops
from .pipeline import EmbeddingPipeline
from .utils import audio_io
from .utils import weights as weight_store

# Re-exported registry tables (JAX fad.py:31-33).
VALID_MODELS = registry.VALID_MODELS
PANN_SAMPLE_RATES = registry.PANN_SAMPLE_RATES
ENCODEC_SAMPLE_RATES = registry.ENCODEC_SAMPLE_RATES

load_audio = audio_io.load_audio


def _save_embeddings(path: str, embds: np.ndarray) -> None:
    """np.save with parent-dir creation (a bare filename has no dirname)."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    np.save(path, embds)


class FrechetAudioDistance:
    """FAD calculator running on a CUDA device (or, when asked, the CPU).

    Example:
        >>> fad = FrechetAudioDistance(model_name="vggish", device="cuda")
        >>> score = fad.score("background_audio/", "eval_audio/")
    """

    def __init__(
        self,
        ckpt_dir: Optional[str] = None,
        model_name: str = "vggish",
        sample_rate: Optional[int] = None,
        channels: int = 1,
        verbose: bool = False,
        audio_load_worker: int = 8,
        weights: str = "auto",
        seed: int = 0,
        file_batch: Optional[int] = None,
        patch_chunk: int = 1024,
        device: str = "cuda",
    ):
        """Initialize the FAD calculator.

        Args (reference-compatible):
            ckpt_dir: folder of weight bundles (.npz). Defaults to the JAX
                package's cache dir (FAD_TPU_CKPT_DIR overrides).
            model_name: one of VALID_MODELS: 'vggish', 'pann-8k' /
                'pann-16k' / 'pann-32k', 'encodec-24k' / 'encodec-48k' or
                'clap'.
            sample_rate: must equal the model default or be None.
            channels: number of channels (1 for mono). Files are mono-mixed
                as they are loaded where their rank exceeds it, so
                encodec-48k reads stereo files as stereo only with 2.
            verbose: progress printing.
            audio_load_worker: decode thread count.
        Extensions:
            weights: 'auto' (load the model's bundle from <ckpt_dir>, e.g.
                vggish_tpu.npz) or 'random'.
            seed: generator seed for weights='random'.
            file_batch / patch_chunk: batching knobs of the pipeline.
            device: 'cuda' (default; raises without CUDA) or 'cpu'.
        """
        model_config = registry.ported_model_config(model_name)
        expected_sr = model_config.sample_rate
        if sample_rate is None:
            sample_rate = expected_sr
        elif sample_rate != expected_sr:
            raise ValueError(
                f"Model '{model_name}' requires sample_rate={expected_sr}, got {sample_rate}"
            )

        self.model_name = model_name
        self.sample_rate = sample_rate
        self.channels = channels
        self.verbose = verbose
        self.audio_load_worker = audio_load_worker
        self._weights_mode = weights
        self._seed = seed
        self._file_batch = file_batch
        self._patch_chunk = patch_chunk

        self.device = resolve_device(device)
        set_exact_float32()
        if self.verbose:
            print(f"[FAD-TORCH] Using device: {self.device}")

        if ckpt_dir is None:
            ckpt_dir = registry.default_ckpt_dir()
        os.makedirs(ckpt_dir, exist_ok=True)
        self.ckpt_dir = ckpt_dir

        self._load_model()

    def _load_model(self):
        """Resolve weights and build the batched embedding pipeline."""
        state = weight_store.get_params(
            self.model_name, self.ckpt_dir, weights=self._weights_mode, seed=self._seed
        )
        cfg = registry.ported_model_config(self.model_name)
        with torch.device("meta"):  # no throwaway init of the full-size weights
            if cfg.family == "encodec":
                model = encodec_for_rate(cfg.sample_rate)
            else:
                model = {"vggish": VGGish, "pann": PANN, "clap": CLAP}[cfg.family]()
        model.load_state_dict(state, assign=True)
        self.model = model.to(self.device).eval()
        if cfg.family == "encodec":
            # After the move: cuDNN wants the LSTM's weights in one buffer,
            # or it warns and copies them on every call.
            self.model.lstm.flatten_parameters()
        self.pipeline = EmbeddingPipeline(
            self.model_name,
            self.model,
            self.device,
            file_batch=self._file_batch,
            patch_chunk=self._patch_chunk,
            verbose=self.verbose,
        )

    # ------------------------------------------------------------------
    # Embeddings
    # ------------------------------------------------------------------

    def get_embeddings(self, x: List[np.ndarray], sr: int) -> np.ndarray:
        """Embeddings for a list of audio arrays, concatenated over files
        (VGGish: one row per 0.96 s patch; Encodec: one row per 320 samples
        at the model's rate; PANN and CLAP: one row per file)."""
        per_file = self.pipeline.embed_files(x, sr, strict=False)
        embd_lst = [e for e in per_file if e is not None]
        if not embd_lst:
            return np.array([])
        return np.concatenate(embd_lst, axis=0)

    def _get_embedding_for_audio(self, audio: np.ndarray) -> np.ndarray:
        """Single-file hook; raises on error."""
        return self.pipeline.embed_single(audio, self.sample_rate)

    # ------------------------------------------------------------------
    # Statistics & metric
    # ------------------------------------------------------------------

    def calculate_embd_statistics(self, embd_lst):
        """Mean/covariance (host float64, reference-exact)."""
        if isinstance(embd_lst, list):
            embd_lst = np.array(embd_lst)
        return stats_ops.calculate_embd_statistics_np(embd_lst)

    def calculate_frechet_distance(self, mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
        """Fréchet distance between two Gaussians, by the float64 symmetric
        eigh route (same math as the reference's scipy sqrtm, ~1e-7
        relative; stats_ops.frechet_distance_np is the scipy algorithm)."""
        return stats_ops.frechet_distance_eigh_np(mu1, sigma1, mu2, sigma2, eps=eps)

    # ------------------------------------------------------------------
    # Audio loading & scoring
    # ------------------------------------------------------------------

    def _load_audio_files(self, dir: str, dtype: str = "float32") -> List[np.ndarray]:
        return audio_io.load_audio_files(
            dir,
            self.sample_rate,
            self.channels,
            dtype=dtype,
            num_workers=self.audio_load_worker,
            verbose=self.verbose,
        )

    def score(
        self,
        background_dir: str,
        eval_dir: str,
        background_embds_path: Optional[str] = None,
        eval_embds_path: Optional[str] = None,
        dtype: str = "float32",
        device_stats: bool = False,
    ) -> float:
        """FAD between two directories of audio files, or -1 on any error
        (the reference's sentinel). Embedding .npy caches follow the
        reference: loaded when the path exists, written after computing.

        device_stats=True streams (N, Σx, Σxxᵀ) on the device; embeddings
        never reach the host. It cannot fill the .npy caches, so with a
        cache path it falls back to the host path.
        """
        try:
            if device_stats and not background_embds_path and not eval_embds_path:
                return self._score_device_stats(background_dir, eval_dir, dtype)
            if device_stats:
                print(
                    "[FAD-TORCH] Warning: device_stats=True is incompatible with "
                    "background_embds_path/eval_embds_path (streamed statistics "
                    "never materialize embeddings); falling back to the host-"
                    "stats path with .npy caching."
                )
            if background_embds_path and os.path.exists(background_embds_path):
                if self.verbose:
                    print(f"[FAD-TORCH] Loading embeddings from {background_embds_path}...")
                embds_background = np.load(background_embds_path)
            else:
                audio_background = self._load_audio_files(background_dir, dtype=dtype)
                embds_background = self.get_embeddings(audio_background, sr=self.sample_rate)
                if background_embds_path:
                    _save_embeddings(background_embds_path, embds_background)

            if eval_embds_path and os.path.exists(eval_embds_path):
                if self.verbose:
                    print(f"[FAD-TORCH] Loading embeddings from {eval_embds_path}...")
                embds_eval = np.load(eval_embds_path)
            else:
                audio_eval = self._load_audio_files(eval_dir, dtype=dtype)
                embds_eval = self.get_embeddings(audio_eval, sr=self.sample_rate)
                if eval_embds_path:
                    _save_embeddings(eval_embds_path, embds_eval)

            if len(embds_background) == 0:
                print("[FAD-TORCH] Background set dir is empty, exiting...")
                return -1
            if len(embds_eval) == 0:
                print("[FAD-TORCH] Eval set dir is empty, exiting...")
                return -1

            # Fewer rows than dims: the Gram-trick epilogue is exact and
            # skips the d x d eigendecompositions. It bypasses the two hooks,
            # so it stands down when a subclass overrides either of them.
            d = embds_background.shape[1]
            n_min = min(len(embds_background), len(embds_eval))
            stock_hooks = (
                type(self).calculate_embd_statistics
                is FrechetAudioDistance.calculate_embd_statistics
                and type(self).calculate_frechet_distance
                is FrechetAudioDistance.calculate_frechet_distance
            )
            if 1 < n_min < d and stock_hooks:
                return stats_ops.frechet_distance_lowrank_np(embds_background, embds_eval)

            mu_background, sigma_background = self.calculate_embd_statistics(embds_background)
            mu_eval, sigma_eval = self.calculate_embd_statistics(embds_eval)

            return self.calculate_frechet_distance(
                mu_background, sigma_background, mu_eval, sigma_eval
            )
        except Exception as e:
            print(f"[FAD-TORCH] An error occurred: {e}")
            return -1

    def _stream_audio_chunks(self, dir: str, dtype: str, chunk_files: int):
        """Decode a directory in chunks, one chunk ahead of the consumer, so
        decoding overlaps device work and host memory holds about two
        chunks of waveforms."""
        from multiprocessing.dummy import Pool as ThreadPool

        files = audio_io.list_audio_files(dir)
        paths = [os.path.join(dir, f) for f in files]
        pool = ThreadPool(self.audio_load_worker)

        def load(p):
            return audio_io.load_audio(p, self.sample_rate, self.channels, dtype)

        try:
            pending = None
            for i in range(0, len(paths), chunk_files):
                nxt = pool.map_async(load, paths[i : i + chunk_files])
                if pending is not None:
                    yield pending.get()
                pending = nxt
            if pending is not None:
                yield pending.get()
        finally:
            pool.close()
            pool.join()

    def _accumulate_dir(self, dir: str, dtype: str):
        state = None
        done = 0
        for chunk in self._stream_audio_chunks(dir, dtype, 4 * self.pipeline.file_batch):
            state = self.pipeline.accumulate_stats(chunk, self.sample_rate, state=state)
            done += len(chunk)
            if self.verbose:
                print(f"[FAD-TORCH] accumulated {done} files from {dir}")
        return state

    def _score_device_stats(self, background_dir: str, eval_dir: str, dtype: str) -> float:
        """Streamed device statistics, then the float64 host epilogue through
        the calculate_frechet_distance hook."""
        st_bg = self._accumulate_dir(background_dir, dtype)
        st_ev = self._accumulate_dir(eval_dir, dtype)
        if st_bg is None:
            print("[FAD-TORCH] Background set dir is empty, exiting...")
            return -1
        if st_ev is None:
            print("[FAD-TORCH] Eval set dir is empty, exiting...")
            return -1
        mu1, sigma1 = stats_ops.finalize_stats_np(st_bg)
        mu2, sigma2 = stats_ops.finalize_stats_np(st_ev)
        return self.calculate_frechet_distance(mu1, sigma1, mu2, sigma2)

    def warmup(self, durations=(10.0,), num_files: int = None, device_stats: bool = True) -> None:
        """Run the pipeline once per clip duration (seconds), so the first
        real request does not pay the kernel build and the allocator's
        first growth. Both wire variants run (float32 noise and int16-grid
        clips), and with device_stats both the init and the update
        statistics steps."""
        num_files = num_files or self.pipeline.file_batch
        rng = np.random.default_rng(0)
        for dur in durations:
            f32 = [
                (rng.standard_normal(int(self.sample_rate * dur)) * 0.1).astype(np.float32)
                for _ in range(num_files)
            ]
            i16 = [np.round(c * 32768.0).clip(-32768, 32767) / 32768.0 for c in f32]
            i16 = [c.astype(np.float32) for c in i16]
            for clips in (f32, i16):
                self.pipeline.embed_files(clips, self.sample_rate, strict=False)
                if device_stats:
                    state = self.pipeline.accumulate_stats(clips, self.sample_rate)
                    self.pipeline.accumulate_stats(clips, self.sample_rate, state=state)
