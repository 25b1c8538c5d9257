"""Fréchet Audio Distance on PyTorch and CUDA — public API.

Counterpart of frechet_audio_distance_exported_tpu/fad.py: the same
constructor kwargs (``mesh`` takes a parallel.mesh.DataMesh; plus
``device``), the same methods
(score / get_embeddings / _get_embedding_for_audio /
calculate_embd_statistics / calculate_frechet_distance / _load_audio_files /
warmup), the same -1 error sentinel and .npy embedding caches, for all
seven model names: VGGish, PANN (pann-8k/16k/32k), Encodec (encodec-24k,
encodec-48k) and CLAP; and WavLM-Large (wavlm-large), which the JAX package
does not run, on random weights only.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional

import numpy as np
import torch

from . import registry
from .config import apply_precision, exact_sqrtm, resolve_device
from .ops import stats as stats_ops
from .parallel.embed import merge_stats
from .pipeline import FAMILIES, EmbeddingPipeline, StatsSink
from .utils import audio_io, profiling
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


def _concat_rows(per_file) -> np.ndarray:
    """One matrix of every file's rows, in file order (files that failed are
    None and add none); an empty array when there is none."""
    embd_lst = [e for e in per_file if e is not None]
    if not embd_lst:
        return np.array([])
    return np.concatenate(embd_lst, axis=0)


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
        mesh=None,
    ):
        """Initialize the FAD calculator.

        Args (reference-compatible):
            ckpt_dir: folder of weight bundles (.npz). Defaults to the JAX
                package's cache dir (FAD_TPU_CKPT_DIR overrides).
            model_name: one of VALID_MODELS: 'vggish', 'pann-8k' /
                'pann-16k' / 'pann-32k', 'encodec-24k' / 'encodec-48k',
                'clap' or 'wavlm-large' (weights='random' only).
            sample_rate: must equal the model default or be None.
            channels: number of channels (1 for mono). Files are mono-mixed
                as they are loaded where their rank exceeds it, so
                encodec-48k reads stereo files as stereo only with 2.
            verbose: progress printing.
            audio_load_worker: decode thread count.
        Extensions:
            weights: 'auto' (load the model's bundle from <ckpt_dir>, e.g.
                vggish_tpu.npz; on a miss, download it or the reference
                artifact and convert that, unless FAD_TPU_OFFLINE is set)
                or 'random'.
            seed: generator seed for weights='random'.
            file_batch / patch_chunk: batching knobs of the pipeline.
            device: 'cuda' (default; raises without CUDA) or 'cpu'.
            mesh: a parallel.mesh.DataMesh (data_mesh()): this process is
                one rank, runs on the mesh's device (``device`` must name
                its type) and scores only its share of each directory; every
                rank calls score() with the same arguments and gets the same
                score. Only rank 0 prints progress and writes .npy caches.
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

        self._mesh = mesh
        if mesh is not None:
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"device={device!r} but the mesh runs on {mesh.device}")
            device = mesh.device
            self.verbose = verbose and mesh.rank == 0
        self.device = resolve_device(device)
        apply_precision()
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
        family = FAMILIES[cfg.family]
        with torch.device("meta"):  # no throwaway init of the full-size weights
            model = family.build(cfg.sample_rate)
        model.load_state_dict(state, assign=True)
        self.model = model.to(self.device).eval()
        family.on_device(self.model)
        self.pipeline = EmbeddingPipeline(
            self.model_name,
            self.model,
            self.device,
            file_batch=self._file_batch,
            patch_chunk=self._patch_chunk,
            verbose=self.verbose,
        )
        if self._mesh is not None:
            self.pipeline.set_mesh(self._mesh)

    def _agreed(self, fn):
        """fn(), and under a mesh every rank raises if any rank raised
        (parallel.mesh.DataMesh.agree), so no rank waits in a collective that
        another rank will never enter, and every rank returns the same."""
        return fn() if self._mesh is None else self._mesh.agree(fn)

    # ------------------------------------------------------------------
    # Embeddings
    # ------------------------------------------------------------------

    def get_embeddings(self, x: List[np.ndarray], sr: int) -> np.ndarray:
        """Embeddings for a list of audio arrays, concatenated over files
        (VGGish: one row per 0.96 s patch; Encodec: one row per 320 samples
        at the model's rate; WavLM: one row per 20 ms frame; PANN and CLAP:
        one row per file)."""
        return _concat_rows(self.pipeline.embed_files(x, sr, strict=False))

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
        relative). FAD_TPU_EXACT_SQRTM=1 runs the reference's scipy
        algorithm instead (JAX fad.py:182-185)."""
        if exact_sqrtm():
            return stats_ops.frechet_distance_np(mu1, sigma1, mu2, sigma2, eps=eps)
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

        Under a mesh every rank calls this with the same arguments. The
        empty-directory -1 is decided on the global counts, and a failure on
        any rank makes every rank return -1.
        """
        with profiling.span("score"):
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
                embds_background = self._dir_embeddings(
                    background_dir, dtype, background_embds_path)
                embds_eval = self._dir_embeddings(eval_dir, dtype, eval_embds_path)
                return self._agreed(lambda: self._score_embeddings(embds_background, embds_eval))
            except Exception as e:
                print(f"[FAD-TORCH] An error occurred: {e}")
                return -1

    def _dir_embeddings(self, dir: str, dtype: str, cache_path: Optional[str]) -> np.ndarray:
        """One directory's embedding matrix: read from cache_path where that
        file exists, else computed, and written there when a path is given.

        Under a mesh, rank 0 decides whether the cache exists (the broadcast
        is where the other ranks wait before reading it) and alone writes it;
        each rank decodes and embeds only its block of the directory, and the
        per-file embeddings are gathered in file order."""
        mesh = self._mesh
        if mesh is None:
            exists = bool(cache_path) and os.path.exists(cache_path)
        else:
            exists = bool(cache_path) and mesh.from_rank0(lambda: os.path.exists(cache_path))
        if exists:
            if self.verbose:
                print(f"[FAD-TORCH] Loading embeddings from {cache_path}...")
            return self._agreed(lambda: np.load(cache_path))
        if mesh is None:
            embds = self.get_embeddings(self._load_audio_files(dir, dtype=dtype), self.sample_rate)
        else:
            paths = mesh.from_rank0(lambda: self._dir_paths(dir))
            mine = paths[mesh.share(len(paths))]
            embds = _concat_rows(mesh.gather(lambda: self.pipeline.embed_local(
                self._load_audio_paths(mine, dtype), self.sample_rate)))
        if cache_path:

            def save():
                if mesh is None or mesh.rank == 0:
                    _save_embeddings(cache_path, embds)

            self._agreed(save)
        return embds

    def _score_embeddings(self, embds_background: np.ndarray, embds_eval: np.ndarray) -> float:
        if len(embds_background) == 0:
            print("[FAD-TORCH] Background set dir is empty, exiting...")
            return -1
        if len(embds_eval) == 0:
            print("[FAD-TORCH] Eval set dir is empty, exiting...")
            return -1

        # Fewer rows than dims: the Gram-trick epilogue is exact and skips
        # the d x d eigendecompositions. It bypasses the two hooks, so it
        # stands down when a subclass overrides either of them, and under
        # FAD_TPU_EXACT_SQRTM (JAX fad.py:272).
        d = embds_background.shape[1]
        n_min = min(len(embds_background), len(embds_eval))
        stock_hooks = (
            type(self).calculate_embd_statistics
            is FrechetAudioDistance.calculate_embd_statistics
            and type(self).calculate_frechet_distance
            is FrechetAudioDistance.calculate_frechet_distance
        )
        if 1 < n_min < d and stock_hooks and not exact_sqrtm():
            return stats_ops.frechet_distance_lowrank_np(embds_background, embds_eval)

        mu_background, sigma_background = self.calculate_embd_statistics(embds_background)
        mu_eval, sigma_eval = self.calculate_embd_statistics(embds_eval)

        return self.calculate_frechet_distance(mu_background, sigma_background, mu_eval, sigma_eval)

    def _dir_paths(self, dir: str) -> List[str]:
        with profiling.span("list"):
            return [os.path.join(dir, f) for f in audio_io.list_audio_files(dir)]

    def _load_audio_paths(self, paths: List[str], dtype: str) -> List[np.ndarray]:
        return audio_io.load_audio_paths(
            paths, self.sample_rate, self.channels, dtype=dtype,
            num_workers=self.audio_load_worker, verbose=self.verbose,
        )

    def _stream_audio_chunks(self, paths: List[str], dtype: str, chunk_files: int):
        """Decode files in chunks, one chunk ahead of the consumer, so
        decoding overlaps device work and host memory holds about two
        chunks of waveforms. A mono 16-bit PCM WAV at the model's rate comes
        as its int16 samples (audio_io.load_audio_wire), every other file as
        load_audio returns it."""
        from multiprocessing.dummy import Pool as ThreadPool

        pool = ThreadPool(self.audio_load_worker)

        def load(wait, p):
            with profiling.span("decode", parent=wait):
                return audio_io.load_audio_wire(p, self.sample_rate, self.channels, dtype)

        def collect(wait, result):
            with wait:
                return result.get()

        try:
            pending = None
            for i in range(0, len(paths), chunk_files):
                # The chunk's wait span is made when its files are handed to
                # the pool, so that their decode spans, in the pool's
                # threads, name it as their parent; it starts when the
                # consumer waits for the chunk (never across a yield).
                wait = profiling.span("decode.wait")
                chunk = paths[i : i + chunk_files]
                nxt = (wait, pool.map_async(functools.partial(load, wait), chunk))
                if pending is not None:
                    yield collect(*pending)
                pending = nxt
            if pending is not None:
                yield collect(*pending)
        finally:
            pool.close()
            pool.join()

    def _accumulate_paths(self, paths: List[str], dtype: str):
        """This process's streamed statistics over the given files, chunk by
        chunk; None when no file gave a row."""
        sink = StatsSink()
        done = 0
        for chunk in self._stream_audio_chunks(paths, dtype, 4 * self.pipeline.file_batch):
            self.pipeline.embed_local(chunk, self.sample_rate, sink=sink)
            done += len(chunk)
            if self.verbose:
                print(f"[FAD-TORCH] accumulated {done} files of {len(paths)}")
        return sink.state

    def _accumulate_dir(self, dir: str, dtype: str):
        """A directory's streamed statistics. Under a mesh each rank decodes
        and accumulates only its block of the files, and the states are
        merged once (parallel.embed.merge_stats)."""
        mesh = self._mesh
        if mesh is None:
            return self._accumulate_paths(self._dir_paths(dir), dtype)
        paths = mesh.from_rank0(lambda: self._dir_paths(dir))
        state = mesh.agree(lambda: self._accumulate_paths(paths[mesh.share(len(paths))], dtype))
        return merge_stats(mesh, state, self.pipeline.cfg.embedding_dim)

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

        def epilogue():
            with profiling.span("epilogue"):
                mu1, sigma1 = stats_ops.finalize_stats_np(st_bg)
                mu2, sigma2 = stats_ops.finalize_stats_np(st_ev)
                return self.calculate_frechet_distance(mu1, sigma1, mu2, sigma2)

        return self._agreed(epilogue)

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
