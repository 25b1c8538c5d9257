"""The port's embedding pipeline, frozen by digest: what crosses the wire,
in which chunks and in which order, the prep and step spans' counts, the
streamed statistics and the host embeddings, for each family at the CUDA
file_batch of 64.

The inputs of each model: PCM16 items at the model's rate, float arrays on
the int16 grid and off it, a stereo item, items that fail their host
preparation (strict=False), more files than one chunk holds (a short last
chunk), then a second call at 22.05 kHz (every item resampled, a silent one
landing on the grid). VGGish adds a file longer than patch_chunk; the
Encodec-48k corpus has a chunk that mixes PCM16 and float items and a
chunk of PCM16 items alone, whose second channel the device makes.

The networks are seeded random projections in place of the real ones, so
the test stays cheap on the CPU while every sample of a chunk reaches an
embedding: the frontends (log-mel kernels' plain versions, the int16
dequantisation) are the port's own. The digests were taken on the pipeline
of four per-family loops; any change to the bytes shipped, the chunking,
the order of launches, the masks or the statistics shows here.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frechet_audio_distance_exported_tpu_torch import pipeline, registry  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import frontends as fe  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import profiling  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils.audio_io import Pcm16  # noqa: E402

FILE_BATCH = 64
OTHER_SR = 22050

DIGESTS = {
    "vggish": {
        "wire": "98ef3e0c4d6aeffd7e55a77af336ebf6feef5f7c19fd87a513ebbc3e3e569153",
        "spans": "b4a04d66efa30f8e77ca5dc4938ae9553f9e4c493097bfdc9cdb6a79d3d1aaa5",
        "lines": "f3b2a6837c5804c19725d59f0f6f99e83e8fce2b27a5534d68c1240e80b4226f",
        "stats": "db4140a5e32f1d1c0bb15fae55778c7bf0b2effd2bc71c42e38f2cf7f25247df",
        "embeddings": "b234441dac40640a1cfe267c8b34780752071a7cfb5e616044c9e3ad9805d337",
    },
    "pann-16k": {
        "wire": "3f52a2cc3130cbaa6f14075703db1bf3225cbae5926bf20e9a27808d5a0ab8b4",
        "spans": "ed30c4a2e9d8f3dee450efa398d6fd5af545b438ab16e12421489b597103ef4f",
        "lines": "83cde4d67f49f13de40ca0d2c4cdc0ae3b8c58390ede0bcdf2898ae555a96c86",
        "stats": "fd3288a6a0027403afa893fedaab41d598db37feb034051962b7b2dde3334283",
        "embeddings": "057327774ed8c56e67f3e9f79ab8c68865c311c608c77449b701bdf1eac922fa",
    },
    "clap": {
        "wire": "5a1b554b3edce06f6fbbbb8ba9fea7be763618145d35707eb77d3d3f73de6e32",
        "spans": "5cdf9b95c62d9c0a808dd7285d93e175f07c4d03812735417dfd9433e13a4e6b",
        "lines": "decadcf7f0d56e803662dad88723a22e0295cbc5031263dcf3dc21078a0a8a99",
        "stats": "b55257880ad480792ee15331dbc85f26e0b6308842a59a45a938c39f3a7c26fd",
        "embeddings": "b566fbb8a436d2dce927f8cb46cad42e4bf15325a2025b23da40af3930793a4c",
    },
    "encodec-24k": {
        "wire": "8d9e6e9e35cca109620f69c9ff242720bd35d59394d9f671d810c14ddf466747",
        "spans": "ea30a606f29d51bbad92531be66abf188d5f8f32f4367b075ac071837c9c30f2",
        "lines": "879a7e74333a226cb192b158a076ccb58fcf024ba4ebde5466436eb98a0d645f",
        "stats": "68a84c93fe013e074469bf9f7f3ab596eb8f1b64bd12458b1df35528c3b7c5b4",
        "embeddings": "6f9f8851bbba9de32ed7332d16dc7b973bcbd08ec3c08aae33ef6cbe5cad4879",
    },
    "encodec-48k": {
        "wire": "ef270e8273f1b620c206ccdc9980915cad170d75842fc4dae9784106791a4797",
        "spans": "ebbb1166a3b01779b2fd42bcf0ebea86c92846605f68821cdc52be63088f5c57",
        "lines": "5c580171cfb57145b94ee10ea620ae6d4cfdebc52cbe08d05370a0fef34e108f",
        "stats": "00157b064e1a9795da382d96b034df442da81bb4d6bf339a0a3ab4c5102e35f5",
        "embeddings": "eb697ac787dce4fe16f3a5f6b35f4f199114628a1fdf08d23da07d039860f137",
    },
}


class MelStandIn(torch.nn.Module):
    """[B, T, 64] log-mel -> [B, d]: time mean and max, then a projection."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = torch.nn.Linear(2 * fe.VGGISH_MEL_BINS, dim)

    def forward(self, mel):
        return self.proj(torch.cat([mel.mean(1), mel.amax(1)], dim=-1))


class PatchStandIn(torch.nn.Module):
    """[N, 96, 64] VGGish patches -> [N, 128]."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = torch.nn.Linear(fe.VGGISH_PATCH_FRAMES * fe.VGGISH_MEL_BINS, dim)

    def forward(self, patches):
        return self.proj(patches.flatten(1))


class FrameStandIn(torch.nn.Module):
    """[B, C, S] waveform (int16 on the k/32768 grid, or float32) ->
    [B, S / 320, 128]: each 320-sample hop of every channel projected."""

    def __init__(self, channels: int, dim: int):
        super().__init__()
        self.proj = torch.nn.Linear(channels * 320, dim)

    def forward(self, wave):
        b, c, s = wave.shape
        wave = fe.dequant_i16(wave)
        return self.proj(wave.reshape(b, c, s // 320, 320).permute(0, 2, 1, 3).flatten(2))


def stand_in(cfg):
    torch.manual_seed(0)
    if cfg.family == "vggish":
        model = PatchStandIn(cfg.embedding_dim)
    elif cfg.family == "encodec":
        model = FrameStandIn(fe.ENCODEC_CONFIGS[cfg.sample_rate]["channels"], cfg.embedding_dim)
    else:
        model = MelStandIn(cfg.embedding_dim)
    return model.eval()


def pcm(rng, n: int, scale: float = 0.2) -> np.ndarray:
    return np.clip(np.round(rng.standard_normal(n) * scale * 32768.0), -32768, 32767).astype(
        np.int16)


def corpus(name: str, rng):
    """(items at the model's rate, items at OTHER_SR)."""
    cfg = registry.ported_model_config(name)
    sr = cfg.sample_rate
    base = {"vggish": sr, "pann": sr, "clap": 2 * sr, "encodec": 2 * sr}[cfg.family]
    lengths = [base + 5 * i for i in range(70)]
    items = []
    for i, n in enumerate(lengths):
        k = pcm(rng, n)
        if i % 3 == 0:
            items.append(k.astype(np.float32) / 32768.0)  # float on the grid
        elif i % 7 == 1:
            items.append(rng.standard_normal(n).astype(np.float32) * 0.1)  # off the grid
        else:
            items.append(Pcm16(k))
    items.insert(5, np.stack([pcm(rng, base), pcm(rng, base)], axis=1).astype(np.float32) / 32768.0)
    items.insert(9, np.array(["not audio"]))
    if cfg.family == "vggish":
        # 1030 patches: more than patch_chunk (1024), so two segments.
        items.insert(12, Pcm16(pcm(rng, 160 * (96 * 1030 - 1) + 400)))
        items.insert(13, Pcm16(pcm(rng, 3 * sr + 11)))
    elif cfg.family == "pann":
        items.insert(12, Pcm16(pcm(rng, 100)))  # too short for CNN14
        items.insert(13, Pcm16(pcm(rng, 12 * sr)))  # > 1032 frames: a smaller batch cap
    elif cfg.family == "clap":
        items.insert(12, Pcm16(pcm(rng, 12 * sr)))  # cut at the read window
        items.insert(13, Pcm16(pcm(rng, sr // 2)))
    else:
        items.insert(12, Pcm16(pcm(rng, 11 * sr)))  # over 10 s: refused
        if sr == 48000:
            # A tail chunk of PCM16 items alone: the device repeats the channel.
            items = items[:64] + [Pcm16(pcm(rng, base + i)) for i in range(5)]
    other = [
        Pcm16(pcm(rng, OTHER_SR)),
        pcm(rng, OTHER_SR + 500).astype(np.float32) / 32768.0,
        rng.standard_normal(OTHER_SR + 900).astype(np.float32) * 0.1,
        np.stack([pcm(rng, OTHER_SR), pcm(rng, OTHER_SR)], axis=1).astype(np.float32) / 32768.0,
        np.zeros(OTHER_SR, np.float32),
    ]
    return (items, sr), (other, OTHER_SR)


def _sha(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else repr(p).encode())
    return h.hexdigest()


def _array_sha(a: np.ndarray) -> str:
    return _sha(str(a.dtype), a.shape, np.ascontiguousarray(a).tobytes())


def run(name: str, monkeypatch, capsys) -> dict:
    cfg = registry.ported_model_config(name)
    pipe = pipeline.EmbeddingPipeline(name, stand_in(cfg), "cpu", file_batch=FILE_BATCH,
                                      verbose=True)
    wire = []
    to_device = pipe._to_device

    def recording(arr):
        wire.append(_array_sha(arr))
        return to_device(arr)

    monkeypatch.setattr(pipe, "_to_device", recording)
    calls = corpus(name, np.random.default_rng(len(name)))
    capsys.readouterr()
    profiling.start()
    try:
        state = None
        for items, sr in calls:
            state = pipe.accumulate_stats(items, sr, state)
        host = [pipe.embed_files(items, sr) for items, sr in calls]
    finally:
        spans = profiling.stop()
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith(("[FAD-TORCH] embedded", "[FAD-TORCH] Error"))]
    return {
        "wire": _sha(wire),
        "spans": _sha([(s.name, sorted(s.counts.items())) for s in spans
                       if s.name in ("prep", "step")]),
        "lines": _sha(lines),
        "stats": _sha(*(t.numpy().tobytes() for t in state)),
        "embeddings": _sha([None if e is None else _array_sha(e) for per_file in host
                            for e in per_file]),
    }


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["vggish", "pann-16k", "clap", "encodec-24k", "encodec-48k"])
def test_pipeline_digest_is_unchanged(name, monkeypatch, capsys, one_thread):
    got = run(name, monkeypatch, capsys)
    assert got == DIGESTS[name]
