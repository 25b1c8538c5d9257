"""The PyTorch port must run without jax, jaxlib or tqdm.

The machine with the card has none of them, and score()'s -1 sentinel would
turn a stray import on the scoring path into a silent wrong answer. This
test scores a small corpus with the port (VGGish, pann-16k, encodec-24k and
CLAP), then once through the CLI under a one-rank mesh inside a profiler
trace, then decodes one file of each lossless container, resamples through
the native C library and scores a directory of FLAC files, in a subprocess whose import system refuses those modules (and the
JAX package itself), modelled on test_torch_free_runtime.py, which guards
the JAX package the other way.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO_ROOT = Path(__file__).parent.parent

_CHILD = textwrap.dedent(
    """
    import sys

    BLOCKED = ("jax", "jaxlib", "tqdm", "frechet_audio_distance_exported_tpu")

    class _Block:
        '''Meta-path hook: any import of a blocked module fails loudly.'''

        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"{{name}} import attempted by the PyTorch port")
            return None

    sys.meta_path.insert(0, _Block())
    sys.path.insert(0, {repo!r})

    import os

    import numpy as np
    import torch

    torch.set_num_threads(2)

    from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance
    from frechet_audio_distance_exported_tpu_torch.utils.audio_io import write_wav

    sr = 16000
    bg, ev, ck = sys.argv[1], sys.argv[2], sys.argv[3]
    t = np.arange(int(sr * 1.2)) / sr
    for d, scale in ((bg, 0.5), (ev, 0.45)):
        for i, freq in enumerate((440.0, 660.0, 880.0)):
            write_wav(os.path.join(d, f"{{i}}.wav"), np.sin(2 * np.pi * freq * t) * scale, sr)

    scores = []
    for model in ("vggish", "pann-16k", "encodec-24k", "clap"):
        fad = FrechetAudioDistance(model_name=model, weights="random", ckpt_dir=ck, device="cpu")
        scores += [fad.score(bg, ev), fad.score(bg, ev, device_stats=True)]
    for score in scores:
        assert score != -1, "score failed under the import block"
        assert np.isfinite(score) and score > 0, score
    # The CLI, the mesh (a one-rank gloo group from torchrun's variables) and
    # the profiling utilities, under the same block.
    import socket

    from frechet_audio_distance_exported_tpu_torch import parallel
    from frechet_audio_distance_exported_tpu_torch.__main__ import main
    from frechet_audio_distance_exported_tpu_torch.utils import profiling

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(s.getsockname()[1]),
                      WORLD_SIZE="1", RANK="0")
    s.close()
    with profiling.trace(), profiling.annotate("cli"):
        rc = main([bg, ev, "--weights", "random", "--ckpt-dir", ck, "--device", "cpu",
                   "--mesh", "--device-stats", "--json"])
    assert rc == 0 and parallel.mesh.pad_to_shards(3, 2) == 4
    # The host runtime: one file of each lossless container decoded, the
    # native C resampler, and a directory of FLAC files scored.
    from frechet_audio_distance_exported_tpu_torch import native
    from frechet_audio_distance_exported_tpu_torch.ops.resample import resample
    from frechet_audio_distance_exported_tpu_torch.utils import aiff, au, audio_io, caf, flac, wav64

    assert native.available(), "the native host library did not build"
    t22 = np.arange(11025) / 22050
    stereo = np.stack([np.sin(2 * np.pi * 440 * t22), np.sin(2 * np.pi * 660 * t22)], 1) * 0.4
    writers = {{
        "a.flac": flac.write_flac, "b.aiff": aiff.write_aiff, "c.au": au.write_au,
        "d.caf": caf.write_caf, "e.rf64": wav64.write_rf64, "f.w64": wav64.write_w64,
        "g.wav": audio_io.write_wav,
        "h.aifc": lambda path, x, rate: aiff.write_aiff(path, x, rate, subtype="float32"),
    }}
    for name, write in writers.items():
        write(os.path.join(ck, name), stereo, 22050)
        y, got = audio_io.sf_read(os.path.join(ck, name))
        assert got == 22050 and y.shape == stereo.shape, (name, y.shape)
        assert np.abs(y - stereo).max() <= 1 / 32768, name
    assert resample(y.mean(axis=1), 22050, 16000).shape == (8000,)
    fl = os.path.join(ck, "flac_bg")
    os.mkdir(fl)
    for i, freq in enumerate((330.0, 550.0, 770.0)):
        flac.write_flac(os.path.join(fl, f"{{i}}.flac"), np.sin(2 * np.pi * freq * t) * 0.5, sr)
    fad = FrechetAudioDistance(model_name="vggish", weights="random", ckpt_dir=ck, device="cpu")
    flac_score = fad.score(fl, ev)
    assert flac_score != -1 and np.isfinite(flac_score) and flac_score > 0, flac_score
    scores.append(flac_score)
    loaded = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not loaded, loaded
    print("JAX_FREE_OK", *scores)
    """
).format(repo=str(REPO_ROOT))


def test_port_scores_with_jax_and_tqdm_blocked(tmp_path):
    dirs = [tmp_path / d for d in ("bg", "ev", "ck")]
    for d in dirs:
        d.mkdir()
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, *map(str, dirs)],
        capture_output=True,
        text=True,
        timeout=600,
        cwd=str(REPO_ROOT),
    )
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "JAX_FREE_OK" in r.stdout, r.stdout
