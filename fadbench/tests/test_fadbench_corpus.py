"""The corpus generator: distinct pairs, the same files from the same seed,
and a run's writes within the size the cells allow."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from conftest import ROOT, tiny_traffic

from fadbench import corpus


def test_no_two_calls_of_a_run_score_the_same_pair():
    for k in (1, 2, 3, 5, 6, 10):
        order = corpus.schedule(k)
        assert order[0] == (k, k) and len(order) == k * k + 1
        assert len(set(order)) == len(order)
        # From three directories a side, every call changes both.
        for (b0, e0), (b1, e1) in zip(order[1:], order[2:]):
            assert k < 3 or (b0 != b1 and e0 != e1)
    traffic = json.loads((ROOT / "fadbench" / "traffic" / "corpus1024_16k.json").read_text())
    subsets = corpus.draw_subsets(traffic, 12345)
    for side, draws in subsets.items():
        assert len(draws) == traffic["directories"] + 1
        assert len({d.tobytes() for d in draws}) == len(draws)
        for d in draws:
            assert len(np.unique(d)) == traffic["clips_per_call"][side]
            assert d.max() < traffic["pools"][side]["clips"]


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_the_same_seed_gives_the_same_files(tmp_path):
    traffic = tiny_traffic(16000, 1.0)
    written = {}
    for name, seed in (("a", 2**31 + 5), ("b", 2**31 + 5), ("c", 2**31 + 6)):
        pools = corpus.make_pools(traffic, corpus.seeds(seed)["pools"], "cpu")
        corpus.write_pools(str(tmp_path / name), pools, 16000)
        subsets = corpus.draw_subsets(traffic, corpus.seeds(seed)["directories"])
        for side, draws in subsets.items():
            for i, idx in enumerate(draws):
                corpus.link_dir(str(tmp_path / name), side, i, idx)
        written[name] = _files(tmp_path / name)
    assert written["a"] == written["b"]
    assert written["a"] != written["c"]
    assert len(written["a"]) == 12 + 2 * 3 * 4


def test_the_wav_files_decode_to_the_generated_pcm(tmp_path):
    from frechet_audio_distance_exported_tpu_torch.utils.audio_io import load_audio

    traffic = tiny_traffic(16000, 1.0)
    pools = corpus.make_pools(traffic, 7, "cpu")
    nbytes = corpus.write_pools(str(tmp_path), pools, 16000)
    assert nbytes == sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(tmp_path) for f in fs)
    for side, pcm in pools.items():
        assert pcm.dtype == np.int16 and pcm.shape == (6, 16000)
        x = load_audio(os.path.join(corpus.pool_dir(str(tmp_path), side), "00003.wav"), 16000, 1)
        assert np.array_equal(x, pcm[3] / np.float32(32768.0))
    # The eval law is louder and darker: different statistics on each side.
    assert pools["eval"].astype(float).std() > pools["background"].astype(float).std()


@pytest.mark.parametrize("name,most", [("corpus1024_16k", 0.85e9), ("corpus512_48k", 1.3e9)])
def test_a_runs_writes_stay_within_size(name, most):
    traffic = json.loads((ROOT / "fadbench" / "traffic" / f"{name}.json").read_text())
    clips = sum(traffic["pools"][s]["clips"] for s in corpus.SIDES)
    samples = corpus.clip_samples(traffic)
    # Each clip is written once (44-byte header, 16-bit mono); the pairs are links.
    assert clips * (44 + 2 * samples) <= most


def test_a_traffic_asking_for_more_draws_than_exist_is_refused():
    traffic = tiny_traffic(16000, 1.0)
    traffic["clips_per_call"]["background"] = traffic["pools"]["background"]["clips"]
    with pytest.raises(ValueError, match="do not exist"):
        corpus.draw_subsets(traffic, 1)
