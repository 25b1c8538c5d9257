"""The port's mesh across two processes: a two-rank gloo group on localhost.

Modelled on test_distributed.py, which runs the JAX package's sharded
statistics in two processes. The group is spawned once for the module: each
rank runs every check below and writes its results as JSON, and the
parametrised tests read them. Meanwhile this process computes the
unsharded references: the port without a mesh on the same weights and
audio, and the JAX package on one JAX-written VGGish bundle.

What the ranks run (each on the same arguments, as a user's torchrun would):
- the raw sharded statistics of test_distributed.py (8 rows of 16, 4 a rank);
- merge_stats on rows of mean 1e3, each rank's accumulator taken about its
  own shift, the shifts 6 apart;
- FrechetAudioDistance(mesh=...) scores, host path and device_stats, for
  vggish, pann-16k, clap and encodec-24k (the other three names share these
  code paths and would add about 40 s on an 8-core CPU), and get_embeddings of three
  clips at the model's rate;
- VGGish on 1 file and on 3 files (2 ranks), an empty directory, the .npy
  caches, and an error planted on rank 1 only;
- a sha256 of each model's random state dict;
- set_mesh(None): rank 0 alone embeds with no collective.

Bounds: scores equal on both ranks, and within 1e-3 relative of the
unsharded port and of the JAX package; embeddings rtol 1e-4 / atol 1e-5
(test_mesh_pipeline.py:37); statistics at the bars of test_parallel.py.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from frechet_audio_distance_exported_tpu import FrechetAudioDistance as JaxFAD  # noqa: E402
from frechet_audio_distance_exported_tpu.utils.weights import save_weights  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import audio_io  # noqa: E402
from test_torch_vggish_model import vggish_tree  # noqa: E402

REPO_ROOT = Path(__file__).parent.parent
SR = 16000
MODELS = ("vggish", "pann-16k", "clap", "encodec-24k")
GROUP_TIMEOUT_S = 60.0

_CHILD = textwrap.dedent(
    """
    import hashlib, json, sys, time
    rank, port, cfg_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, {repo!r})

    import numpy as np
    import torch

    torch.set_num_threads(2)
    from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance
    from frechet_audio_distance_exported_tpu_torch.ops import stats as st
    from frechet_audio_distance_exported_tpu_torch.parallel import embed
    from frechet_audio_distance_exported_tpu_torch.parallel import mesh as mesh_mod
    from frechet_audio_distance_exported_tpu_torch.utils import audio_io

    cfg = json.load(open(cfg_path))
    mesh_mod.initialize_distributed(
        f"127.0.0.1:{{port}}", 2, rank, device="cpu", timeout_s=cfg["timeout_s"])
    mesh = mesh_mod.data_mesh(device="cpu")
    assert (mesh.rank, mesh.size) == (rank, 2)
    out = {{}}

    # The raw sharded statistics of test_distributed.py.
    rows = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    fn = embed.make_sharded_embed_stats(mesh, lambda r: r)
    mu, sigma = st.finalize_stats(fn(torch.from_numpy(rows[rank * 4:(rank + 1) * 4]),
                                     torch.ones(4)))
    out["raw_stats"] = [mu.tolist(), sigma.tolist()]

    # merge_stats: each rank's accumulator about its own shift, 6 apart.
    big = np.load(cfg["merge_rows"]).astype(np.float32)
    part = torch.from_numpy(big[mesh.share(len(big))])
    shift = part.mean(0) + (3.0 if rank else -3.0)
    local = st.update_stats(st.init_stats(big.shape[1], shift=shift), part,
                            torch.ones(len(part)))
    merged = embed.merge_stats(mesh, local, big.shape[1])
    out["merged"] = [a.tolist() for a in st.finalize_stats_np(merged)]

    for model in cfg["models"]:
        bg, ev = cfg["pair"][model]

        def embeddings():
            sr = fad.sample_rate
            return fad.get_embeddings(
                [audio_io.load_audio(p, sr, 1) for p in cfg["clips"][model]], sr).tolist()

        weights = "auto" if model == "vggish" else "random"
        fad = FrechetAudioDistance(model_name=model, weights=weights, ckpt_dir=cfg["ck"],
                                   device="cpu", mesh=mesh, audio_load_worker=2)
        h = hashlib.sha256()
        for k, v in fad.model.state_dict().items():
            h.update(k.encode())
            h.update(v.detach().cpu().numpy().tobytes())
        out[model] = {{
            "state_sha256": h.hexdigest(),
            "host": fad.score(bg, ev),
            "device_stats": fad.score(bg, ev, device_stats=True),
            "embeddings": embeddings(),
        }}
        if model != "vggish":
            continue
        for name, (b, e) in cfg["dir_pairs"].items():
            out[model][name] = [fad.score(b, e), fad.score(b, e, device_stats=True)]
        out[model]["cached"] = fad.score(bg, ev, cfg["cache"][0], cfg["cache"][1])
        out[model]["from_cache"] = fad.score(cfg["empty"], cfg["empty"], *cfg["cache"])
        real = fad.pipeline.embed_local

        def planted(*args, **kwargs):
            if rank == 1:
                raise RuntimeError("planted on rank 1")
            return real(*args, **kwargs)

        fad.pipeline.embed_local = planted
        for mode in ("host", "device_stats"):
            t0 = time.perf_counter()
            score = fad.score(bg, ev, device_stats=mode == "device_stats")
            out[model]["planted_" + mode] = [score, time.perf_counter() - t0]
        fad.pipeline.embed_local = real
        batching = (fad.pipeline.file_batch, fad.pipeline.patch_chunk)
        fad.pipeline.set_mesh(None)
        assert (fad.pipeline.file_batch, fad.pipeline.patch_chunk) == batching
        if rank == 0:  # alone: a collective here would wait until the timeout
            out[model]["unmeshed"] = embeddings()
        fad.pipeline.set_mesh(mesh)
        out[model]["remeshed"] = embeddings()
    json.dump(out, open(cfg["out"].format(rank=rank), "w"))
    torch.distributed.destroy_process_group()
    print("RANK-OK", rank, flush=True)
    """
).format(repo=str(REPO_ROOT))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_dir(path, clips):
    path.mkdir()
    for i, clip in enumerate(clips):
        audio_io.write_wav(str(path / f"{i}.wav"), clip.astype(np.float32), SR)
    return str(path)


def _state_sha256(model):
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the two ranks, compute the unsharded references meanwhile, and
    return (rank results, references, corpus config)."""
    root = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    t = np.arange(int(SR * 1.5)) / SR
    sines = [0.5 * np.sin(2 * np.pi * (440.0 + 60 * i) * t) for i in range(3)]
    noise = [rng.standard_normal(t.size) * 0.1 for _ in range(3)]
    long_clip = 0.5 * np.sin(2 * np.pi * 330.0 * np.arange(SR * 5) / SR)  # 5 VGGish patches
    (root / "ck").mkdir()
    save_weights(str(root / "ck" / "vggish_tpu.npz"), vggish_tree())
    merge_rows = rng.standard_normal((96, 8)) + 1e3
    np.save(root / "merge_rows.npy", merge_rows)
    bg = _write_dir(root / "bg", sines)
    ev = _write_dir(root / "ev", noise)
    # CLAP and Encodec pad every clip to 10 s: two files a side, one a rank.
    bg2 = _write_dir(root / "bg2", sines[:2])
    ev2 = _write_dir(root / "ev2", noise[:2])
    one = _write_dir(root / "one", [long_clip])
    empty = _write_dir(root / "empty", [])
    pair = {m: (bg2, ev2) if m in ("clap", "encodec-24k") else (bg, ev) for m in MODELS}
    cfg = {
        "pair": pair, "empty": empty, "ck": str(root / "ck"),
        "clips": {m: [os.path.join(b, f) for f in sorted(os.listdir(b))]
                  for m, (b, _) in pair.items()},
        "models": list(MODELS),
        "dir_pairs": {"one_file": (one, ev), "empty_bg": (empty, ev), "empty_ev": (bg, empty)},
        "cache": (str(root / "cache" / "bg.npy"), str(root / "cache" / "ev.npy")),
        "merge_rows": str(root / "merge_rows.npy"),
        "timeout_s": GROUP_TIMEOUT_S,
        "out": str(root / "rank{rank}.json"),
    }
    (root / "cfg.json").write_text(json.dumps(cfg))
    script = root / "child.py"
    script.write_text(_CHILD)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(rank), str(port), str(root / "cfg.json")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=str(REPO_ROOT),
        )
        for rank in (0, 1)
    ]
    try:
        refs = {"merge_rows": merge_rows}
        for model in MODELS:
            weights = "auto" if model == "vggish" else "random"
            fad = FrechetAudioDistance(model_name=model, weights=weights, ckpt_dir=cfg["ck"],
                                       device="cpu", audio_load_worker=2)
            bg, ev = pair[model]
            refs[model] = {
                "state_sha256": _state_sha256(fad.model),
                "host": fad.score(bg, ev),
                "device_stats": fad.score(bg, ev, device_stats=True),
                "embeddings": fad.get_embeddings(
                    [audio_io.load_audio(p, fad.sample_rate, 1) for p in cfg["clips"][model]],
                    fad.sample_rate),
            }
            if model == "vggish":
                for name, (b, e) in cfg["dir_pairs"].items():
                    refs[model][name] = [fad.score(b, e), fad.score(b, e, device_stats=True)]
        bg, ev = pair["vggish"]
        jax_fad = JaxFAD(model_name="vggish", weights="auto", ckpt_dir=cfg["ck"])
        refs["jax_vggish"] = {
            "host": jax_fad.score(bg, ev),
            "device_stats": jax_fad.score(bg, ev, device_stats=True),
        }
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK-OK {rank}" in out, f"rank {rank} failed:\n{out}"
    ranks = [json.loads(Path(cfg["out"].format(rank=r)).read_text()) for r in (0, 1)]
    return ranks, refs, cfg


def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b))


def test_raw_sharded_stats(run):
    ranks, refs, _ = run
    rows = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    for mu, sigma in (r["raw_stats"] for r in ranks):
        np.testing.assert_allclose(mu, rows.mean(0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(sigma, np.cov(rows, rowvar=False), rtol=1e-4, atol=1e-5)


def test_merge_of_far_apart_shifts(run):
    ranks, refs, _ = run
    rows = refs["merge_rows"].astype(np.float32).astype(np.float64)
    for mu, sigma in (r["merged"] for r in ranks):
        np.testing.assert_allclose(mu, rows.mean(0), rtol=0, atol=1e-4)
        np.testing.assert_allclose(sigma, np.cov(rows, rowvar=False), rtol=0, atol=1e-4)
    assert ranks[0]["merged"] == ranks[1]["merged"]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mode", ["host", "device_stats"])
def test_mesh_score_matches_unsharded(run, model, mode):
    ranks, refs, _ = run
    s0, s1 = ranks[0][model][mode], ranks[1][model][mode]
    assert s0 == s1 and s0 != -1 and np.isfinite(s0) and s0 > 0
    assert _rel(s0, refs[model][mode]) <= 1e-3, (s0, refs[model][mode])


@pytest.mark.parametrize("mode", ["host", "device_stats"])
def test_mesh_vggish_score_matches_jax(run, mode):
    ranks, refs, _ = run
    ours, ref = ranks[0]["vggish"][mode], refs["jax_vggish"][mode]
    assert abs(ours - ref) <= 1e-3 and _rel(ours, ref) <= 1e-3, (ours, ref)


@pytest.mark.parametrize("model", MODELS)
def test_mesh_embeddings_in_input_order(run, model):
    ranks, refs, _ = run
    ref = refs[model]["embeddings"]
    for r in ranks:
        got = np.asarray(r[model]["embeddings"], np.float32)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_random_weights_identical_on_both_ranks(run, model):
    ranks, refs, _ = run
    assert ranks[0][model]["state_sha256"] == ranks[1][model]["state_sha256"]
    assert ranks[0][model]["state_sha256"] == refs[model]["state_sha256"]


@pytest.mark.parametrize("pair", ["one_file", "empty_bg", "empty_ev"])
def test_few_files_on_two_ranks(run, pair):
    """1 file on 2 ranks (rank 0 gets none), 3 files (every directory of
    test_mesh_score_matches_unsharded) and an empty directory score as they
    do unsharded: -1 on both ranks for the empty one."""
    ranks, refs, _ = run
    ref_host, ref_ds = refs["vggish"][pair]
    for r in ranks:
        host, ds = r["vggish"][pair]
        if pair.startswith("empty"):
            assert host == ds == ref_host == ref_ds == -1
        else:
            assert _rel(host, ref_host) <= 1e-3 and _rel(ds, ref_ds) <= 1e-3, (host, ds)
    assert ranks[0]["vggish"][pair] == ranks[1]["vggish"][pair]


def test_cache_written_by_rank0_and_read_by_both(run):
    ranks, refs, cfg = run
    for path in cfg["cache"]:
        assert os.path.exists(path)
    for r in ranks:
        assert r["vggish"]["cached"] == r["vggish"]["from_cache"] == ranks[0]["vggish"]["host"]


@pytest.mark.parametrize("mode", ["host", "device_stats"])
def test_error_on_one_rank_gives_the_sentinel_on_both(run, mode):
    ranks, _, _ = run
    for r in ranks:
        score, seconds = r["vggish"]["planted_" + mode]
        assert score == -1
        assert seconds < GROUP_TIMEOUT_S / 2, seconds  # no rank waited for the timeout


def test_set_mesh_none_restores_unsharded_batching(run):
    ranks, refs, _ = run
    got = np.asarray(ranks[0]["vggish"]["unmeshed"], np.float32)
    np.testing.assert_array_equal(got, refs["vggish"]["embeddings"])
    for r in ranks:  # and set_mesh(mesh) shards again
        assert r["vggish"]["remeshed"] == r["vggish"]["embeddings"]
