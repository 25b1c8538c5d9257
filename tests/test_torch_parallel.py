"""The port's sharded statistics and scoring step in a one-rank gloo group,
in this process: the counterpart of test_parallel.py, which runs the JAX
package's on the virtual 8-device mesh.

Bars: the sharded statistics equal single-device ones with μ at 1e-5 and Σ
at 1e-4 (test_parallel.py:40-42); the score step within 1e-3 relative of the
host float64 route, for a linear model with O(1) outputs and for the real
VGGish scaled x300 inside the step (random-weight VGGish embeddings are
about 1e-3, which puts the raw FAD below float32 resolution). The merge of
streamed accumulators taken about different shifts (parallel.embed.
merge_stats, whose algebra is ops/stats.recenter_stats) holds Σ within 1e-4
of float64 np.cov on rows of mean 1e3 and sd 1; a shift-free float32 sum of
the same rows does not.
"""

import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.distributed as dist  # noqa: E402

from frechet_audio_distance_exported_tpu.ops import stats as jax_stats  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.models.vggish import VGGish  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import stats as st  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.parallel import embed  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import weights  # noqa: E402


@pytest.fixture(scope="module")
def mesh():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    mesh_mod.initialize_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu", timeout_s=60)
    try:
        yield mesh_mod.data_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def vggish():
    with torch.device("meta"):
        model = VGGish()
    model.load_state_dict(weights.init_random_params("vggish", 0), assign=True)
    return model.eval()


def test_data_mesh_of_one_rank(mesh):
    assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cpu"))
    assert mesh.share(5) == slice(0, 5)
    assert [mesh_mod.pad_to_shards(n, 3) for n in (1, 3, 4)] == [3, 3, 6]
    assert mesh.from_rank0(lambda: "rank 0") == "rank 0"
    assert mesh.gather(lambda: [1, 2]) == [1, 2]
    with pytest.raises(RuntimeError, match="planted"):
        mesh.agree(lambda: (_ for _ in ()).throw(RuntimeError("planted")))


@pytest.mark.parametrize("n, size", [(1, 2), (3, 2), (7, 3), (0, 4)])
def test_shares_cover_every_item_once_in_order(n, size):
    blocks = [mesh_mod.DataMesh(None, r, size, torch.device("cpu")).share(n)
              for r in range(size)]
    assert [i for b in blocks for i in range(n)[b]] == list(range(n))


def test_sharded_stats_match_single_device(mesh, vggish):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((16, 96, 64)).astype(np.float32))
    mask = torch.ones(16)
    mask[-3:] = 0.0
    state = embed.make_sharded_embed_stats(mesh, vggish)(x, mask)
    mu_sh, sig_sh = st.finalize_stats(state)
    with torch.inference_mode():
        emb = vggish(x)
    single = st.update_stats(st.init_stats(128), emb, mask)
    mu_1, sig_1 = st.finalize_stats(single)
    assert float(state.n) == float(single.n) == 13.0
    np.testing.assert_allclose(mu_sh.numpy(), mu_1.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sig_sh.numpy(), sig_1.numpy(), rtol=1e-4, atol=1e-5)


def _host_fad(e1, e2):
    e1, e2 = (np.asarray(e, np.float64) for e in (e1, e2))
    return jax_stats.frechet_distance_np(
        e1.mean(0), np.cov(e1, rowvar=False), e2.mean(0), np.cov(e2, rowvar=False)
    )


def test_score_step_linear_model_matches_host(mesh):
    rng = np.random.default_rng(2)
    b, d_in, d_out = 256, 24, 16
    w = torch.from_numpy((rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32))
    rows_bg = torch.from_numpy(rng.standard_normal((b, d_in)).astype(np.float32))
    rows_ev = torch.from_numpy((rng.standard_normal((b, d_in)) * 1.2 + 0.3).astype(np.float32))
    ones = torch.ones(b)
    step = embed.make_sharded_score_step(mesh, lambda x: x @ w)
    fused = float(step(rows_bg, ones, rows_ev, ones))
    ref = _host_fad(rows_bg @ w, rows_ev @ w)
    assert ref > 0.1
    assert abs(fused - ref) / ref < 1e-3, (fused, ref)


def test_score_step_real_vggish_matches_host(mesh, vggish):
    rng = np.random.default_rng(3)
    b = 32

    def scaled(x):
        return vggish(x) * 300.0

    rows_bg = torch.from_numpy(rng.standard_normal((b, 96, 64)).astype(np.float32))
    rows_ev = torch.from_numpy((rng.standard_normal((b, 96, 64)) * 1.5 + 0.4).astype(np.float32))
    mask_ev = torch.ones(b)
    mask_ev[-2:] = 0.0  # masked rows drop out
    step = embed.make_sharded_score_step(mesh, scaled)
    fused = float(step(rows_bg, torch.ones(b), rows_ev, mask_ev))
    with torch.inference_mode():
        ref = _host_fad(scaled(rows_bg), scaled(rows_ev)[:-2])
    assert ref > 0.1
    assert abs(fused - ref) / ref < 1e-3, (fused, ref)


def test_mask_over_output_rows(mesh):
    """A per-file mask masks every row a file's input makes ([B] over [B, P, d])."""
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    state = embed.make_sharded_embed_stats(mesh, lambda r: r)(x, torch.tensor([1.0, 0.0]))
    mu, _ = st.finalize_stats(state)
    assert float(state.n) == 3.0
    np.testing.assert_allclose(mu.numpy(), x[0].mean(0).numpy(), rtol=1e-6)


def _rows_and_states(shift_free: bool):
    """Rows of mean 1e3, sd 1, in two blocks, and each block's float32
    accumulator: about its own shift (1.5 and -1.5 away from its mean, so the
    two shifts lie 3 apart) or, shift_free, about 0."""
    rows = (np.random.default_rng(4).standard_normal((400, 6)) + 1e3).astype(np.float32)
    states = []
    for k, block in enumerate((rows[:150], rows[150:])):
        x = torch.from_numpy(block)
        shift = torch.zeros(6) if shift_free else x.mean(0) + (1.5 if k else -1.5)
        states.append(st.update_stats(st.init_stats(6, shift=shift), x, torch.ones(len(x))))
    return rows.astype(np.float64), states


def _sigma_error(rows, sigma):
    return float(np.abs(np.asarray(sigma) - np.cov(rows, rowvar=False)).max())


def test_merge_recentres_far_apart_shifts():
    """merge_stats' algebra on two ranks' accumulators: all-reduce n and
    n·shift + s, re-centre each at the global mean, sum."""
    rows, states = _rows_and_states(shift_free=False)
    n = sum(float(s.n) for s in states)
    mu = sum(s.n.double() * s.shift.double() + s.s.double() for s in states) / n
    parts = [st.recenter_stats(s, mu) for s in states]
    merged = st.StreamingStats(n=sum(p.n for p in parts), s=sum(p.s for p in parts),
                               ss=sum(p.ss for p in parts), shift=mu)
    mu_m, sigma_m = st.finalize_stats_np(merged)
    np.testing.assert_allclose(mu_m, rows.mean(0), rtol=0, atol=1e-4)
    assert _sigma_error(rows, sigma_m) <= 1e-4


@pytest.mark.parametrize("naive", ["shift_free_float32", "shifted_sums_added_as_they_are"])
def test_naive_merges_fail_the_same_check(naive):
    rows, states = _rows_and_states(shift_free=naive == "shift_free_float32")
    summed = st.StreamingStats(
        n=states[0].n + states[1].n, s=states[0].s + states[1].s,
        ss=states[0].ss + states[1].ss, shift=states[0].shift,
    )
    _, sigma = st.finalize_stats_np(summed)
    assert _sigma_error(rows, sigma) > 1e-4


def test_merge_stats_on_one_rank(mesh):
    rows, states = _rows_and_states(shift_free=False)
    merged = embed.merge_stats(mesh, states[1], 6)
    assert merged.ss.dtype == torch.float64 and float(merged.n) == 250.0
    mu, sigma = st.finalize_stats_np(merged)
    np.testing.assert_allclose(mu, rows[150:].mean(0), rtol=0, atol=1e-4)
    assert _sigma_error(rows[150:], sigma) <= 1e-4
    assert embed.merge_stats(mesh, None, 6) is None  # no rank had a row


def test_a_card_mesh_without_cuda_raises_before_joining(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh_mod.initialize_distributed("127.0.0.1:1", 2, 0, device="cuda")
    assert not dist.is_initialized() or dist.get_world_size() == 1
