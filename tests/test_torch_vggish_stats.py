"""The port's streaming statistics and Fréchet epilogues against the JAX package's.

The accumulator runs in float32 on both sides with different summation
orders: (mu, sigma) agree to rtol 1e-5 / atol 1e-6 at these sizes. The host
epilogues are copies of the JAX numpy code and must agree to float64
rounding (rtol 1e-12).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from frechet_audio_distance_exported_tpu.ops import stats as jax_stats  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import stats  # noqa: E402


def _chunk(rng, b, p, d, live):
    """[b, p, d] rows around a non-zero mean, a mask keeping the first
    live[i] patches of file i, and a NaN in a masked-out row."""
    x = (rng.standard_normal((b, p, d)) * 0.3 + 2.0).astype(np.float32)
    mask = (np.arange(p)[None, :] < np.asarray(live)[:, None]).astype(np.float32)
    x[-1, -1, 0] = np.nan
    assert mask[-1, -1] == 0
    return x, mask


def test_streaming_stats_match_jax_and_float64_truth():
    rng = np.random.default_rng(0)
    (x1, m1), (x2, m2) = _chunk(rng, 4, 5, 16, [5, 3, 0, 2]), _chunk(rng, 2, 5, 16, [4, 1])

    st = stats.init_update_stats(torch.from_numpy(x1), torch.from_numpy(m1))
    st = stats.update_stats(st, torch.from_numpy(x2), torch.from_numpy(m2))
    jst = jax_stats.init_update_stats(jnp.asarray(x1), jnp.asarray(m1))
    jst = jax_stats.update_stats(jst, jnp.asarray(x2), jnp.asarray(m2))

    assert float(st.n) == float(jst.n) == m1.sum() + m2.sum()
    np.testing.assert_allclose(st.shift.numpy(), np.asarray(jst.shift), rtol=1e-6, atol=1e-6)
    mu, sigma = stats.finalize_stats_np(st)
    jmu, jsigma = jax_stats.finalize_stats_np(jst)
    assert np.isfinite(sigma).all()
    np.testing.assert_allclose(mu, jmu, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sigma, jsigma, rtol=1e-5, atol=1e-6)

    rows = np.concatenate([x1[m1 > 0], x2[m2 > 0]]).astype(np.float64)
    np.testing.assert_allclose(mu, rows.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sigma, np.cov(rows, rowvar=False), rtol=1e-4, atol=1e-6)


def test_first_chunk_shift_is_the_masked_mean():
    rng = np.random.default_rng(1)
    x, m = _chunk(rng, 3, 4, 8, [4, 2, 1])
    st = stats.init_update_stats(torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_allclose(st.shift.numpy(), x[m > 0].mean(0), rtol=1e-6)
    np.testing.assert_allclose(st.s.numpy(), 0.0, atol=1e-5)


def _gaussians(rng, d=12, n=40):
    a = rng.standard_normal((n, d))
    b = rng.standard_normal((n + 7, d)) * 1.3 + 0.2
    return a, b


@pytest.mark.parametrize(
    "name", ["frechet_distance_np", "frechet_distance_eigh_np", "calculate_embd_statistics_np"]
)
def test_host_epilogues_are_the_jax_ones(name):
    a, b = _gaussians(np.random.default_rng(2))
    if name == "calculate_embd_statistics_np":
        for got, want in zip(getattr(stats, name)(a), getattr(jax_stats, name)(a)):
            np.testing.assert_allclose(got, want, rtol=1e-12)
        return
    args = (*jax_stats.calculate_embd_statistics_np(a), *jax_stats.calculate_embd_statistics_np(b))
    np.testing.assert_allclose(getattr(stats, name)(*args), getattr(jax_stats, name)(*args), rtol=1e-12)


def test_lowrank_epilogue_is_the_jax_one_and_exact():
    a, b = _gaussians(np.random.default_rng(3), d=64, n=20)  # fewer rows than dims
    got = stats.frechet_distance_lowrank_np(a, b)
    np.testing.assert_allclose(got, jax_stats.frechet_distance_lowrank_np(a, b), rtol=1e-12)
    full = stats.frechet_distance_eigh_np(
        *stats.calculate_embd_statistics_np(a), *stats.calculate_embd_statistics_np(b)
    )
    np.testing.assert_allclose(got, full, rtol=1e-7)


def test_scipy_and_eigh_routes_agree():
    a, b = _gaussians(np.random.default_rng(4))
    args = (*stats.calculate_embd_statistics_np(a), *stats.calculate_embd_statistics_np(b))
    np.testing.assert_allclose(
        stats.frechet_distance_np(*args), stats.frechet_distance_eigh_np(*args), rtol=1e-7
    )
    with pytest.raises(ValueError, match="different lengths"):
        stats.frechet_distance_np(args[0], args[1], args[2][:-1], args[3])
