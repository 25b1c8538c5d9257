"""The port's VGGish log-mel frontend against the JAX package's.

The same numpy inputs go through the JAX frontend (its exact XLA chunk-sum
path, and its Pallas kernel in interpret mode, as the JAX suite runs it on
the CPU) and through the port's plain torch version, which is what the
port's wrapper runs for a CPU tensor. Bound: atol 2e-5, the JAX suite's own
bound between its kernel and its shipped path (test_pallas_frontend.py).

The CUDA kernel itself runs only on the card: its cases skip without one.
What surrounds it is checked here in numpy: the sparse HTK tables it reads,
and a float32 numpy model of its algorithm (csrc/rfft.cuh with the
400-sample window zero-padded to 512, the magnitude, the sparse mel and the
log; the model is the PANN test's) against the plain version.
On a machine with a card, `python -m pytest tests/test_torch_vggish_frontend.py`
runs all of it (tests/conftest.py keeps JAX on the CPU); where jax is not
installed, the JAX comparisons skip and the card's cases still run.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from frechet_audio_distance_exported_tpu_torch.ops import (  # noqa: E402
    _build,
    cuda_frontend,
    dsp,
    launches,
)
from frechet_audio_distance_exported_tpu_torch.ops import frontends as fe  # noqa: E402
from test_torch_pann_frontend import _kernel_model, _kernel_spectrum  # noqa: E402

ATOL = 2e-5
RAGGED_FRAMES = 296  # chip_smoke.py's ragged T


def _wave(bsz, length, seed):
    return (np.random.default_rng(seed).standard_normal((bsz, length)) * 0.1).astype(np.float32)


def _i16(w):
    return np.clip(np.round(w * 32768.0), -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, the JAX frontends module, the JAX Pallas kernel)."""
    jnp = pytest.importorskip("jax.numpy")
    from frechet_audio_distance_exported_tpu.ops import frontends
    from frechet_audio_distance_exported_tpu.ops.pallas_frontend import fused_vggish_logmel

    return jnp, frontends, fused_vggish_logmel


@pytest.fixture
def cuda_device():
    """Decided per test, not at import: every xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("num_frames", [96, 296])
@pytest.mark.parametrize("wire", ["float32", "int16"])
@pytest.mark.parametrize("slack", [512, 240, 0])
def test_logmel_matches_jax(jax_side, num_frames, wire, slack):
    jnp, jax_fe, jax_fused_vggish_logmel = jax_side
    # slack 240 ends the wave exactly at the last frame's end; slack 0 cuts
    # it inside the last frame, so both sides must read zeros past S.
    length = (num_frames - 1) * fe.VGGISH_HOP + fe.VGGISH_WINDOW - 240 + slack
    w = _wave(2, length, seed=num_frames + slack)
    if wire == "int16":
        w = _i16(w)
    w_f32 = w.astype(np.float32) / 32768.0 if wire == "int16" else w

    ours = fe.vggish_logmel_batch(torch.from_numpy(w), num_frames).numpy()
    xla = np.asarray(jax_fe.vggish_logmel_batch(jnp.asarray(w), num_frames, impl="xla"))
    pallas = np.asarray(jax_fused_vggish_logmel(jnp.asarray(w_f32), num_frames, interpret=True))
    assert ours.shape == (2, num_frames, fe.VGGISH_MEL_BINS)
    np.testing.assert_allclose(ours, xla, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=ATOL)


def test_patches_match_committed_golden():
    """The golden was captured once from the reference package; same bound
    as the JAX suite's test_vggish_frontend_matches_committed_golden."""
    golden = np.load(
        os.path.join(os.path.dirname(__file__), "goldens", "vggish_patches_sine440_3s.npy")
    )
    t = np.linspace(0, 3.0, int(16000 * 3.0), dtype=np.float32)
    audio = (np.sin(2 * np.pi * 440.0 * t) * 0.5).astype(np.float32)
    num_patches = fe.vggish_num_patches(len(audio))
    need = fe.VGGISH_WINDOW + (num_patches * fe.VGGISH_PATCH_FRAMES - 1) * fe.VGGISH_HOP
    ours = fe.vggish_patches_batch(torch.from_numpy(audio[:need])[None], num_patches)[0].numpy()
    assert ours.shape == golden.shape
    np.testing.assert_allclose(ours, golden, rtol=1e-3, atol=3e-3)


def test_dequant_i16_is_exact_division():
    q = np.arange(-32768, 32768, dtype=np.int16)
    ours = fe.dequant_i16(torch.from_numpy(q)).numpy()
    assert ours.dtype == np.float32
    assert np.array_equal(ours, q.astype(np.float32) / np.float32(32768.0))
    f = torch.ones(3)
    assert fe.dequant_i16(f) is f


def test_frame_and_patch_counts_match_jax(jax_side):
    jax_fe = jax_side[1]
    for n in (0, 399, 400, 559, 560, 15760, 15761, 160000, 163840):
        assert fe.vggish_num_frames(n) == jax_fe.vggish_num_frames(n)
        assert fe.vggish_num_patches(n) == jax_fe.vggish_num_patches(n)


def test_cpu_tensor_takes_the_plain_version():
    before = launches.read()["fused_vggish_logmel"]
    w = torch.from_numpy(_wave(3, 20000, seed=1))
    out = cuda_frontend.fused_vggish_logmel(w, 96)
    ref = cuda_frontend.fused_vggish_logmel_reference(w, 96)
    assert torch.equal(out, ref)
    assert launches.read()["fused_vggish_logmel"] == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    w = torch.zeros((2, 4000))
    with pytest.raises(TypeError):
        cuda_frontend.fused_vggish_logmel(w.to(torch.int16), 10)
    with pytest.raises(TypeError):
        cuda_frontend.fused_vggish_logmel(w.double(), 10)
    with pytest.raises(ValueError):
        cuda_frontend.fused_vggish_logmel(w[0], 10)
    with pytest.raises(ValueError):
        cuda_frontend.fused_vggish_logmel(w, -1)


def _frames(w, num_frames):
    """[B, num_frames, 400] uncentered frames of w, samples past its end read 0."""
    padded = np.zeros((w.shape[0], (num_frames - 1) * fe.VGGISH_HOP + fe.VGGISH_WINDOW), np.float32)
    n = min(w.shape[1], padded.shape[1])
    padded[:, :n] = w[:, :n]
    idx = np.arange(num_frames)[:, None] * fe.VGGISH_HOP + np.arange(fe.VGGISH_WINDOW)[None, :]
    return padded[:, idx]


def _kernel_tables():
    return [t.numpy() for t in cuda_frontend._kernel_operands(torch.device("cpu"))]


def test_sparse_htk_tables_rebuild_the_mel_matrix():
    """The kernel's (start, count, offset) bands and packed taps give back
    the HTK matrix exactly: 461 taps, none on the DC row. The window is the
    400-sample one of the plain version's DFT matrix; the twiddles are 512."""
    tables = cuda_frontend._kernel_operands(torch.device("cpu"))
    assert all(t.is_contiguous() for t in tables)  # the kernel reads raw row-major pointers
    window, twiddle, bands, taps = (t.numpy() for t in tables)
    assert window.dtype == twiddle.dtype == taps.dtype == np.float32 and bands.dtype == np.int32
    assert window.shape == (fe.VGGISH_WINDOW,) and twiddle.shape == (fe.VGGISH_FFT, 2)
    assert bands.shape == (fe.VGGISH_MEL_BINS, 3)
    mel = cuda_frontend._htk_mel_np()
    rebuilt = np.zeros_like(mel)
    for j, (start, count, offset) in enumerate(bands):
        rebuilt[start : start + count, j] = taps[offset : offset + count]
    assert np.array_equal(rebuilt, mel)
    assert len(taps) == np.count_nonzero(mel) == 461
    assert bands[:, 0].min() >= 1 and bands[:, 1].min() == 1  # DC row untouched; a 1-tap band
    assert np.array_equal(
        window, dsp.windowed_dft_matrices(fe.VGGISH_WINDOW, fe.VGGISH_FFT)[0][:, 0]
    )


@pytest.mark.parametrize("num_frames,length", [
    (96, 96 * fe.VGGISH_HOP + 240),
    (RAGGED_FRAMES, (RAGGED_FRAMES - 1) * fe.VGGISH_HOP + 300),
])
def test_fft_model_of_the_kernel_matches_the_plain_version(num_frames, length):
    """The kernel's algorithm, modelled in float32 numpy over explicit frames
    (the 400-sample window zero-padded to 512, the Stockham stages, the split
    step, the magnitude, the sparse mel and the log), gives the plain
    chunk-sum log-mel within 1e-5 absolute; at the ragged T the wave ends
    inside the last frame, which reads zeros past it."""
    w = _wave(2, length, seed=num_frames)
    window, twiddle, bands, taps = _kernel_tables()
    model = _kernel_model(_frames(w, num_frames), window, twiddle, bands, taps, magnitude=True,
                          out=lambda mel: np.log(mel + np.float32(fe.VGGISH_LOG_OFFSET)))
    ref = cuda_frontend.fused_vggish_logmel_reference(torch.from_numpy(w), num_frames).numpy()
    assert model.shape == ref.shape == (2, num_frames, fe.VGGISH_MEL_BINS)
    np.testing.assert_allclose(model, ref, rtol=0, atol=1e-5)


def test_fft_model_magnitude_is_numpy_rfft():
    """The model's magnitude of the 257 bins is numpy's real FFT of the
    windowed frames zero-padded to 512, within float32 rounding of the
    largest bin."""
    w = _wave(1, 40 * fe.VGGISH_HOP, seed=5)
    window, twiddle, _, _ = _kernel_tables()
    frames = _frames(w, 32)
    ours = _kernel_spectrum(frames, window, twiddle, magnitude=True)
    exact = np.abs(np.fft.rfft(frames.astype(np.float64) * window, n=fe.VGGISH_FFT, axis=-1))
    assert ours.shape == exact.shape == (1, 32, fe.VGGISH_FFT // 2 + 1)
    assert np.abs(ours - exact).max() <= 1e-6 * exact.max()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    first = _build.library_path()
    assert first == _build.library_path()
    (src / "k.cu").write_text("// two\n")
    assert _build.library_path() != first


@pytest.mark.cuda
@pytest.mark.parametrize("num_frames", [960, 296])
def test_kernel_matches_plain_version_on_the_card(cuda_device, num_frames):
    w = torch.from_numpy(_wave(4, (num_frames + 2) * fe.VGGISH_HOP, seed=num_frames))
    w = w.to(cuda_device)
    before = launches.read()["fused_vggish_logmel"]
    out = cuda_frontend.fused_vggish_logmel(w, num_frames)
    torch.cuda.synchronize()
    assert launches.read()["fused_vggish_logmel"] == before + 1
    ref = cuda_frontend.fused_vggish_logmel_reference(w, num_frames)
    # Exact float32 on both sides; only the summation order differs.
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_wrapper_raises_on_a_non_contiguous_card_tensor(cuda_device):
    w = torch.zeros((4, 8000), device=cuda_device)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        cuda_frontend.fused_vggish_logmel(w, 10)
