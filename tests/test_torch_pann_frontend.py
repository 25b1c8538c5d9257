"""The port's PANN log-mel frontend against the JAX package's.

The same numpy inputs go through the JAX frontend (its exact XLA chunk-sum
path, pann_logmel_batch(impl="xla"), and its Pallas kernel in interpret
mode, as the JAX suite runs it on the CPU) and through the port's plain
torch version, which is what the port's wrapper runs for a CPU tensor. All
four geometries of PANN_CONFIGS run, the 48 kHz CLAP one included.

Bound: linear mel power, 10^(dB/10), differs by at most 1e-6 of each file's
largest mel power. A dB bar would fail healthy frontends on quiet bins,
where a different summation order moves a near-cancelling sum by whole
decibels. Masked rows (t >= n_valid[b]) must be exactly 0.

The CUDA kernel runs only on the card: its cases skip without one. What
surrounds it is checked here in numpy: the sparse mel tables it reads, and a
numpy model of its algorithm (csrc/rfft.cuh: the same window, twiddle table,
radix order and split step) against the plain version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from frechet_audio_distance_exported_tpu_torch.ops import cuda_pann_frontend, dsp, launches  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import frontends as fe  # noqa: E402

RATES = sorted(fe.PANN_CONFIGS)  # 8000, 16000, 32000, 48000
POWER_RTOL = 1e-6


def _geometry(sr):
    cfg = fe.PANN_CONFIGS[sr]
    return cfg["window_size"], cfg["hop_size"]


def _case(sr, num_frames, seed):
    """(wave [3, L] float32, n_valid int32 [3]): row 0 valid to the end of a
    wave that stops inside the last frames (they read zeros past L), row 1
    ragged, row 2 batch padding (n_valid 0)."""
    n_fft, hop = _geometry(sr)
    length = (num_frames - 1) * hop + n_fft // 3
    w = (np.random.default_rng(seed).standard_normal((3, length)) * 0.1).astype(np.float32)
    return w, np.array([num_frames, num_frames - 13, 0], np.int32)


def assert_power_close(ours, ref, n_valid, rtol=POWER_RTOL):
    """Unmasked rows: linear power within rtol of each file's max. Masked rows: exactly 0."""
    assert ours.shape == ref.shape
    for b, nv in enumerate(n_valid):
        assert not ours[b, nv:].any(), f"file {b}: rows past n_valid {nv} are not 0"
        if nv == 0:
            continue
        p_ours = 10.0 ** (ours[b, :nv].astype(np.float64) / 10.0)
        p_ref = 10.0 ** (ref[b, :nv].astype(np.float64) / 10.0)
        err = np.abs(p_ours - p_ref).max() / p_ref.max()
        assert err <= rtol, f"file {b}: power error {err:.3e} of the file max > {rtol}"


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, the JAX frontends module, the JAX Pallas kernel)."""
    jnp = pytest.importorskip("jax.numpy")
    from frechet_audio_distance_exported_tpu.ops import frontends
    from frechet_audio_distance_exported_tpu.ops.pallas_frontend import fused_pann_logmel

    return jnp, frontends, fused_pann_logmel


@pytest.fixture
def cuda_device():
    """Decided per test, not at import: every xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("wire", ["float32", "int16"])
@pytest.mark.parametrize("sr", RATES)
def test_logmel_matches_jax(jax_side, sr, wire):
    jnp, jax_fe, jax_fused_pann_logmel = jax_side
    num_frames = 72
    w, n_valid = _case(sr, num_frames, seed=sr // 1000)
    if wire == "int16":
        w = np.clip(np.round(w * 32768.0), -32768, 32767).astype(np.int16)
    w_f32 = w.astype(np.float32) / 32768.0 if wire == "int16" else w

    ours = fe.pann_logmel_batch(
        torch.from_numpy(w), sr, num_frames, torch.from_numpy(n_valid)
    ).numpy()
    xla = np.asarray(
        jax_fe.pann_logmel_batch(jnp.asarray(w), sr, num_frames, jnp.asarray(n_valid), impl="xla")
    )
    pallas = np.asarray(
        jax_fused_pann_logmel(jnp.asarray(w_f32), jnp.asarray(n_valid), sr, num_frames, interpret=True)
    )
    assert ours.shape == (3, num_frames, 64)
    assert np.isfinite(ours).all()
    assert_power_close(ours, xla, n_valid)
    assert_power_close(ours, pallas, n_valid)


def test_frame_arithmetic_matches_jax(jax_side):
    jax_fe = jax_side[1]
    for n in (0, 1, 79, 80, 159, 160, 16000, 160000, 1_000_000):
        for hop in (80, 160, 320, 480):
            assert fe.pann_num_frames(n, hop) == jax_fe.pann_num_frames(n, hop)
    for t in (1, 8, 9, 40, 41, 101, 1001, 1032, 1033, 100001):
        assert fe.pann_valid_time(t) == jax_fe.pann_valid_time(t)
        assert fe.pann_valid_time(t) >= t and (fe.pann_valid_time(t) + 24) % 32 == 0
    x = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
    for sr in RATES:
        n_fft = fe.PANN_CONFIGS[sr]["window_size"]
        assert np.array_equal(fe.reflect_pad_host(x, n_fft), jax_fe.reflect_pad_host(x, n_fft))
    assert fe.PANN_CONFIGS == jax_fe.PANN_CONFIGS


@pytest.mark.parametrize("sr", RATES)
def test_slaney_mel_matrix_is_the_jax_one(sr):
    from frechet_audio_distance_exported_tpu.ops import dsp as jax_dsp

    cfg = fe.PANN_CONFIGS[sr]
    args = (sr, cfg["window_size"], cfg["mel_bins"], cfg["fmin"], cfg["fmax"])
    assert np.array_equal(dsp.slaney_mel_matrix(*args), jax_dsp.slaney_mel_matrix(*args))


def test_dequant_full_scale_is_exact_division():
    q = np.arange(-32768, 32768, dtype=np.int16)
    for scale in (32768.0, 32767.0):
        ours = fe.dequant_i16(torch.from_numpy(q), scale).numpy()
        assert ours.dtype == np.float32
        assert np.array_equal(ours, q.astype(np.float32) / np.float32(scale))


def test_cpu_tensor_takes_the_plain_version():
    before = launches.read()["fused_pann_logmel"]
    w, n_valid = _case(16000, 50, seed=1)
    w, n_valid = torch.from_numpy(w), torch.from_numpy(n_valid)
    out = cuda_pann_frontend.fused_pann_logmel(w, n_valid, 16000, 50)
    ref = cuda_pann_frontend.fused_pann_logmel_reference(w, n_valid, 16000, 50)
    assert torch.equal(out, ref)
    assert launches.read()["fused_pann_logmel"] == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    w = torch.zeros((2, 4000))
    nv = torch.full((2,), 10, dtype=torch.int32)
    fused = cuda_pann_frontend.fused_pann_logmel
    with pytest.raises(TypeError):
        fused(w.to(torch.int16), nv, 16000, 10)
    with pytest.raises(TypeError):
        fused(w.double(), nv, 16000, 10)
    with pytest.raises(ValueError):
        fused(w[0], nv, 16000, 10)
    with pytest.raises(ValueError):
        fused(w, nv, 16000, -1)
    with pytest.raises(ValueError, match="int32"):
        fused(w, nv.long(), 16000, 10)
    with pytest.raises(ValueError, match="int32"):
        fused(w, nv[:1], 16000, 10)
    with pytest.raises(ValueError, match="22050"):
        fused(w, nv, 22050, 10)


def _radices(m):
    """The kernel's stage order for an FFT of m points (csrc/rfft.cuh
    stockham_from): radix 4 while it fits, then one radix 2 if log2 m is odd."""
    out, ns = [], 1
    while ns * 4 <= m:
        out.append(4)
        ns *= 4
    if ns * 2 <= m:
        out.append(2)
    return out


def _kernel_spectrum(frames, window, twiddle, magnitude=False):
    """float32 numpy model of csrc/rfft.cuh over explicit frames [..., W]:
    the window product zero-padded to n_fft = len(twiddle) samples,
    z[n] = x[2n] + i x[2n+1], a Stockham FFT of n_fft/2 points (radix-4
    stages, then radix 2), and the split step to the n_fft/2 + 1 bins of the
    real spectrum: their power, or their magnitude."""
    n_fft = twiddle.shape[0]
    m = n_fft // 2
    tw = (twiddle[:, 0] + 1j * twiddle[:, 1]).astype(np.complex64)
    x = np.zeros(frames.shape[:-1] + (n_fft,), np.float32)
    x[..., : len(window)] = frames[..., : len(window)].astype(np.float32) * window
    z = (x[..., 0::2] + np.complex64(1j) * x[..., 1::2]).astype(np.complex64)
    ns = 1
    for radix in _radices(m):
        j = np.arange(m // radix)
        k = j % ns
        v = [z[..., j + r * (m // radix)] for r in range(radix)]
        if ns > 1:
            v = [v[0]] + [v[r] * tw[2 * k * r * (m // (ns * radix))] for r in range(1, radix)]
        if radix == 4:
            a, b, c, d = v[0] + v[2], v[0] - v[2], v[1] + v[3], v[1] - v[3]
            y = [a + c, b - np.complex64(1j) * d, a - c, b + np.complex64(1j) * d]
        else:
            y = [v[0] + v[1], v[0] - v[1]]
        out = np.empty_like(z)
        dst = (j // ns) * ns * radix + k
        for r in range(radix):
            out[..., dst + r * ns] = y[r]
        z, ns = out, ns * radix
    k = np.arange(m + 1)
    a, c = z[..., k % m], np.conj(z[..., (m - k) % m])
    even = np.float32(0.5) * (a + c)
    odd = np.complex64(-0.5j) * (a - c)
    spectrum = even + tw[k] * odd
    power = (spectrum.real * spectrum.real + spectrum.imag * spectrum.imag).astype(np.float32)
    return np.sqrt(power) if magnitude else power


def _pann_db(mel):
    return 10.0 * np.log10(np.maximum(mel, np.float32(1e-10)))


def _kernel_model(frames, window, twiddle, bands, taps, magnitude=False, out=_pann_db):
    """float32 numpy model of an FFT log-mel kernel (csrc/pann_logmel.cu by
    default; csrc/vggish_logmel.cu with magnitude=True and its log): the
    spectrum of _kernel_spectrum, the sparse mel sum, and the output map."""
    spectrum = _kernel_spectrum(frames, window, twiddle, magnitude)
    mel = np.zeros(spectrum.shape[:-1] + (len(bands),), np.float32)
    for j, (start, count, offset) in enumerate(bands):
        for i in range(count):
            mel[..., j] += spectrum[..., start + i] * taps[offset + i]
    return out(mel)


@pytest.mark.parametrize("sr", RATES)
def test_sparse_mel_tables_rebuild_the_slaney_matrix(sr):
    """The kernel's (start, count, offset) bands and packed taps give back
    dsp.slaney_mel_matrix exactly, with the nonzero tap counts of each rate."""
    n_fft, _ = _geometry(sr)
    tables = cuda_pann_frontend._kernel_operands(sr, torch.device("cpu"))
    assert all(t.is_contiguous() for t in tables)  # the kernel reads raw row-major pointers
    window, twiddle, bands, taps = (t.numpy() for t in tables)
    mel = cuda_pann_frontend._slaney_mel_np(sr)
    assert window.dtype == twiddle.dtype == taps.dtype == np.float32 and bands.dtype == np.int32
    assert window.shape == (n_fft,) and twiddle.shape == (n_fft, 2) and bands.shape == (64, 3)
    rebuilt = np.zeros_like(mel)
    for j, (start, count, offset) in enumerate(bands):
        rebuilt[start : start + count, j] = taps[offset : offset + count]
    assert np.array_equal(rebuilt, mel)
    assert len(taps) == np.count_nonzero(mel) == {8000: 247, 16000: 495, 32000: 866, 48000: 577}[sr]
    # The window is the bin-0 column of the plain version's windowed DFT matrix.
    assert np.array_equal(window, dsp.windowed_dft_matrices(n_fft, n_fft)[0][:, 0])


@pytest.mark.parametrize("sr", RATES)
def test_fft_model_of_the_kernel_matches_the_plain_version(sr):
    """The kernel's algorithm, modelled in float32 numpy over explicit frames
    (samples past L read 0, rows at or past n_valid set to 0), gives the plain
    chunk-sum log-mel within 1e-6 of each file's max power."""
    n_fft, hop = _geometry(sr)
    tables = [t.numpy() for t in cuda_pann_frontend._kernel_operands(sr, torch.device("cpu"))]
    num_frames = 40
    w, n_valid = _case(sr, num_frames, seed=7)
    padded = np.zeros((3, (num_frames - 1) * hop + n_fft), np.float32)
    padded[:, : w.shape[1]] = w
    idx = np.arange(num_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    model = _kernel_model(padded[:, idx], *tables)
    model[np.arange(num_frames)[None, :] >= n_valid[:, None]] = 0.0
    ref = cuda_pann_frontend.fused_pann_logmel_reference(
        torch.from_numpy(w), torch.from_numpy(n_valid), sr, num_frames
    ).numpy()
    assert_power_close(model, ref, n_valid)
    # And the FFT itself is numpy's real FFT of the windowed frames.
    frames = padded[:1, idx[:4]].astype(np.float64) * tables[0]
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = 10.0 * np.log10(np.maximum(power @ cuda_pann_frontend._slaney_mel_np(sr), 1e-10))
    assert_power_close(model[:1, :4], mel, [4])


@pytest.mark.cuda
@pytest.mark.parametrize("sr", RATES)
def test_kernel_matches_plain_version_on_the_card(cuda_device, sr):
    num_frames = 1001 if sr == 48000 else 1032
    w, n_valid = _case(sr, num_frames, seed=3)
    w = torch.from_numpy(w).to(cuda_device)
    n_valid = torch.from_numpy(n_valid).to(cuda_device)
    before = launches.read()["fused_pann_logmel"]
    out = cuda_pann_frontend.fused_pann_logmel(w, n_valid, sr, num_frames)
    torch.cuda.synchronize()
    assert launches.read()["fused_pann_logmel"] == before + 1
    ref = cuda_pann_frontend.fused_pann_logmel_reference(w, n_valid, sr, num_frames)
    # Exact float32 on both sides; only the summation order differs.
    assert_power_close(out.cpu().numpy(), ref.cpu().numpy(), n_valid.cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
def test_wrapper_raises_on_misplaced_card_tensors(cuda_device):
    nv = torch.full((4,), 10, dtype=torch.int32, device=cuda_device)
    w = torch.zeros((4, 8000), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_pann_frontend.fused_pann_logmel(w[:, ::2], nv, 16000, 10)
    with pytest.raises(ValueError, match="n_valid_frames must be on"):
        cuda_pann_frontend.fused_pann_logmel(w, nv.cpu(), 16000, 10)


_FAKE_NVCC = """#!{python}
import pathlib, sys
args = sys.argv[1:]
out = pathlib.Path(args[args.index("-o") + 1])
if "-c" in args:
    src = pathlib.Path(args[-1])
    if "broken" in src.read_text():
        print(f"{{src}}: error: broken source")
        sys.exit(2)
    out.write_text(src.name)
    print(f"ptxas info    : Compiling entry function '{{src.stem}}' for 'sm_90a'")
else:
    assert "-shared" in args
    objs = [pathlib.Path(a) for a in args if a.endswith(".o")]
    out.write_text("+".join(o.read_text() for o in objs))
"""


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """One nvcc -c per csrc/*.cu, then one nvcc -shared over the objects,
    with every command and its output in the build log; a failing source
    raises with its compiler output and leaves no library behind."""
    import sys

    from frechet_audio_distance_exported_tpu_torch.ops import _build

    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// a\n")
    (src / "b.cu").write_text("// b\n")
    monkeypatch.setenv("PATH", str(nvcc.parent))
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build.build()
    assert lib == _build.library_path() and lib.read_text() == "a.cu+b.cu"
    log = lib.with_suffix(".log").read_text()
    assert "entry function 'a'" in log and "entry function 'b'" in log and "-shared" in log
    assert sorted(p.suffix for p in lib.parent.iterdir()) == [".log", ".so"]  # no objects left
    # A header under csrc/ is part of the name: an edit to it rebuilds.
    (src / "c.cuh").write_text("// c\n")
    with_header = _build.library_path()
    assert with_header != lib
    (src / "c.cuh").write_text("// c, edited\n")
    assert _build.library_path() not in (lib, with_header)
    (src / "b.cu").write_text("// broken\n")
    with pytest.raises(RuntimeError, match="broken source"):
        _build.build()
    assert not _build.library_path().exists()
