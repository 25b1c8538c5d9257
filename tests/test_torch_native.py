"""The port's native host runtime (native/, ops/resample.py) on the CPU.

- The library builds into $FAD_TPU_TORCH_BUILD_DIR (or the package's
  _build/), named by a hash of the source and the flags, and nothing lands
  beside the source; two processes that build it at once into one empty
  directory both load it.
- fad_native.cpp is a verbatim copy of the JAX package's source.
- With the library, the port's resampler is np.array_equal to the JAX
  package's (which takes the same C code); under FAD_TPU_DISABLE_NATIVE=1
  the port's NumPy path stays within the JAX package's bars
  (tests/test_native.py: rtol 1e-6, atol 1e-9).
- pcm_to_f32 and the FLAC residual and predictor paths agree with the
  NumPy ones.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from frechet_audio_distance_exported_tpu.ops import resample as jax_resample  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import native  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import _build, resample  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import audio_io, flac  # noqa: E402

REPO_ROOT = Path(__file__).parent.parent
NATIVE_DIR = REPO_ROOT / "frechet_audio_distance_exported_tpu_torch" / "native"

_BUILD = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    from frechet_audio_distance_exported_tpu_torch import native
    assert native.available(), "the native library did not build"
    print(native.library_path())
    """
).format(repo=str(REPO_ROOT))


@pytest.fixture(scope="module")
def lib_ok():
    if not native.available():
        pytest.skip("native library unavailable (g++ missing?)")
    return True


def _build_in(build_dir: Path, n: int) -> list:
    """n processes that build the library at once into build_dir."""
    env = dict(os.environ, FAD_TPU_TORCH_BUILD_DIR=str(build_dir))
    env.pop("FAD_TPU_DISABLE_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(n)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    return [Path(out.strip()) for out, _ in outs]


def test_builds_into_the_build_dir_only(lib_ok, tmp_path):
    before = sorted(p.name for p in NATIVE_DIR.iterdir())
    (lib,) = _build_in(tmp_path / "cache", 1)
    assert lib.parent == tmp_path / "cache" and lib.is_file()
    assert lib.name.startswith("libfad_native_") and lib.suffix == ".so"
    assert sorted(p.name for p in lib.parent.iterdir()) == [lib.name]
    assert sorted(p.name for p in NATIVE_DIR.iterdir()) == before
    assert not [p for p in NATIVE_DIR.iterdir() if p.suffix == ".so"]


def test_two_processes_build_into_one_empty_directory(lib_ok, tmp_path):
    build_dir = tmp_path / "shared"
    libs = _build_in(build_dir, 2)
    assert libs[0] == libs[1]
    assert sorted(p.name for p in build_dir.iterdir()) == [libs[0].name]  # no temporary left


def test_library_path_follows_the_build_dir_and_the_source(monkeypatch, tmp_path):
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    assert native.library_path().parent == _build.BUILD_DIR
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path))
    name = native.library_path().name
    assert native.library_path().parent == tmp_path
    edited = tmp_path / "fad_native.cpp"
    edited.write_text(native.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", edited)
    assert native.library_path().name != name


def test_the_source_is_a_verbatim_copy():
    ref = REPO_ROOT / "frechet_audio_distance_exported_tpu" / "native" / "fad_native.cpp"
    assert native.SOURCE.read_bytes() == ref.read_bytes()


RATES = [(44100, 16000), (16000, 48000), (44100, 48000), (22050, 16000)]


def _signal(n, seed, dtype=np.float32):
    return (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(dtype)


@pytest.mark.parametrize("sr_orig,sr_new", RATES)
def test_resample_equals_the_jax_package(lib_ok, sr_orig, sr_new):
    x = _signal(sr_orig, sr_new)
    ours = resample.resample(x, sr_orig, sr_new)
    ref = jax_resample.resample(x, sr_orig, sr_new)
    assert ours.dtype == ref.dtype == np.float32
    assert np.array_equal(ours, ref)
    stereo = np.stack([x, x[::-1]], axis=1)
    assert np.array_equal(resample.resample(stereo, sr_orig, sr_new),
                          jax_resample.resample(stereo, sr_orig, sr_new))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("sr_orig,sr_new", RATES)
def test_numpy_fallback_stays_within_the_jax_bars(lib_ok, monkeypatch, sr_orig, sr_new, dtype):
    x = _signal(sr_orig // 2, sr_orig, dtype)
    ref = jax_resample.resample(x, sr_orig, sr_new)  # the C library
    monkeypatch.setenv("FAD_TPU_DISABLE_NATIVE", "1")
    assert not native.available()
    ours = resample.resample(x, sr_orig, sr_new)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    rtol, atol = (1e-6, 1e-9) if dtype == np.float32 else (1e-9, 1e-12)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("channels,mixdown", [(1, False), (2, False), (2, True), (3, True)])
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_pcm_to_f32_agrees_with_numpy(lib_ok, dtype, channels, mixdown):
    info = np.iinfo(dtype)
    rng = np.random.default_rng(channels)
    pcm = rng.integers(info.min, info.max, size=(997, channels), dtype=dtype, endpoint=True)
    pcm[:2] = [[info.min] * channels, [info.max] * channels]
    scale = 32768.0 if dtype == np.int16 else float(2 ** 31)
    ref = pcm.astype(np.float64) / scale
    out = native.pcm_to_f32(pcm, channels, mixdown=mixdown)
    assert out.dtype == np.float32
    if mixdown:
        np.testing.assert_allclose(out, ref.mean(axis=1), atol=1e-6)
    else:
        assert np.array_equal(out.reshape(pcm.shape), (pcm.astype(np.float32) / np.float32(scale)))
    # The WAV decode path takes it: its float32 output is the NumPy division.
    samples = pcm if channels > 1 else pcm[:, 0]
    assert np.array_equal(audio_io._convert_dtype(samples, "float32"),
                          samples.astype(np.float32) / np.float32(scale))


@pytest.mark.parametrize("bits,channels", [(8, 1), (16, 2), (24, 2)])
def test_flac_decode_is_the_same_with_and_without_the_library(lib_ok, monkeypatch, tmp_path,
                                                               bits, channels):
    """The native Rice residuals and FIXED reconstruction against the Python
    bit reader and loops, on a whole file."""
    rng = np.random.default_rng(bits)
    x = np.clip(rng.standard_normal((9000, channels)) * 0.3, -1, 1)
    x[:, 0] += 0.4 * np.sin(np.arange(9000) / 7.0)  # predictable: FIXED orders 1-2
    path = str(tmp_path / "a.flac")
    flac.write_flac(path, np.clip(x, -1, 1), 16000, bits=bits)
    fast = flac.read_flac(path, dtype="int32")
    monkeypatch.setenv("FAD_TPU_DISABLE_NATIVE", "1")
    slow = flac.read_flac(path, dtype="int32")
    assert fast[1] == slow[1] and np.array_equal(fast[0], slow[0])


@pytest.mark.parametrize("order,shift", [(1, 5), (4, 9), (12, 14), (32, 15)])
def test_flac_lpc_reconstruction_agrees_with_the_python_loop(lib_ok, order, shift):
    """A stable predictor (sum |c| < 2**shift / 2, as an encoder's is) over
    random residuals."""
    rng = np.random.default_rng(order)
    bound = (1 << shift) // (2 * order)
    coefs = rng.integers(-bound, bound, size=order, endpoint=True).tolist()
    x = rng.integers(-(1 << 15), 1 << 15, size=600).astype(np.int64)
    ref = x.copy()
    for i in range(order, len(ref)):  # flac.py's fallback (JAX flac.py:256-260)
        acc = 0
        for j in range(order):
            acc += int(coefs[j]) * int(ref[i - 1 - j])
        ref[i] += acc >> shift
    out = x.copy()
    assert native.flac_reconstruct(out, order, coefs=coefs, shift=shift)
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_flac_fixed_reconstruction_agrees_with_the_python_loop(lib_ok, order):
    rng = np.random.default_rng(order)
    x = rng.integers(-300, 300, size=500).astype(np.int64)
    ref = x.copy()
    coefs = flac._FIXED_COEFS[order]
    for i in range(order, len(ref)):
        acc = ref[i]
        for j, c in enumerate(coefs):
            acc += c * ref[i - 1 - j]
        ref[i] = acc
    out = x.copy()
    assert native.flac_reconstruct(out, order)
    assert np.array_equal(out, ref)


def test_disable_switch_turns_every_entry_point_off(monkeypatch):
    monkeypatch.setenv("FAD_TPU_DISABLE_NATIVE", "1")
    x = np.zeros(8, np.int64)
    assert not native.available()
    assert native.pcm_to_f32(np.zeros(4, np.int16), 1, False) is None
    assert native.flac_rice_residuals(b"\x00" * 8, 0, 4, 0) is None
    assert native.flac_reconstruct(x, 1) is False
    assert native.resample_kaiser(np.zeros(4), 0.5, 2, np.zeros(3), np.zeros(3), 1) is None
