"""The port's packaging and API surface, on the CPU:
- every header a CUDA source includes is shipped by pyproject.toml's
  package data, so an installed wheel can build the kernels;
- the native host library's C++ source is shipped too;
- the kernels' build directory follows FAD_TPU_TORCH_BUILD_DIR (the
  counterpart of the JAX package's FAD_TPU_NATIVE_DIR), else the package's
  _build/;
- the registry tables that the JAX package's fad module re-exports are in
  the port's fad module, equal to the JAX ones.
"""

import fnmatch
import re
import sys
import tomllib
from pathlib import Path

import pytest

pytest.importorskip("torch")

from frechet_audio_distance_exported_tpu import fad as jax_fad  # noqa: E402
from frechet_audio_distance_exported_tpu import registry as jax_registry  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import fad, registry  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.ops import _build  # noqa: E402
from test_torch_pann_frontend import _FAKE_NVCC  # noqa: E402

REPO_ROOT = Path(__file__).parent.parent
PACKAGE = "frechet_audio_distance_exported_tpu_torch"


def _package_data_globs(package=PACKAGE):
    with open(REPO_ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"][package]


def test_every_included_file_is_shipped():
    """Each #include "..." of a csrc/ source or header names a file in csrc/
    that a package-data glob ships; the sources are shipped too."""
    globs = _package_data_globs()
    csrc = _build.CSRC_DIR
    sources = sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")])
    assert any(p.suffix == ".cuh" for p in sources)

    def shipped(path):
        rel = path.relative_to(_build.PACKAGE_DIR).as_posix()
        return any(fnmatch.fnmatch(rel, g) for g in globs)

    includes = 0
    for src in sources:
        assert shipped(src), f"{src.name} is not in the package data {globs}"
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', src.read_text(), re.M):
            target = csrc / name
            assert target.is_file(), f'{src.name} includes "{name}", which is not in csrc/'
            assert shipped(target), f'{src.name} includes "{name}", which is not shipped: {globs}'
            includes += 1
    assert includes >= 2  # vggish_logmel.cu and pann_logmel.cu include rfft.cuh


def test_the_native_source_is_shipped():
    """The host library's C++ source ships with the port's native package,
    so an installed wheel builds it on first use."""
    from frechet_audio_distance_exported_tpu_torch import native

    globs = _package_data_globs(f"{PACKAGE}.native")
    assert native.SOURCE.is_file()
    assert any(fnmatch.fnmatch(native.SOURCE.name, g) for g in globs), globs


def test_build_dir_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    assert _build.build_dir() == _build.BUILD_DIR == _build.PACKAGE_DIR / "_build"
    assert _build.library_path().parent == _build.BUILD_DIR
    monkeypatch.setenv(_build.BUILD_DIR_ENV, "")
    assert _build.build_dir() == _build.BUILD_DIR
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "cache"))
    assert _build.BUILD_DIR_ENV == "FAD_TPU_TORCH_BUILD_DIR"
    lib = _build.library_path()
    assert lib.parent == tmp_path / "cache"
    assert re.fullmatch(r"libfad_kernels_[0-9a-f]{16}\.so", lib.name)  # the same hash scheme
    monkeypatch.delenv(_build.BUILD_DIR_ENV)
    assert _build.library_path().name == lib.name


def test_build_writes_into_the_override_only(monkeypatch, tmp_path):
    """build() with the override set: the library, its log and nothing else
    land there (a fake nvcc stands in for the compiler), and the package's
    own _build/ is not touched."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "h.cuh"\n')
    (src / "h.cuh").write_text("// h\n")
    fallback = tmp_path / "package_build"
    monkeypatch.setenv("PATH", str(nvcc.parent))
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", fallback)
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "user" / "cache"))
    lib = _build.build()
    assert lib.parent == tmp_path / "user" / "cache" and lib.read_text() == "a.cu"
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted([lib.name, lib.stem + ".log"])
    assert not fallback.exists()
    assert _build.build() == lib  # found, not rebuilt


# The model the port runs and the JAX package does not.
PORT_ONLY = ("wavlm-large",)


@pytest.mark.parametrize("table", ["VALID_MODELS", "PANN_SAMPLE_RATES", "ENCODEC_SAMPLE_RATES"])
def test_fad_reexports_the_registry_tables(table):
    """The JAX package's tables, and in VALID_MODELS the port's own model after them."""
    ours = getattr(fad, table)
    assert ours is getattr(registry, table)
    if table == "VALID_MODELS":
        assert list(ours)[len(jax_registry.VALID_MODELS):] == list(PORT_ONLY)
        ours = {k: v for k, v in ours.items() if k not in PORT_ONLY}
    assert ours == getattr(jax_fad, table) == getattr(jax_registry, table)


def test_registry_copies_match_jax():
    assert registry.WEIGHT_FILENAMES == jax_registry.WEIGHT_FILENAMES
    assert registry.PORTED_MODELS == tuple(registry.VALID_MODELS)
    for name in registry.VALID_MODELS:
        ours = registry.get_model_config(name)
        if name in PORT_ONLY:
            # No bundle or artifact: random weights only.
            assert (ours.family, ours.weight_filename, ours.reference_artifact) == ("wavlm", "", "")
            continue
        ref = jax_registry.get_model_config(name)
        assert (ours.family, ours.sample_rate, ours.embedding_dim) == (
            ref.family, ref.sample_rate, ref.embedding_dim)
