"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the port; module names are compared whole, by
their top-level part, since the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import ROOT

BENCH = ROOT / "fadbench"
JAX_SIDE = {"jax", "jaxlib", "flax", "frechet_audio_distance_exported_tpu"}
PORT = "frechet_audio_distance_exported_tpu_torch"


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py") if ".cache" not in p.parts]
    assert len(files) > 10
    for path in files:
        assert not imported_tops(path) & JAX_SIDE, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        assert PORT not in imported_tops(path), path
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import fadbench.reference.vggish, fadbench.reference.clap, fadbench.reference.stats\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))") % (
        str(ROOT), JAX_SIDE | {PORT})
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
