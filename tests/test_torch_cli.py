"""The port's command line (python -m frechet_audio_distance_exported_tpu_torch)
on --device cpu: the counterpart of test_cli.py, held to the JAX CLI on one
JAX-written VGGish bundle (FAD within 1e-3, absolute and relative), and run
under a one-rank group in this process and under torchrun with two ranks.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from frechet_audio_distance_exported_tpu.__main__ import main as jax_main  # noqa: E402
from frechet_audio_distance_exported_tpu.utils.weights import save_weights  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.__main__ import main  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils.audio_io import write_wav  # noqa: E402
from test_torch_vggish_model import vggish_tree  # noqa: E402

REPO_ROOT = Path(__file__).parent.parent


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    for d in ("bg", "ev", "empty", "ck"):
        (root / d).mkdir()
    t = np.arange(int(16000 * 1.5)) / 16000
    for i in range(3):
        for d, freq in (("bg", 440.0), ("ev", 880.0)):
            write_wav(str(root / d / f"{i}.wav"), 0.5 * np.sin(2 * np.pi * (freq + 5 * i) * t), 16000)
    save_weights(str(root / "ck" / "vggish_tpu.npz"), vggish_tree())
    return {d: str(root / d) for d in ("bg", "ev", "empty", "ck")}


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def _args(dirs, *extra):
    return [dirs["bg"], dirs["ev"], "--model", "vggish", "--ckpt-dir", dirs["ck"], "--json", *extra]


@pytest.mark.parametrize("device_stats", [False, True])
def test_cli_json_matches_the_jax_cli(dirs, capsys, device_stats):
    extra = ["--device-stats"] if device_stats else []
    assert jax_main(_args(dirs, *extra)) == 0
    ref = _last_json(capsys.readouterr().out)
    assert main(_args(dirs, "--device", "cpu", *extra)) == 0
    rec = _last_json(capsys.readouterr().out)
    assert rec["model"] == "vggish" and np.isfinite(rec["fad"]) and rec["fad"] > 0
    assert abs(rec["fad"] - ref["fad"]) <= 1e-3 * abs(ref["fad"]), (rec, ref)


def test_cli_empty_dir_exit_code(dirs, capsys):
    rc = main([dirs["empty"], dirs["ev"], "--weights", "random", "--ckpt-dir", dirs["ck"],
               "--device", "cpu"])
    assert rc == 1
    assert capsys.readouterr().out.strip().splitlines()[-1] == "FAD (vggish): -1"


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("device_stats", [False, True])
def test_cli_mesh_of_one_rank(dirs, capsys, monkeypatch, device_stats):
    """--mesh from torchrun's environment, here a one-rank group that the CLI
    starts and ends itself; the score is the unsharded one."""
    import torch.distributed as dist

    for key, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(_free_port())),
                       ("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(key, value)
    extra = ["--device-stats"] if device_stats else []
    assert main(_args(dirs, "--device", "cpu", *extra)) == 0
    ref = _last_json(capsys.readouterr().out)
    assert main(_args(dirs, "--device", "cpu", "--mesh", *extra)) == 0
    rec = _last_json(capsys.readouterr().out)
    assert not dist.is_initialized()
    assert abs(rec["fad"] - ref["fad"]) <= 1e-6 * abs(ref["fad"]), (rec, ref)


def test_cli_under_torchrun_with_two_ranks(dirs):
    """Two processes on the CPU: only rank 0 prints the JSON record."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(REPO_ROOT))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-port", str(_free_port()), "-m", "frechet_audio_distance_exported_tpu_torch",
         *_args(dirs, "--device", "cpu", "--mesh")],
        capture_output=True, text=True, timeout=300, cwd=str(REPO_ROOT), env=env,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    records = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]
    assert len(records) == 1 and records[0]["fad"] > 0, r.stdout
