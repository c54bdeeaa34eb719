"""PyTorch port: the crash-consistent stream CLI, against the JAX CLI.

``python -m repro_torch.launch.stream --checkpoint-dir DIR`` on both
engines (``--device cpu``) prints the JAX CLI's final ``stats()`` at the
same flags (the JAX CLI runs in this process through ``runpy``, so its
engine compiles once); then each CLI ``--resume``s the other's directory
after its newest checkpoint was corrupted, falls back one epoch, replays
the journal tail, and prints the same stats again.  Tolerance: exact.
"""
import ast
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import checkpointer  # noqa: E402
from repro_torch.ft import inject  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
FLAGS = ["--nodes", "40", "--deg", "3", "--batch", "16", "--c", "4",
         "--router-chunk", "32", "--fully-dynamic", "--checkpoint-every",
         "2"]


def final_stats(out: str) -> dict:
    line = out.strip().splitlines()[-1]
    return ast.literal_eval(line[line.index("{"):])


def port_cli(*args: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.stream",
                           "--device", "cpu", *args], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "device=cpu" in proc.stdout
    return final_stats(proc.stdout)


def jax_cli(monkeypatch, capsys, *args: str) -> dict:
    monkeypatch.setattr(sys, "argv", ["repro.launch.stream", *args])
    runpy.run_module("repro.launch.stream", run_name="__main__")
    return final_stats(capsys.readouterr().out)


def corrupt_newest(d: str) -> None:
    steps = checkpointer.checkpoint_steps(d)
    assert len(steps) == 2                  # KEEP_EPOCHS
    inject.corrupt_checkpoint_arrays(d, steps[-1])


@pytest.mark.parametrize("engine", ["batched", "sharded"])
def test_stream_cli_checkpoint_resume_gives_the_jax_cli_stats(
        engine, tmp_path, monkeypatch, capsys):
    flags = ["--engine", engine, *FLAGS]
    if engine == "sharded":
        flags += ["--shards", "2"]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jax_cli(monkeypatch, capsys, *flags, "--checkpoint-dir", jdir)
    assert want["stream_retries"] == 0 and want["trials"] > 0
    assert port_cli(*flags, "--checkpoint-dir", pdir) == want
    # each CLI resumes the other's directory from the previous epoch
    corrupt_newest(jdir)
    assert port_cli(*flags, "--checkpoint-dir", jdir, "--resume") == want
    corrupt_newest(pdir)
    assert jax_cli(monkeypatch, capsys, *flags, "--checkpoint-dir", pdir,
                   "--resume") == want
