"""PyTorch port: package boundaries, device policy and the stream CLI."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parent.parent / "src"


def _run(code: str, *args: str, env_extra=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC), **(env_extra or {}))
    return subprocess.run([sys.executable, *(("-c", code) if code else ()),
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_imports_nothing_of_jax_or_repro():
    import repro_torch
    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert "repro_torch.kernels.ht_probe" in names
    assert "repro_torch.launch.stream" in names
    assert "repro_torch.kernels.csr_segment" in names
    assert "repro_torch.models.gnn" in names
    assert "repro_torch.kernels.flash_attention" in names
    assert "repro_torch.models.transformer" in names
    assert "repro_torch.launch.serve" in names
    assert "repro_torch.dist.labelhash" in names
    assert "repro_torch.dist.router" in names
    assert "repro_torch.launch.serve_summary" in names
    for name in ("checkpoint", "checkpoint.checkpointer", "checkpoint.journal",
                 "checkpoint.summary", "ft", "ft.inject", "ft.resilience",
                 "launch.summarize_stream", "core.reference",
                 "core.reference.algorithms", "core.reference.weights",
                 "testing", "testing.proptest", "launch.quickstart",
                 "kernels.ht_rebuild", "configs.sasrec", "models.sasrec",
                 "optim", "optim.adamw", "train", "train.step",
                 "launch.train", "configs.minicpm3_4b", "dist.annotate",
                 "dist.sharding", "dist.collectives", "launch.mesh",
                 "launch.roofline", "launch.steps", "launch.dryrun"):
        assert f"repro_torch.{name}" in names
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    """``chip_smoke.py`` runs where there is no JAX: every import in it,
    at any depth and in the code it hands to subprocesses, is of torch,
    the port or the standard library and numpy."""
    import ast
    import re
    path = SRC.parent / "chip_smoke.py"
    text = path.read_text()
    names = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert "repro_torch.launch.mesh" in names
    bad = sorted(n for n in names
                 if n.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, bad
    # code in strings (the subprocesses' programs)
    assert not re.findall(r"\b(?:from|import)\s+(?:jax|jaxlib|repro)\b"
                          r"(?!_torch)", text)


def test_summarizer_raises_without_a_card_unless_asked_for_the_cpu():
    code = ("from repro_torch.core.engine import BatchedSummarizer, "
            "EngineConfig\n"
            "cfg = EngineConfig(n_cap=64, m_cap=256)\n"
            "BatchedSummarizer(cfg, device='cpu')\n"
            "try:\n"
            "    BatchedSummarizer(cfg)\n"
            "except RuntimeError as e:\n"
            "    assert \"device='cpu'\" in str(e), e\n"
            "    print('raised')\n")
    proc = _run(code, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "raised"


def test_lm_entry_points_raise_without_a_card_unless_asked_for_the_cpu():
    code = ("from repro_torch.configs import internlm2_20b\n"
            "from repro_torch.launch.serve import serve\n"
            "from repro_torch.models.transformer import init_transformer\n"
            "cfg = internlm2_20b.smoke_config()\n"
            "init_transformer(cfg, 0, device='cpu')\n"
            "serve('internlm2-20b', 1, 2, 1, device='cpu')\n"
            "for fn in (lambda: init_transformer(cfg, 0),\n"
            "           lambda: serve('internlm2-20b', 1, 2, 1)):\n"
            "    try:\n"
            "        fn()\n"
            "    except RuntimeError as e:\n"
            "        assert \"device='cpu'\" in str(e), e\n"
            "        print('raised')\n")
    proc = _run(code, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["raised", "raised"]


def test_recovery_entry_points_raise_without_a_card_unless_asked_for_the_cpu(
        tmp_path):
    code = ("from repro_torch.launch.summarize_stream import main\n"
            "from repro_torch.launch.stream import main as stream\n"
            f"d = {str(tmp_path)!r}\n"
            "for fn in (lambda: main(['40']),\n"
            "           lambda: stream(['--checkpoint-dir', d]),\n"
            "           lambda: stream(['--checkpoint-dir', d, '--engine',\n"
            "                           'sharded', '--resume'])):\n"
            "    try:\n"
            "        fn()\n"
            "    except RuntimeError as e:\n"
            "        assert \"device='cpu'\" in str(e), e\n"
            "        print('raised')\n")
    proc = _run(code, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split().count("raised") == 3


def test_stream_cli_runs_on_the_cpu():
    proc = _run("", "-m", "repro_torch.launch.stream", "--device", "cpu",
                "--nodes", "60", "--deg", "3", "--batch", "16", "--c", "4",
                "--fully-dynamic")
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "stream:" in out and "phi=" in out and "device=cpu" in out


def _cli_numbers(stdout: str) -> tuple:
    """The stream line, the phi line and the trials of a stream CLI run
    (the time on the last line aside)."""
    lines = stdout.strip().splitlines()
    return lines[0], lines[-2], lines[-1].split("  ", 1)[1]


@pytest.mark.parametrize("flags", [
    ("--algo", "mosso"),
    ("--algo", "mosso", "--objective", "weighted", "--weight-levels", "3"),
    ("--algo", "mags", "--c", "12", "--escape", "0.2")])
def test_stream_cli_reference_engine_prints_the_jax_cli_numbers(flags):
    """``--engine reference`` of the port's CLI against the JAX CLI on the
    same flags: the same stream, phi, |E| and trials / accepted line (the
    reference tier runs on the host, with no card and no ``--device``)."""
    args = ("--engine", "reference", "--nodes", "60", "--deg", "3",
            "--fully-dynamic", "--seed", "2", *flags)
    port = _run("", "-m", "repro_torch.launch.stream", *args,
                env_extra={"CUDA_VISIBLE_DEVICES": ""})
    jax = _run("", "-m", "repro.launch.stream", *args,
               env_extra={"JAX_PLATFORMS": "cpu"})
    assert port.returncode == 0, port.stderr
    assert jax.returncode == 0, jax.stderr
    assert _cli_numbers(port.stdout) == _cli_numbers(jax.stdout)
    assert "trials=" in port.stdout and "phi=" in port.stdout
    refused = _run("", "-m", "repro_torch.launch.stream", *args,
                   "--checkpoint-dir", "unused")
    assert refused.returncode == 2
    assert "requires --engine batched or sharded" in refused.stderr


def test_quickstart_prints_the_jax_example_lines():
    """``python -m repro_torch.launch.quickstart`` prints exactly the lines
    of ``examples/quickstart.py`` (same stream, seeds and numbers) and
    imports nothing of JAX or ``repro``."""
    port = _run("import runpy, sys\n"
                "runpy.run_module('repro_torch.launch.quickstart',\n"
                "                 run_name='__main__')\n"
                "bad = [m for m in sys.modules if m == 'jax' or\n"
                "       m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
                "assert not bad, bad\n")
    example = _run("", str(SRC.parent / "examples" / "quickstart.py"))
    assert port.returncode == 0, port.stderr
    assert example.returncode == 0, example.stderr
    assert port.stdout == example.stdout
    assert "lossless" in port.stdout
