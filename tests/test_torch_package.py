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
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


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


def test_stream_cli_runs_on_the_cpu():
    proc = _run("", "-m", "repro_torch.launch.stream", "--device", "cpu",
                "--nodes", "60", "--deg", "3", "--batch", "16", "--c", "4",
                "--fully-dynamic")
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "stream:" in out and "phi=" in out and "device=cpu" in out
