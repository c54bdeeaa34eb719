"""Build and load the port's CUDA sources (``csrc/*.cu``) with ``nvcc``.

Each source compiles on its own into a shared library with a plain C
interface, ``build/<stem>_<hash>.so`` at the repository root, named by the
hash of the source and of every header (``*.cuh``) beside it, so that an
edited source or header rebuilds and an unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per source, all at once,
and waits for them together.  Libraries are loaded with ``ctypes``.

Nothing here runs at import time: the CPU tests import the kernel modules,
and there is no ``nvcc`` on a machine without the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[Path, ctypes.CDLL] = {}


def library_path(source: Path) -> Path:
    """Where this source's build goes: its name carries the hash of the
    source and of every ``*.cuh`` header in its directory (any of which
    it may include)."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")


def build_all(sources: Sequence[Path]) -> Dict[Path, Tuple[Path, str]]:
    """Compile every source whose build is missing, one ``nvcc`` each, all
    started together.  Returns ``{source: (library, nvcc output)}``; the
    output holds registers and spills (``-Xptxas -v``) and is empty for a
    build that already existed.  Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: Dict[Path, Tuple[Path, str]] = {}
    running = []
    for src in sources:
        out = library_path(src)
        if out.exists():
            done[src] = (out, "")
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in running:
        try:
            text, _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, out)   # atomic: a concurrent build cannot tear it
                done[src] = (out, text)
            else:
                failed.append(f"nvcc {src.name} failed ({proc.returncode}):"
                              f"\n{text}")
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(source: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build (at first use) and load one source's library; ``bind`` sets
    the ``argtypes``/``restype`` of its entry points once."""
    lib = _LOADED.get(source)
    if lib is None:
        path, _ = build_all([source])[source]
        lib = ctypes.CDLL(str(path))
        bind(lib)
        _LOADED[source] = lib
    return lib
