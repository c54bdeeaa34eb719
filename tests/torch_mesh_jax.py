"""Helpers of the mesh tests: the JAX package on eight fake host devices.

The test process keeps one JAX device (``tests/conftest.py``), so the JAX
side of a mesh test runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``: :func:`run_jax_8`
hands it the test's inputs (streams built in the test process), runs the
test's code there and returns what that code put in ``OUT``.  The port's
side runs in the test process at ``EngineMesh(["cpu"] * n)``.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

SRC = str(Path(__file__).resolve().parent.parent / "src")

PRELUDE = textwrap.dedent("""
    import pickle
    import jax
    import numpy as np
    assert len(jax.devices()) == 8, jax.devices()


    def leaves(st):
        # a JAX EngineState / InternState as numpy leaves (tables as
        # k1/k2/val dicts), the layout of sharded_state_to_numpy
        out = {}
        for k, v in st._asdict().items():
            if hasattr(v, "k1"):
                out[k] = {w: np.asarray(getattr(v, w))
                          for w in ("k1", "k2", "val")}
            else:
                out[k] = np.asarray(v)
        return out


    def flushed(s):
        s.flush()
        return leaves(s.state), leaves(s.intern)


    with open(IN_PATH, "rb") as f:
        IN = pickle.load(f)
    OUT = {}
""")


def run_jax_8(code: str, inputs: dict, work_dir: Path,
              timeout: int = 600) -> dict:
    """Run ``code`` (after :data:`PRELUDE`: ``IN`` holds ``inputs``) in a
    subprocess with eight fake JAX host devices; returns its ``OUT``."""
    work_dir = Path(work_dir)
    in_path, out_path = work_dir / "jax8_in.pkl", work_dir / "jax8_out.pkl"
    in_path.write_bytes(pickle.dumps(inputs))
    prog = (f"IN_PATH = {str(in_path)!r}\n" + PRELUDE
            + textwrap.dedent(code)
            + f"\nwith open({str(out_path)!r}, 'wb') as f:\n"
              f"    pickle.dump(OUT, f)\n")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                          text=True, env=env, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return pickle.loads(out_path.read_bytes())


def assert_trees_equal(got, want, tag: str) -> None:
    """Two ``(engine, intern)`` numpy leaf trees, leaf for leaf, dtypes
    included."""
    for part, g, w in zip(("engine", "intern"), got, want):
        assert g.keys() == w.keys(), (tag, part)
        for k in w:
            if isinstance(w[k], dict):
                for word in ("k1", "k2", "val"):
                    np.testing.assert_array_equal(
                        g[k][word], w[k][word],
                        err_msg=f"{tag}: {part} {k}.{word}")
            else:
                assert g[k].dtype == w[k].dtype, (tag, part, k)
                np.testing.assert_array_equal(g[k], w[k],
                                              err_msg=f"{tag}: {part} {k}")
