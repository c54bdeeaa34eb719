import random
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parent.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

# NOTE: never set xla_force_host_platform_device_count here — smoke tests and
# benches must see 1 device (DESIGN.md / dry-run contract).  Multi-device
# semantics are tested via subprocesses in tests/test_dist.py.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; the test skips without one")


def ground_truth_edges(stream):
    g = set()
    for (u, v, ins) in stream:
        e = (min(u, v), max(u, v))
        if ins:
            g.add(e)
        else:
            g.discard(e)
    return g


@pytest.fixture(scope="session")
def small_fd_stream():
    from repro.graph.streams import edges_to_fully_dynamic_stream, sbm_edges
    edges = sbm_edges(48, 4, 0.6, 0.02, seed=1)
    return edges_to_fully_dynamic_stream(edges, delete_prob=0.2, seed=2)
