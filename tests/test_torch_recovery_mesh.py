"""PyTorch port: sharded checkpoints across mesh topologies and packages.

``tests/test_recovery.py``'s elastic leg, crossed with the port: the JAX
package writes a checkpoint directory of ``ShardedSummarizer(n_shards=8,
router_chunk=32)`` on eight fake host devices (one subprocess,
``torch_mesh_jax.run_jax_8``), killed at chunk boundary 3 with a save
every 2 chunks, and the final checkpoint of its uninterrupted run.  The
port recovers the killed directory at 1 and at 4 positions
(``EngineMesh(["cpu"] * n)``), continues the stream and lands leaf-bitwise
on JAX's final checkpoint; a directory the port writes at 4 positions is
recovered by JAX on this process's one device and lands there too.  The
manifest records ``n_devices`` and does not pin it.  Tolerance: exact.
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpointer as jax_ckpt  # noqa: E402
from repro.core.engine import ShardedSummarizer as JaxSharded  # noqa: E402
from repro.core.engine.state import EngineConfig as JaxConfig  # noqa: E402
from repro.ft import inject as jax_inject  # noqa: E402
from repro_torch.checkpoint import checkpointer  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.core.engine import ShardedSummarizer  # noqa: E402
from repro_torch.ft import inject  # noqa: E402
from repro_torch.launch.mesh import EngineMesh  # noqa: E402
from test_torch_recovery import CFG, labels_of, make_stream  # noqa: E402
from torch_mesh_jax import run_jax_8  # noqa: E402

N, CHUNK, SHARDS = 160, 32, 8          # tests/test_recovery.py's stream

JAX_CODE = """
from repro.core.engine import EngineConfig, ShardedSummarizer
from repro.ft import inject

cfg = EngineConfig(**IN["cfg"])
s = ShardedSummarizer(cfg, n_shards=IN["shards"], router_chunk=IN["chunk"],
                      checkpoint_dir=IN["killed"])
assert s.router_geometry.n_dev == 8
try:
    inject.drive(s, IN["stream"], ckpt_every=2, kill_at_chunk=3)
except inject.SimulatedCrash:
    pass
full = ShardedSummarizer(cfg, n_shards=IN["shards"],
                         router_chunk=IN["chunk"],
                         checkpoint_dir=IN["full"])
inject.drive(full, IN["stream"])
full.save()
view = full.query()
OUT["reads"] = [view.degree(u) for u in IN["labels"]]
OUT["stats"] = full.stats()
"""


@pytest.fixture(scope="module")
def jax8(tmp_path_factory):
    work = tmp_path_factory.mktemp("jax8_ckpt")
    stream = make_stream(N)
    out = run_jax_8(JAX_CODE, dict(
        cfg=CFG, shards=SHARDS, chunk=CHUNK, stream=stream,
        labels=labels_of(stream), killed=str(work / "killed"),
        full=str(work / "full")), work)
    step = checkpointer.latest_valid_step(str(work / "full"))
    return dict(out, killed=work / "killed", full=str(work / "full"),
                step=step,
                meta=checkpointer.load_meta(str(work / "full"), step))


def port(ckpt_dir, n_dev: int):
    return ShardedSummarizer(EngineConfig(**CFG),
                             mesh=EngineMesh(["cpu"] * n_dev),
                             n_shards=SHARDS, router_chunk=CHUNK,
                             checkpoint_dir=ckpt_dir)


def assert_on_jax_final(summ, jax8, tag: str) -> None:
    """``summ``'s recovery tree leaf-bitwise on JAX's final checkpoint
    (read back by a summarizer of the same package)."""
    summ.flush()
    tree = summ._ckpt_tree()
    if isinstance(summ, ShardedSummarizer):
        got = checkpointer._flatten(tree)
        final = port(str(summ._ckpt_dir) + "_final", 1)
        shutil.copytree(jax8["full"], final._ckpt_dir, dirs_exist_ok=True)
        assert final.restore()["step"] == jax8["step"]
        want = checkpointer._flatten(final._ckpt_tree())
    else:
        got = {k: np.asarray(v) for k, v in
               jax_ckpt._flatten(tree).items()}
        want = {k: np.asarray(v) for k, v in jax_ckpt._flatten(
            jax_ckpt.restore(jax8["full"], jax8["step"], tree)).items()}
    assert sorted(got) == sorted(want), tag
    for k in want:
        assert got[k].dtype == want[k].dtype, (tag, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{tag} {k}")
    assert summ.stream_cursor == jax8["meta"]["extra"]["cursor"], tag


def test_jax_manifest_records_8_devices(jax8):
    manifest = jax8["meta"]["extra"]["manifest"]
    assert manifest["n_devices"] == 8 and manifest["n_shards"] == SHARDS
    assert "n_devices" not in ShardedSummarizer._ckpt_pins()


@pytest.mark.parametrize("n_dev", [1, 4])
def test_jax_8_device_directory_recovered_by_the_port(tmp_path, jax8,
                                                      n_dev):
    d = str(tmp_path / "killed")
    shutil.copytree(jax8["killed"], d)
    rec = port(d, n_dev)
    info = rec.recover()
    assert info["replayed_chunks"] > 0      # the journal crossed topologies
    assert len(rec._est) == n_dev
    stream = make_stream(N)
    inject.drive(rec, stream, start=rec.stream_cursor)
    assert_on_jax_final(rec, jax8, f"JAX at 8 -> port at {n_dev}")
    stats = rec.stats()
    for k in ("phi", "num_edges", "trials", "accepted", "skipped",
              "router_drain_rounds", "router_overflows"):
        assert stats[k] == jax8["stats"][k], k
    view = rec.query()
    assert [view.degree(u) for u in labels_of(stream)] == jax8["reads"]
    # the port's own save records its topology, unpinned
    rec.save()
    meta = checkpointer.load_meta(d, checkpointer.latest_valid_step(d))
    assert meta["extra"]["manifest"]["n_devices"] == n_dev


def test_port_4_position_directory_recovered_by_jax(tmp_path, jax8):
    d = str(tmp_path / "port4")
    stream = make_stream(N)
    with pytest.raises(inject.SimulatedCrash):
        inject.drive(port(d, 4), stream, ckpt_every=2, kill_at_chunk=3)
    meta = checkpointer.load_meta(d, checkpointer.latest_valid_step(d))
    assert meta["extra"]["manifest"]["n_devices"] == 4
    # the directory restores in the port at 2 positions: unpinned
    shutil.copytree(d, tmp_path / "copy")
    back = port(str(tmp_path / "copy"), 2)
    assert back.restore()["epoch"] == 2 and len(back._est) == 2
    rec = JaxSharded(JaxConfig(**CFG), n_shards=SHARDS, router_chunk=CHUNK,
                     trial_backend="xla", checkpoint_dir=d)
    assert rec.mesh.devices.size == 1
    info = rec.recover()
    assert info["replayed_chunks"] > 0
    jax_inject.drive(rec, stream, start=rec.stream_cursor)
    assert_on_jax_final(rec, jax8, "port at 4 -> JAX at 1")
