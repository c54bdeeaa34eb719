"""PyTorch port: the checkpoint format and the chunk journal, against JAX.

The port's ``checkpoint/checkpointer.py`` and ``checkpoint/journal.py``
must write what the JAX package's write, so that either package restores
or replays the other's directory: archive keys, dtypes and shapes of both
summarizer tiers' recovery trees equal ``repro.checkpoint.checkpointer.
_flatten``'s (``step_no`` ``uint32``); journal files byte-identical;
``meta.json`` with the same pins; ``host.pkl`` and journal payloads that
unpickle with no ``torch`` import.  Then the JAX checkpointer's own cases
(``tests/test_ft_checkpoint.py``) on the port's: roundtrip, atomicity,
collision-proof keys, checksums, ``latest_valid_step``; and trees crossing
between the two checkpointers.  Tolerance: exact.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.checkpoint import checkpointer as jax_ckpt  # noqa: E402
from repro.checkpoint.journal import ChunkJournal as JaxJournal  # noqa: E402
from repro.core.engine import BatchedSummarizer as JaxBatched  # noqa: E402
from repro.core.engine import ShardedSummarizer as JaxSharded  # noqa: E402
from repro.core.engine.state import EngineConfig as JaxConfig  # noqa: E402
from repro_torch.checkpoint import checkpointer  # noqa: E402
from repro_torch.checkpoint.journal import ChunkJournal  # noqa: E402
from repro_torch.core.engine import (BatchedSummarizer,  # noqa: E402
                                     EngineConfig, ShardedSummarizer)

CFG = dict(n_cap=160, m_cap=1024, d_cap=48, sn_cap=32, c=8, batch=8,
           escape=0.3)
CHANGES = [(0, 1, True), ("a", "b", True), (2, 3, False), (("t", 1), 5, True)]


def summarizers(tier: str, d=None):
    """The port's and the JAX package's fresh summarizer of one tier."""
    if tier == "batched":
        return (BatchedSummarizer(EngineConfig(**CFG), device="cpu",
                                  checkpoint_dir=d),
                JaxBatched(JaxConfig(**CFG), trial_backend="xla",
                           checkpoint_dir=d and d + "-jax"))
    kw = dict(n_shards=2, router_chunk=32)
    return (ShardedSummarizer(EngineConfig(**CFG), device="cpu",
                              checkpoint_dir=d, **kw),
            JaxSharded(JaxConfig(**CFG), trial_backend="xla",
                       replica_exec="map", checkpoint_dir=d and d + "-jax",
                       **kw))


def assert_flat_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert (a.dtype, a.shape) == (b.dtype, b.shape), k
        np.testing.assert_array_equal(a, b, err_msg=k)


# --------------------------------------------------------------------------- #
# the format
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("tier", ["batched", "sharded"])
def test_archive_keys_dtypes_and_values_equal_jax(tier):
    port, jax_summ = summarizers(tier)
    flat = checkpointer._flatten(port._ckpt_tree())
    want = jax_ckpt._flatten(jax_summ._ckpt_tree())
    assert_flat_equal(flat, want)
    assert flat["est/step_no"].dtype == np.uint32
    assert "est/adj/.k1" in flat and "est/deg" in flat
    if tier == "sharded":
        assert {k for k in flat if k.startswith("ist/")} == {
            "ist/h2l/.k1", "ist/h2l/.k2", "ist/h2l/.val", "ist/l2h",
            "ist/n_dropped", "ist/n_nodes"}
        assert flat["est/phi"].shape == (2,)        # stacked [R, ...]
    # the restore's like-tree flattens to the same keys and shapes
    like = checkpointer._flatten(port._ckpt_like())
    assert sorted(like) == sorted(want)
    assert all(tuple(like[k].shape) == want[k].shape for k in want)


@pytest.mark.parametrize("tier", ["batched", "sharded"])
def test_meta_pins_equal_jax_and_host_pickle_is_framework_free(tier,
                                                               tmp_path):
    d = str(tmp_path / "ck")
    port, jax_summ = summarizers(tier, d)
    port.save()
    jax_summ.save()
    meta = checkpointer.load_meta(d, 0)
    jmeta = jax_ckpt.load_meta(d + "-jax", 0)
    assert sorted(meta["keys"]) == sorted(jmeta["keys"])
    assert meta["format_version"] == jmeta["format_version"]
    assert set(meta["checksums"]) == {"arrays.npz", "host.pkl"}
    extra, jextra = meta["extra"], jmeta["extra"]
    for key in ("closure_version", "epoch", "journal_seq", "cursor"):
        assert extra[key] == jextra[key], key
    for pin in port._ckpt_pins():
        assert extra["manifest"][pin] == jextra["manifest"][pin], pin
    assert set(extra["manifest"]) == set(jextra["manifest"])
    assert extra["manifest"]["trial_backend"] == "plain"
    # host.pkl unpickles in a process that imports neither framework
    path = os.path.join(d, "step_00000000", "host.pkl")
    code = ("import pickle, sys\n"
            f"host = pickle.load(open({path!r}, 'rb'))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro', 'repro_torch')]\n"
            "assert not bad, bad\n"
            "print(sorted(host))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = pickle.loads(jax_ckpt.load_blob(d + "-jax", 0, "host.pkl"))
    assert out.stdout.strip() == str(sorted(want))


def test_journal_bytes_identical_across_packages(tmp_path):
    ours = ChunkJournal(str(tmp_path / "port" / "journal.bin"))
    theirs = JaxJournal(str(tmp_path / "jax" / "journal.bin"))
    for seq in range(4):
        chunk = CHANGES[:seq + 1]
        ours.append(seq, chunk)
        theirs.append(seq, chunk)
    raw = (tmp_path / "port" / "journal.bin").read_bytes()
    assert raw == (tmp_path / "jax" / "journal.bin").read_bytes()
    assert raw[:4] == b"JRN1"
    # each package reads the other's records
    assert ChunkJournal(theirs.path).scan() == theirs.scan()
    assert JaxJournal(ours.path).replay(1) == ours.replay(1)
    ours.truncate(keep_from_seq=2)
    theirs.truncate(keep_from_seq=2)
    assert (tmp_path / "port" / "journal.bin").read_bytes() == \
        (tmp_path / "jax" / "journal.bin").read_bytes()
    # payloads unpickle with no framework imported
    code = ("import pickle, struct, sys\n"
            f"data = open({ours.path!r}, 'rb').read()\n"
            "head = struct.Struct('<4sQII')\n"
            "off, seqs = 0, []\n"
            "while off < len(data):\n"
            "    magic, seq, n, crc = head.unpack_from(data, off)\n"
            "    pickle.loads(data[off + head.size:off + head.size + n])\n"
            "    seqs.append(seq)\n"
            "    off += head.size + n\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'numpy')]\n"
            "print(seqs)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[2, 3]"


def test_journal_replay_dedups_and_refuses_gaps(tmp_path):
    j = ChunkJournal(str(tmp_path / "journal.bin"))
    for seq in (0, 1, 1, 2):
        j.append(seq, [(seq, seq + 1, True)])
    assert [s for s, _ in j.replay(0)] == [0, 1, 2]
    j.append(5, [])
    with pytest.raises(RuntimeError, match="journal gap"):
        j.replay(0)


# --------------------------------------------------------------------------- #
# the JAX checkpointer's cases, on the port's
# --------------------------------------------------------------------------- #


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(2, dtype=torch.int32)}}
    p = checkpointer.save(str(tmp_path), 7, tree, extra={"cursor": 123})
    assert os.path.isdir(p)
    assert checkpointer.latest_step(str(tmp_path)) == 7
    like = {"a": torch.zeros(3, 4),
            "b": {"c": torch.zeros(2, dtype=torch.int32)}}
    back = checkpointer.restore(str(tmp_path), 7, like, device="cpu")
    assert torch.equal(back["a"], tree["a"])
    assert back["b"]["c"].dtype == torch.int32
    assert torch.equal(back["b"]["c"], tree["b"]["c"])
    host = checkpointer.restore(str(tmp_path), 7, like)
    assert isinstance(host["a"], np.ndarray)
    assert checkpointer.load_meta(str(tmp_path), 7)["extra"]["cursor"] == 123
    with pytest.raises(AssertionError, match="shape mismatch at a"):
        checkpointer.restore(str(tmp_path), 7, {"a": torch.zeros(4, 3),
                                                 "b": like["b"]})


def test_checkpoint_atomicity(tmp_path):
    tree = {"w": torch.ones(4)}
    checkpointer.save(str(tmp_path), 1, tree)
    checkpointer.save(str(tmp_path), 2, tree)
    # a stale tmp dir from a crashed writer must be ignored + not corrupt
    os.makedirs(str(tmp_path / "step_00000003.tmp"), exist_ok=True)
    assert checkpointer.latest_step(str(tmp_path)) == 2


def test_flatten_keys_collision_proof(tmp_path):
    # a literal '/' in a dict key must not alias a nesting boundary
    t1 = {"a/b": torch.full((2,), 1.0)}
    t2 = {"a": {"b": torch.full((2,), 2.0)}}
    assert sorted(checkpointer._flatten(t1)) == ["a%2Fb"]
    assert sorted(checkpointer._flatten(t2)) == ["a/b"]
    checkpointer.save(str(tmp_path / "d1"), 0, t1)
    checkpointer.save(str(tmp_path / "d2"), 0, t2)
    b1 = checkpointer.restore(str(tmp_path / "d1"), 0, t1, device="cpu")
    b2 = checkpointer.restore(str(tmp_path / "d2"), 0, t2, device="cpu")
    assert torch.equal(b1["a/b"], t1["a/b"])
    assert torch.equal(b2["a"]["b"], t2["a"]["b"])


def test_checksums_recorded_and_verified(tmp_path):
    d = str(tmp_path)
    checkpointer.save(d, 3, {"w": torch.arange(64.0)},
                      blobs={"host.pkl": b"payload"})
    meta = checkpointer.load_meta(d, 3)
    assert set(meta["checksums"]) == {"arrays.npz", "host.pkl"}
    assert checkpointer.verify(d, 3)
    assert checkpointer.load_blob(d, 3, "host.pkl") == b"payload"
    assert {"savez", "fsync", "sha256", "blobs", "meta"} <= set(
        checkpointer.save_seconds)
    # flip bytes in the payload: verify() must catch what np.load cannot
    path = tmp_path / "step_00000003" / "arrays.npz"
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    assert not checkpointer.verify(d, 3)


def test_latest_valid_step_skips_corrupt_newest(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.ones(8)}
    checkpointer.save(d, 1, tree)
    checkpointer.save(d, 2, tree)
    (tmp_path / "step_00000002" / "meta.json").write_text("{not json")
    assert checkpointer.latest_step(d) == 2          # present...
    assert checkpointer.latest_valid_step(d) == 1    # ...but not trusted
    assert checkpointer.valid_steps(d) == [1]
    checkpointer.delete_step(d, 2)
    assert checkpointer.checkpoint_steps(d) == [1]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trees_cross_between_checkpointers(writer, tmp_path):
    """A tree with dict keys, named-tuple-like fields and sequence indices
    saved by one package's checkpointer restores in the other's."""
    from repro.core.engine.hashtable import HashTable as JaxTable
    from repro_torch.core.engine.hashtable import HashTable
    vals = [np.arange(4, dtype=np.int32) + i for i in range(3)]
    port_tree = {"t": HashTable(*(torch.from_numpy(v) for v in vals)),
                 "s": [torch.tensor(7, dtype=torch.int64)],
                 "u": torch.from_numpy(np.array(5, np.uint32))}
    jax_tree = {"t": JaxTable(*(jnp.asarray(v) for v in vals)),
                "s": [jnp.asarray(7, jnp.int32)],
                "u": jnp.asarray(5, jnp.uint32)}
    assert sorted(checkpointer._flatten(port_tree)) == sorted(
        jax_ckpt._flatten(jax_tree)) == ["s/0", "t/.k1", "t/.k2", "t/.val",
                                         "u"]
    d = str(tmp_path)
    if writer == "port":
        checkpointer.save(d, 1, port_tree)
        back = jax_ckpt.restore(d, 1, jax_tree)
        got = {k: np.asarray(v) for k, v in jax_ckpt._flatten(back).items()}
    else:
        jax_ckpt.save(d, 1, jax_tree)
        back = checkpointer.restore(d, 1, port_tree, device="cpu")
        assert isinstance(back["t"], HashTable)
        got = {k: v.numpy() for k, v in checkpointer._flatten(back).items()}
    assert got["u"] == 5 and got["s/0"] == 7
    for w, v in zip(("k1", "k2", "val"), vals):
        np.testing.assert_array_equal(got[f"t/.{w}"], v)
