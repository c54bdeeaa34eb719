"""PyTorch port: hash tables, the probe kernel's plain version and the
integer/PRNG primitives, bitwise against the JAX package.

The JAX side runs as ``tests/test_kernels.py`` runs it: the Pallas probe
kernel in interpret mode (``jax.vmap`` of it for the stacked form).
Inputs are made with numpy from a seed and handed to both packages.
Tolerance: exact (integer and float32 bits).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.engine import hashtable as jht  # noqa: E402
from repro.core.engine import ops as jops  # noqa: E402
from repro.core.engine.state import EngineConfig as JaxConfig  # noqa: E402
from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels.ht_probe import ht_probe_batch  # noqa: E402
from repro_torch.core.engine import hashtable as tht  # noqa: E402
from repro_torch.core.engine import ops as tops  # noqa: E402
from repro_torch.core.engine.state import EngineConfig  # noqa: E402
from repro_torch.core.summary import host_node_weight  # noqa: E402
from repro_torch.kernels import ht_probe as tprobe  # noqa: E402
from repro_torch.kernels import ops as tkops  # noqa: E402

_jset = jax.jit(jht.ht_set, static_argnames=("prehashed",))
_jdel = jax.jit(jht.ht_delete)
_jadd = jax.jit(jht.ht_add, static_argnames=("remove_if_zero",))
_jlookup = jax.jit(jht.ht_lookup)


def _t(x):
    return torch.from_numpy(np.array(x, np.int32))


def _jax_table(cap, n_live, n_tomb, seed, key_space=2000):
    """A JAX table at a given load with tombstoned chains mixed in, built
    as tests/test_kernels.py builds its tables."""
    rng = np.random.default_rng(seed)
    ht = jht.ht_new(cap)
    keys = rng.integers(0, key_space, size=(n_live + n_tomb, 2))
    keys = np.unique(keys.astype(np.int32), axis=0)
    for i, (a, b) in enumerate(keys):
        ht = _jset(ht, int(a), int(b), i + 1)
    for (a, b) in keys[n_live:]:
        ht = _jdel(ht, int(a), int(b))
    return ht, keys[:n_live]


def _probe_both(ht, q, prehashed, mode):
    got = tprobe.ht_probe_plain(_t(ht.k1), _t(ht.k2), _t(ht.val),
                                _t(q[:, 0]), _t(q[:, 1]),
                                prehashed=prehashed, mode=mode)
    want = jkops.ht_probe(ht.k1, ht.k2, ht.val, q[:, 0], q[:, 1],
                          prehashed=prehashed, mode=mode,
                          use_pallas=True, interpret=True)
    return got, want


def _queries(live, rng):
    """Present, absent and garbage (full int32 range, negative) keys, and
    the sentinels: ``(-1, -1)`` finds the first EMPTY, ``(-2, -2)`` the
    first TOMB; ``(-1, x)`` and ``(-2, x)`` stop there without a match."""
    x = rng.integers(0, 2000, size=2)
    return np.concatenate([
        live[: min(24, len(live))],
        rng.integers(0, 2000, size=(16, 2)).astype(np.int32),
        rng.integers(-2**31, 2**31, size=(16, 2)).astype(np.int32),
        np.array([[-1, -1], [-2, -2], [0, 0], [-1, x[0]], [-2, x[1]]],
                 np.int32)])


@pytest.mark.parametrize("cap,n_live,n_tomb", [
    (64, 16, 0),        # light load
    (64, 40, 12),       # heavy load + tombstoned chains
    (256, 200, 30),     # long chains near capacity
    (16, 16, 0),        # FULL table: absent probes wrap the whole chain
    (8, 3, 2),          # caps at and below a tile of 8 threads, and the
    (16, 6, 3),         # weab dummy's 8 slots
    (32, 14, 6),
    (8, 8, 0),          # FULL, no tombstone: absent chains end at start
    (32, 32, 0),
    (8, 5, 3),          # FULL of live keys and tombstones: no EMPTY, so an
    (16, 10, 6),        # absent chain wraps all of cap, its windows
    (32, 22, 10),       # straddle slot cap-1 and the upsert takes a TOMB
])
@pytest.mark.parametrize("prehashed", [False, True])
@pytest.mark.parametrize("mode", ["find", "insert"])
def test_plain_probe_matches_pallas_kernel(cap, n_live, n_tomb, prehashed,
                                           mode):
    """slot, found and val bitwise equal to the Pallas kernel: present,
    absent, garbage and sentinel keys."""
    ht, live = _jax_table(cap, n_live, n_tomb, seed=cap + n_live)
    rng = np.random.default_rng(7 * cap + n_live)
    q = _queries(live, rng)
    got, want = _probe_both(ht, q, prehashed, mode)
    for g, w, name in zip(got, want, ("slot", "found", "val")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{name} differs")
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool


@pytest.mark.parametrize("batch", [1, 5, 20, 128, 300])
def test_plain_probe_batch_shapes(batch):
    ht, _ = _jax_table(64, 30, 5, seed=batch)
    rng = np.random.default_rng(batch)
    q = rng.integers(0, 2000, size=(batch, 2)).astype(np.int32)
    got, want = _probe_both(ht, q, False, "insert")
    for g, w in zip(got, want):
        assert g.shape == (batch,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _job_tables(seed):
    """Tables of mixed caps and loads, full ones included, with queries."""
    out = []
    for i, (cap, n_live, n_tomb) in enumerate(
            [(8, 5, 3), (16, 16, 0), (32, 14, 6), (64, 40, 12), (8, 2, 1)]):
        ht, live = _jax_table(cap, n_live, n_tomb, seed=seed + i)
        out.append((ht, _queries(live, np.random.default_rng(seed + i))))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_many_matches_pallas_kernel_job_by_job(seed):
    """``ht_probe_many_plain`` (and ``ops.ht_probe_many`` on the CPU) over
    jobs of mixed caps and modes, each job bitwise the Pallas kernel's
    probe of its own table."""
    jobs, wants = [], []
    for i, (ht, q) in enumerate(_job_tables(10 * seed)):
        for j, mode in enumerate(tprobe.MODES):
            pre = bool((i + j + seed) % 2)
            jobs.append(tprobe.ProbeJob(
                _t(ht.k1), _t(ht.k2), _t(ht.val), _t(q[:, 0]), _t(q[:, 1]),
                pre, mode))
            wants.append(jkops.ht_probe(ht.k1, ht.k2, ht.val, q[:, 0],
                                        q[:, 1], prehashed=pre, mode=mode,
                                        use_pallas=True, interpret=True))
    for got in (tprobe.ht_probe_many_plain(jobs), tkops.ht_probe_many(jobs)):
        assert len(got) == len(jobs)
        for g, w in zip(got, wants):
            for x, y, name in zip(g, w, ("slot", "found", "val")):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                              err_msg=f"{name} differs")


@pytest.mark.parametrize("mode", ["find", "insert"])
def test_stacked_jobs_match_vmapped_pallas_kernel(mode):
    """A stacked ``[R, cap]`` table with ``[R, B]`` queries as R jobs
    against ``jax.vmap`` of the Pallas kernel (interpret mode), the TPU's
    stacked-replica launch; each job is a row view, not a copy."""
    tabs = [_jax_table(32, 14 + 4 * r, 4 + 2 * r, seed=50 + r)
            for r in range(3)]
    rng = np.random.default_rng(5)
    qs = [_queries(live, rng)[:40] for _, live in tabs]
    k1, k2, val = (np.stack([np.asarray(getattr(ht, w)) for ht, _ in tabs])
                   for w in ("k1", "k2", "val"))
    q = np.stack(qs)
    want = jax.vmap(functools.partial(ht_probe_batch, mode=mode,
                                      interpret=True))(
        jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(val),
        jnp.asarray(q[..., 0]), jnp.asarray(q[..., 1]))
    tk1 = _t(k1)
    jobs = tprobe.stacked_jobs(tk1, _t(k2), _t(val),
                               _t(np.ascontiguousarray(q[..., 0])),
                               _t(np.ascontiguousarray(q[..., 1])),
                               mode=mode)
    assert len(jobs) == 3
    assert jobs[1].tk1.data_ptr() == tk1[1].data_ptr()
    got = tkops.ht_probe_many(jobs)
    for r in range(3):
        for x, y in zip(got[r], want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y[r]))


def test_probe_many_routing_and_counts():
    """CPU tables take the plain version and count no launch; no job is
    no launch; the kernel path refuses CPU tensors and the plain path
    any other device's; ``reset_counts``
    clears launches, jobs and the batch histogram; a lane tensor that is
    already int32, 1-D and contiguous is not copied; the launcher splits
    jobs past ``MAX_JOBS`` into launches and returns how many it made."""
    t = tht.ht_new(8, "cpu")
    q = torch.zeros(3, dtype=torch.int32)
    tkops.ht_probe.launches, tkops.ht_probe.jobs = 5, 7
    tkops.ht_probe.by_batch[("find", 3)] = 2
    out = tkops.ht_probe_many([(t.k1, t.k2, t.val, q, q, False, "find")])
    assert tkops.ht_probe.launches == 5 and tkops.ht_probe.jobs == 7
    assert out[0][1].dtype == torch.bool and not out[0][1].any()
    assert tkops.ht_probe_many([]) == []
    tkops.reset_counts()
    assert (tkops.ht_probe.launches, tkops.ht_probe.jobs,
            len(tkops.ht_probe.by_batch)) == (0, 0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tprobe.ht_probe_many_cuda([(t.k1, t.k2, t.val, q, q, False,
                                    "find")])
    meta = tht.ht_new(8, "meta")
    with pytest.raises(ValueError, match="CPU"):      # no plain run there
        tkops.ht_probe_many([(t.k1, t.k2, t.val, q, q, False, "find"),
                             (meta.k1, meta.k2, meta.val, q, q, False,
                              "find")])
    assert tht._lanes(q) is q
    assert tht._lanes(q.long()).dtype == torch.int32
    assert tprobe.ht_probe_many_cuda([]) == ([], 0)

    class Lib:              # stands in for the built kernel's ctypes library
        calls = []

        def ht_probe_launch(self, blob, njobs, max_n, stream):
            self.calls.append((len(blob), njobs, max_n, stream))
            return 0

    packed = [(n, bytes(tprobe._JOB.size))
              for n in range(1, tprobe.MAX_JOBS + 3)]
    assert tprobe._launch_packed(Lib(), packed, 7) == 2
    assert Lib.calls == [(tprobe.MAX_JOBS * tprobe._JOB.size,
                          tprobe.MAX_JOBS, tprobe.MAX_JOBS, 7),
                         (2 * tprobe._JOB.size, 2, tprobe.MAX_JOBS + 2, 7)]


def test_probe_wrapper_checks_its_arguments():
    t = tht.ht_new(8, "cpu")
    q = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        tkops.ht_probe(t.k1, t.k2, t.val, q, q, mode="upsert")
    with pytest.raises(TypeError, match="int32"):
        tkops.ht_probe(t.k1, t.k2, t.val, q.long(), q.long())
    bad = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        tkops.ht_probe(bad, bad, bad, q, q)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.zeros(6, dtype=torch.int32)[::2]
        tkops.ht_probe(t.k1, t.k2, t.val, strided, q)
    # the plain version runs on CPU tensors and launches nothing
    before = tkops.ht_probe.launches
    tkops.ht_probe(t.k1, t.k2, t.val, q, q)
    assert tkops.ht_probe.launches == before


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_write_interleavings_match_jax(seed):
    """Random ok-masked ht_set / ht_add / ht_delete sequences on small
    tables (collisions, tombstones, wrap-around): every table word and
    every returned value bitwise equal after every op.  The port's ``ok``
    is a bool tensor (the masked path) or a Python bool (the branch)."""
    rng = np.random.default_rng(seed)
    cap = (16, 32, 64)[seed]
    jt = jht.ht_new(cap)
    tt = tht.ht_new(cap, "cpu")
    for step in range(300):
        op = rng.integers(3)
        k1, k2 = (int(x) for x in rng.integers(0, 6, size=2))
        ok = bool(rng.random() < 0.7)
        tok = torch.tensor([ok]) if rng.random() < 0.5 else ok
        if op == 0:
            v = int(rng.integers(-50, 50))
            jt = _jset(jt, k1, k2, v, ok=ok)
            tht.ht_set(tt, _t([k1]), _t([k2]), v, ok=tok)
        elif op == 1:
            d = int(rng.integers(-3, 4))
            riz = bool(rng.random() < 0.5)
            jt, jnew = _jadd(jt, k1, k2, d, remove_if_zero=riz, ok=ok)
            tt, tnew = tht.ht_add(tt, _t([k1]), _t([k2]), d,
                                  remove_if_zero=riz, ok=tok)
            assert int(tnew[0]) == int(jnew), f"step {step}: new differs"
        else:
            jt = _jdel(jt, k1, k2, ok=ok)
            tht.ht_delete(tt, _t([k1]), _t([k2]), ok=tok)
        for w in ("k1", "k2", "val"):
            np.testing.assert_array_equal(
                getattr(tt, w).numpy(), np.asarray(getattr(jt, w)),
                err_msg=f"step {step} op {op}: {w} differs")
        assert int(tht.ht_lookup(tt, _t([k1]), _t([k2]))[0]) == \
            int(_jlookup(jt, k1, k2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_writes_and_probe_many_match_jax(seed):
    """``set_job``/``set_write`` and ``delete_job``/``delete_write`` on two
    tables whose probes share one ``probe_many`` call, after random
    ok-masked interleavings: every table word bitwise equal to JAX's
    ``ht_set``/``ht_delete`` applied one table after the other."""
    rng = np.random.default_rng(100 + seed)
    caps = ((8, 16), (16, 32), (32, 8))[seed]
    jts = [jht.ht_new(c) for c in caps]
    tts = [tht.ht_new(c, "cpu") for c in caps]
    for step in range(200):
        keys = rng.integers(0, 6, size=(2, 2))
        ok = bool(rng.random() < 0.7)
        tok = torch.tensor([ok]) if rng.random() < 0.5 else ok
        if rng.random() < 0.6:
            vals = rng.integers(-50, 50, size=2)
            jobs = [tht.set_job(tt, _t([a]), _t([b]))
                    for tt, (a, b) in zip(tts, keys)]
            if tok is not False:          # as ht_set / ht_delete
                for job, probed, v in zip(jobs, tht.probe_many(jobs), vals):
                    tht.set_write(job, probed, int(v), ok=tok)
            jts = [_jset(jt, int(a), int(b), int(v), ok=ok)
                   for jt, (a, b), v in zip(jts, keys, vals)]
        else:
            jobs = [tht.delete_job(tt, _t([a]), _t([b]))
                    for tt, (a, b) in zip(tts, keys)]
            if tok is not False:          # as ht_set / ht_delete
                for job, probed in zip(jobs, tht.probe_many(jobs)):
                    tht.delete_write(job, probed, ok=tok)
            jts = [_jdel(jt, int(a), int(b), ok=ok)
                   for jt, (a, b) in zip(jts, keys)]
        for i, (tt, jt) in enumerate(zip(tts, jts)):
            for w in ("k1", "k2", "val"):
                np.testing.assert_array_equal(
                    getattr(tt, w).numpy(), np.asarray(getattr(jt, w)),
                    err_msg=f"step {step} table {i}: {w} differs")


def test_rebuild_matches_jax_fold():
    jt, _ = _jax_table(64, 30, 12, seed=3)
    tt = tht.HashTable(_t(jt.k1), _t(jt.k2), _t(jt.val))
    want = jht.ht_rebuild(jt)
    got = tht.ht_rebuild(tt)
    for w in ("k1", "k2", "val"):
        np.testing.assert_array_equal(getattr(got, w).numpy(),
                                      np.asarray(getattr(want, w)))
    assert tht.ht_load(got) == pytest.approx(float(jht.ht_load(want)))


# --------------------------------------------------------------------- #
# integer / PRNG primitives
# --------------------------------------------------------------------- #

_EDGE_U32 = np.array([0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFE, 0x7FFFFFFF,
                      0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF,
                      0x9E3779B9, 2654435761], np.uint32)


def _u32_inputs(seed, n=4000):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([_EDGE_U32, x])


def _tu32(x):
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))


def test_hash_and_mixhash_bitwise():
    x = _u32_inputs(0)
    y = _u32_inputs(1)
    k1, k2 = x.view(np.int32), y.view(np.int32)
    for cap in (8, 1 << 10, 1 << 25):
        np.testing.assert_array_equal(
            tht._hash(_t(k1), _t(k2), cap).numpy(),
            np.asarray(jht._hash(jnp.asarray(k1), jnp.asarray(k2), cap)))
        for pre in (False, True):
            np.testing.assert_array_equal(
                tht._probe_start(_t(k1), _t(k2), cap, pre).numpy(),
                np.asarray(jht._probe_start(jnp.asarray(k1),
                                            jnp.asarray(k2), cap, pre)))
    np.testing.assert_array_equal(tops.mixhash(_t(k1)).numpy(),
                                  np.asarray(jops.mixhash(jnp.asarray(k1))))


def test_prng_bitwise():
    seed, ctr = _u32_inputs(2), _u32_inputs(3)
    js, jc = jnp.asarray(seed), jnp.asarray(ctr)
    np.testing.assert_array_equal(
        tops.rnd_u32(_tu32(seed), _tu32(ctr)).numpy(),
        np.asarray(jops.rnd_u32(js, jc)).astype(np.int64))
    got = tops.rnd_u01(_tu32(seed), _tu32(ctr))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy().view(np.int32),
        np.asarray(jops.rnd_u01(js, jc)).view(np.int32))
    np.testing.assert_array_equal(
        tops._mulhi_u32(_tu32(seed), _tu32(ctr)).numpy(),
        np.asarray(jops._mulhi_u32(js, jc)).astype(np.int64))
    n = np.concatenate([np.array([-5, 0, 1, 2, 3, 7, 64, 2**31 - 1],
                                 np.int32),
                        np.random.default_rng(4).integers(
                            0, 5000, size=len(seed) - 8).astype(np.int32)])
    np.testing.assert_array_equal(
        tops.rnd_below(_tu32(seed), _tu32(ctr), _t(n)).numpy(),
        np.asarray(jops.rnd_below(js, jc, jnp.asarray(n))))


@pytest.mark.parametrize("levels", [0, 1, 3, 7])
def test_node_weights_bitwise(levels):
    u = np.concatenate([np.arange(300), [2**31 - 1, -1]]).astype(np.int32)
    want = np.asarray(jops.node_weight(jnp.asarray(u),
                                       JaxConfig(weight_levels=levels)))
    got = tops.node_weight(_t(u), EngineConfig(weight_levels=levels))
    np.testing.assert_array_equal(got.numpy(), want)
    assert [host_node_weight(int(x), levels) for x in u] == want.tolist()


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_the_card():
    """The CUDA probe kernel against its plain version, bitwise, on tables
    on the card (run on a machine with one; skipped elsewhere): one job at
    a time with present, absent, garbage and sentinel keys; caps 8/16/32,
    full with and without tombstones; and every job of mixed caps and
    modes in one ``ht_probe_many`` launch, then in two."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ht, live = _jax_table(256, 200, 30, seed=11)
    rng = np.random.default_rng(11)
    q = np.concatenate([live[:64], rng.integers(-2**31, 2**31, size=(64, 2)
                                                ).astype(np.int32),
                        _queries(live, rng)])
    args = [_t(x).cuda() for x in (ht.k1, ht.k2, ht.val, q[:, 0], q[:, 1])]
    for mode in tprobe.MODES:
        for pre in (False, True):
            got = tprobe.ht_probe_cuda(*args, prehashed=pre, mode=mode)
            want = tprobe.ht_probe_plain(*args, prehashed=pre, mode=mode)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    jobs = []
    for i, (jt, jq) in enumerate(_job_tables(3)):
        for j, mode in enumerate(tprobe.MODES):
            jobs.append(tprobe.ProbeJob(
                *(_t(x).cuda() for x in (jt.k1, jt.k2, jt.val, jq[:, 0],
                                         jq[:, 1])), bool((i + j) % 2), mode))
    for many in (jobs, jobs * 6):
        before = tkops.ht_probe.launches
        got = tkops.ht_probe_many(many)
        assert tkops.ht_probe.launches - before == \
            -(-len(many) // tprobe.MAX_JOBS)
        want = tprobe.ht_probe_many_plain(many)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                assert torch.equal(x, y)
