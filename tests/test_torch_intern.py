"""PyTorch port: node interning, bitwise against the JAX package.

The plain intern (``kernels/intern.py::intern_plain``, what the CPU runs
behind ``dist/router.py::intern_changes``) against JAX's
``repro.dist.router.intern_changes`` under ``jax.vmap`` over a stacked
block of 3 intern states, for both of JAX's lowerings (``dense`` False
and True, which give the same bits), over three calls that carry the state: novel keys repeated
within a call, keys known from an earlier call, padding lanes, a change
whose ``u`` is interned while its ``v`` is dropped at ``n_cap`` 6,
repeated drops, and planted tombstones (a key behind a TOMB, a new key
inserted at the first EMPTY or TOMB slot of its chain, not the first
EMPTY).  After every call every id and every ``InternState`` leaf is
bitwise equal.  Tolerance: exact.  The kernel itself is held to the plain
version on the card by ``tests/test_torch_intern_card.py`` and
``chip_smoke.py`` phase 22.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.engine.hashtable import HashTable as JaxTable  # noqa: E402
from repro.dist import router as jax_router  # noqa: E402
from repro_torch.core.engine.hashtable import EMPTY, TOMB  # noqa: E402
from repro_torch.core.engine.state import state_rows  # noqa: E402
from repro_torch.dist import router  # noqa: E402
from repro_torch.kernels import intern as kintern  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

N_CAP = 6
CAP = 32                 # intern_cap at n_cap 6: the power of two >= 24
ROWS = 3
LANES = 8


def key(start: int, salt: int):
    """A non-negative two-word key whose prehashed start is ``start``."""
    hi = (salt * 2654435761 + 12345) % (1 << 30) + (1 << 20)
    return hi, hi ^ start


def fresh_state():
    return dict(k1=np.full((ROWS, CAP), EMPTY, np.int32),
                k2=np.full((ROWS, CAP), EMPTY, np.int32),
                val=np.zeros((ROWS, CAP), np.int32),
                l2h=np.full((ROWS, N_CAP, 2), -1, np.int32),
                n_nodes=np.zeros(ROWS, np.int32),
                n_dropped=np.zeros(ROWS, np.int32))


def plant(state):
    """Row 1: TOMBs at slots 5 and 9, and a live key behind the TOMB at 5
    (homed at 5, sitting at 6 with id 0, as a delete of slot 5's key
    leaves it)."""
    k = key(5, 900)
    state["k1"][1, 5] = state["k2"][1, 5] = TOMB
    state["k1"][1, 9] = state["k2"][1, 9] = TOMB
    state["k1"][1, 6], state["k2"][1, 6], state["val"][1, 6] = *k, 0
    state["l2h"][1, 0] = k
    state["n_nodes"][1] = 1
    return k


def calls(behind_tomb):
    """Three calls of ``LANES`` changes a row, endpoints as keys (``None``
    for padding): row 0 by labels A-I, row 1 around the planted slots,
    row 2 a long repeat of few keys."""
    K = {c: key((7 * i + 3) % CAP, i) for i, c in enumerate("ABCDEFGHI")}
    T5, T9 = key(5, 901), key(9, 902)     # homed at the TOMBs
    S5 = key(5, 903)                      # homed at 5 after T5 took it
    X = key(9, 904)
    P = (None, None)
    row0 = [
        # A, B, C repeat within the call; D, E; F interned as u while G is
        # dropped as v (n_cap 6): the change maps to (-1, -1)
        [("A", "B"), ("B", "C"), ("A", "C"), P, ("C", "D"), ("D", "E"),
         ("F", "G"), P],
        # known keys from call 1; G and H dropped, and dropped again
        [("B", "A"), ("G", "A"), ("A", "G"), ("H", "H"), P, ("E", "F"),
         ("C", "C"), P],
        [("I", "I"), ("D", "B"), P, P, ("A", "E"), ("I", "A"), P,
         ("F", "D")],
    ]
    row1 = [
        # the planted key found behind its TOMB; T5 into the TOMB at 5;
        # T9 into the TOMB at 9; S5 then past T5 and the planted key to 7
        [(behind_tomb, T5), (T9, behind_tomb), (S5, T5), P, (X, T9), P,
         (S5, X), P],
        [(T5, T9), P, ("A", "B"), ("A", S5), P, P, P, P],
        [P] * LANES,
    ]
    row2 = [
        [("C", "C"), ("C", "D"), ("D", "C"), ("C", "D"), P, P, P, P],
        [P] * LANES,
        [("E", "C"), ("F", "G"), ("H", "I"), ("A", "B"), ("B", "A"),
         ("C", "E"), ("D", "F"), ("G", "H")],
    ]

    def word(x, w):
        if x is None:
            return -1
        return (K[x] if isinstance(x, str) else x)[w]

    out = []
    for n in range(3):
        rows = (row0[n], row1[n], row2[n])
        out.append(tuple(
            np.array([[word(e[side], w) for e in r] for r in rows], np.int32)
            for side, w in ((0, 0), (0, 1), (1, 0), (1, 1))))
    return out


def jax_state(s):
    return jax_router.InternState(
        h2l=JaxTable(jnp.asarray(s["k1"]), jnp.asarray(s["k2"]),
                     jnp.asarray(s["val"])),
        l2h=jnp.asarray(s["l2h"]), n_nodes=jnp.asarray(s["n_nodes"]),
        n_dropped=jnp.asarray(s["n_dropped"]))


def port_state(s):
    t = {k: torch.from_numpy(v.copy()) for k, v in s.items()}
    return router.InternState(
        h2l=router.HashTable(t["k1"], t["k2"], t["val"]), l2h=t["l2h"],
        n_nodes=t["n_nodes"], n_dropped=t["n_dropped"])


def assert_states_equal(ist, jist, what):
    got = dict(k1=ist.h2l.k1, k2=ist.h2l.k2, val=ist.h2l.val, l2h=ist.l2h,
               n_nodes=ist.n_nodes, n_dropped=ist.n_dropped)
    want = dict(k1=jist.h2l.k1, k2=jist.h2l.k2, val=jist.h2l.val,
                l2h=jist.l2h, n_nodes=jist.n_nodes,
                n_dropped=jist.n_dropped)
    for k in got:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(got[k].numpy(), w,
                                      err_msg=f"{what}: {k}")


@pytest.mark.parametrize("dense", [False, True], ids=["pwhen", "dense"])
def test_plain_intern_equals_jax_stacked(dense):
    s = fresh_state()
    behind_tomb = plant(s)
    jist, ist = jax_state(s), port_state(s)
    step = jax.jit(jax.vmap(lambda st, a, b, c, d: jax_router.intern_changes(
        st, a, b, c, d, N_CAP, dense)))
    for n, words in enumerate(calls(behind_tomb)):
        jist, ju, jv = step(jist, *(jnp.asarray(w) for w in words))
        u, v = router.intern_changes(
            ist, *(torch.from_numpy(w) for w in words), N_CAP)
        assert u.dtype == v.dtype == torch.int32
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju),
                                      err_msg=f"call {n}: u")
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv),
                                      err_msg=f"call {n}: v")
        assert_states_equal(ist, jist, f"call {n}")
        if n == 0:     # (F, G): F took the last id, G was dropped
            assert u[0, 6] == v[0, 6] == -1 and u[0, 5] >= 0
            assert tuple(ist.l2h[0, N_CAP - 1].tolist()) == tuple(
                int(w[0, 6]) for w in words[:2])
    k1 = ist.h2l.k1.numpy()
    # the cases happened: row 0 full and dropping (repeats counted), the
    # planted TOMBs reused, a (-1, -1) change with its u interned
    assert ist.n_nodes.tolist()[0] == N_CAP
    assert ist.n_dropped.tolist()[0] >= 4
    assert (k1[1, 5], k1[1, 9]) == (key(5, 901)[0], key(9, 902)[0])
    assert k1[1, 7] == key(5, 903)[0]


def test_one_row_and_stacked_block_agree_and_check_args():
    """``intern_changes`` on a one-row state (``[L]`` words, 0-dim
    counters: a view of the row written in place) gives the stacked
    block's row; the kernel layer refuses bad arguments."""
    s = fresh_state()
    behind_tomb = plant(s)
    block = port_state(s)
    rows = state_rows(port_state(s))
    for words in calls(behind_tomb):
        u, v = router.intern_changes(
            block, *(torch.from_numpy(w) for w in words), N_CAP)
        for r, row in enumerate(rows):
            ur, vr = router.intern_changes(
                row, *(torch.from_numpy(w[r]) for w in words), N_CAP)
            assert torch.equal(ur, u[r]) and torch.equal(vr, v[r])
    for a, b in zip(state_rows(block), rows):
        for x, y in ((a.h2l.k1, b.h2l.k1), (a.l2h, b.l2h),
                     (a.n_nodes, b.n_nodes), (a.n_dropped, b.n_dropped)):
            assert torch.equal(x, y)
    table = (block.h2l.k1, block.h2l.k2, block.h2l.val)
    words = [torch.zeros((ROWS, 4), dtype=torch.int32)] * 4
    args = (block.l2h, block.n_nodes, block.n_dropped)
    with pytest.raises(ValueError, match="share strides"):
        ops.intern(table, *args,
                   [torch.zeros((ROWS, 8), dtype=torch.int32)[:, ::2]]
                   + words[1:], N_CAP)
    with pytest.raises(ValueError, match="shape"):
        ops.intern(table, *args, words, N_CAP + 1)
    with pytest.raises(TypeError, match="int32"):
        ops.intern(table, *args, [w.long() for w in words], N_CAP)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.intern(tuple(t.to("meta") for t in table), *args, words, N_CAP)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kintern.intern_cuda(table, *args, words, N_CAP)
    assert ops.intern.launches == 0       # the CPU takes the plain version
