"""PyTorch port: label hashing, equal to the JAX package's bit for bit.

The hashes are the shard placement and the intern-table keys, so the
port's copy (``repro_torch.dist.labelhash``) must give ``repro.dist.
labelhash``'s words on every case of ``tests/test_labelhash.py``: ints
(negative, up to 2^64 - 1, beyond it, numpy ints), floats and their
canonicalisation, str, bytes, tuples and mixed chunks.  Tolerance: exact.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.dist import labelhash as jax_lh  # noqa: E402
from repro_torch.dist import labelhash as lh  # noqa: E402

CHUNKS = [
    [0, 1, -1, 5, 2**31, 2**62 - 1, -(2**63), 2**63 - 1],   # int64
    [2**63, 2**63 + 5, 2**64 - 1],                          # uint64
    [2**64 + 3, -(2**63) - 1, "mixed", 7],                  # object
    ["a", "b", "", "n001"],                                 # str
    [b"x", b""],                                            # bytes
    [1.5, -0.25, 2.0, 1e300],                               # float
    [(1, 2), (3, 4)],                                       # tuples
    [np.int32(7), np.uint64(2**63), np.int64(-3)],          # numpy ints
    [True, False, 1.0, np.float32(2.0), float(2**53)],      # canonicalised
    list(range(-500, 500)) + [f"n{i}" for i in range(100)]
    + [(i, i + 1) for i in range(50)] + [i + 0.5 for i in range(50)],
]


@pytest.mark.parametrize("chunk", CHUNKS, ids=[
    "int64", "uint64", "object", "str", "bytes", "float", "tuple",
    "numpy_int", "canonical", "population"])
def test_hash_words_and_labels_equal_jax(chunk):
    hi, lo = lh.hash_words(chunk)
    jhi, jlo = jax_lh.hash_words(chunk)
    assert hi.dtype == jhi.dtype == np.int32
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(lh.combine(hi, lo),
                                  jax_lh.combine(jhi, jlo))
    assert ([lh.hash_label(x) for x in chunk]
            == [jax_lh.hash_label(x) for x in chunk])


def test_constants_and_canonicalisation_equal_jax():
    assert (lh.MASK31, lh.MASK62) == (jax_lh.MASK31, jax_lh.MASK62)
    assert lh.hash_label(True) == lh.hash_label(1) == lh.hash_label(1.0)
    assert lh.hash_label(np.float32(2.0)) == lh.hash_label(2)
    assert lh.hash_label(1.5) != lh.hash_label("1.5")
    assert len({lh.hash_label("5"), lh.hash_label(b"5"),
                lh.hash_label(5)}) == 3
