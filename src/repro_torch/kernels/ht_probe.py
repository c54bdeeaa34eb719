"""Batched hash-table probe: the CUDA kernel and its plain torch version.

Replaces the Pallas kernel ``repro/kernels/ht_probe.py::_probe_kernel``
(wrapper ``ht_probe_batch``).  Both functions here compute, per lane, one
linear-probe chain of the key ``(q1, q2)`` and return ``(slot, found,
val)``: ``mode="find"`` stops at the key or at EMPTY (``ht_find``);
``mode="insert"`` adds the upsert's second pass to the first EMPTY/TOMB
slot when the key is absent (``_find_insert_slot``).  ``val`` is read at
the key's find-chain end whether or not the key was found.  The contract
is bitwise: the probe sequence is the table layout.

* :func:`ht_probe_many_cuda` launches ``csrc/ht_probe.cu`` once for every
  ``MAX_JOBS`` jobs, and says how many launches it made: probe batches on
  tables of any caps and modes (a tile
  of 8 threads per lane, one pass for both modes; the source says what
  bounds it).  A stacked ``[R, cap]`` table with ``[R, B]`` queries, the
  TPU kernel's form under ``jax.vmap``, is R jobs: given as one job, its
  rows become R kernel jobs writing the rows of one ``[R, B]`` output
  triple (the sharded engine's stacked step); :func:`stacked_jobs` splits
  it into R row-view jobs instead.  :func:`ht_probe_cuda` is the one-job
  case.  The shared library is built
  with ``nvcc`` at first use into ``build/`` at the repository root, from
  this checkout's source, and loaded with ``ctypes`` (``kernels/_build.py``).
* :func:`ht_probe_plain` is the uniform masked two-pass loop over the
  whole batch of ``_probe_kernel``, in ``int64`` torch (a stacked job's
  rows in one loop), and
  :func:`ht_probe_many_plain` a loop of it over the jobs.  The CPU tests
  run them, and ``chip_smoke.py`` holds the kernel to them on the card.
* :func:`probe_op` is the probe as a ``torch.library.custom_op`` with a
  fake implementation: its chain loop reads the host each round, so on
  ``meta`` tensors (the dry-run) the probe is this one op, whose bytes
  :func:`probe_bytes` gives as the kernel reads them.

Nothing here imports a GPU toolchain at import time: the CPU tests import
this module.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.engine.hashtable import EMPTY, TOMB, _probe_start
from repro_torch.kernels import _build

MODES = ("find", "insert")
SOURCE = _build.CSRC / "ht_probe.cu"
MAX_JOBS = 48          # jobs per launch: csrc/ht_probe.cu's kMaxJobs
MAX_LANES = 1 << 30    # lanes per job

Probe = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class ProbeJob(NamedTuple):
    """One probe batch: a table ``(tk1, tk2, tval)``, its queries
    ``(q1, q2)`` and how to probe it.  The table ``[cap]`` with queries
    ``[B]``, or a stacked table ``[R, cap]`` with queries ``[R, B]``, row
    ``r``'s queries against row ``r`` (R kernel jobs)."""
    tk1: torch.Tensor
    tk2: torch.Tensor
    tval: torch.Tensor
    q1: torch.Tensor
    q2: torch.Tensor
    prehashed: bool = False
    mode: str = "find"


def stacked_jobs(tk1, tk2, tval, q1, q2, *, prehashed: bool = False,
                 mode: str = "find") -> List[ProbeJob]:
    """The jobs of a stacked ``[R, cap]`` table probed with ``[R, B]``
    queries, replica ``r``'s queries against its own table: the TPU
    kernel's form under ``jax.vmap``.  Each job is a row view (no copy)."""
    return [ProbeJob(tk1[r], tk2[r], tval[r], q1[r], q2[r], prehashed, mode)
            for r in range(tk1.shape[0])]


def check_args(tk1, tk2, tval, q1, q2, mode: str) -> None:
    """Raise on what neither version takes: mixed devices, a dtype other
    than int32, a non-contiguous tensor, a table that is not ``[cap]``
    with ``[B]`` queries or ``[R, cap]`` with ``[R, B]`` queries, a
    capacity that is not a power of two, or an unknown mode."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}: {mode!r}")
    cap = tk1.shape[-1] if tk1.dim() in (1, 2) else 0
    if cap <= 0 or cap & (cap - 1):
        raise ValueError(f"table capacity must be a power of two: "
                         f"{tuple(tk1.shape)}")
    for name, t in (("tk1", tk1), ("tk2", tk2), ("tval", tval)):
        if t.shape != tk1.shape:
            raise ValueError(f"{name} must have shape {tuple(tk1.shape)}: "
                             f"{tuple(t.shape)}")
    if (q1.dim() != tk1.dim() or q2.shape != q1.shape
            or q1.shape[:-1] != tk1.shape[:-1]):
        raise ValueError(f"queries must be 1-D (2-D [R, B] for an [R, cap] "
                         f"table) and of one shape: {tuple(q1.shape)} vs "
                         f"{tuple(q2.shape)}")
    for name, t in (("tk1", tk1), ("tk2", tk2), ("tval", tval),
                    ("q1", q1), ("q2", q2)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32: {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != tk1.device:
            raise ValueError(f"{name} is on {t.device}, the table on "
                             f"{tk1.device}")


# --------------------------------------------------------------------- #
# plain version
# --------------------------------------------------------------------- #


def probe_chains(tk1, tk2, q1, q2, *, prehashed: bool, mode: str,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(start, i1, i2)`` per lane, all int64: the chain start, the
    pass-1 offset where the find chain ends and, in insert mode, the
    pass-2 offset of the first free slot (zeros in find mode).  A stacked
    ``[R, cap]`` table's lanes ``[R, B]`` walk their own rows.

    Each pass is one uniform loop over the batch: a lane's offset
    advances while its scalar loop would go on and freezes once it
    stops, and the loop runs until every lane froze.
    """
    cap = tk1.shape[-1]
    start = _probe_start(q1, q2, cap, prehashed)
    rows = None                 # row r's slots in the flattened table
    f1, f2 = tk1, tk2
    if tk1.dim() == 2:
        rows = torch.arange(tk1.shape[0], device=tk1.device)[:, None] * cap
        f1, f2 = tk1.reshape(-1), tk2.reshape(-1)

    def chain(stop_fn):
        i = torch.zeros_like(start)
        done = torch.zeros(start.shape, dtype=torch.bool, device=start.device)
        while not bool(done.all()):
            slot = (start + i) & (cap - 1)
            if rows is not None:
                slot = slot + rows
            done = done | stop_fn(f1[slot], f2[slot]) | (i >= cap)
            i = torch.where(done, i, i + 1)
        return i

    i1 = chain(lambda a, b: ((a == q1) & (b == q2)) | (a == EMPTY))
    if mode == "find":
        return start, i1, torch.zeros_like(i1)
    i2 = chain(lambda a, b: (a == EMPTY) | (a == TOMB))
    return start, i1, i2


def ht_probe_plain(tk1, tk2, tval, q1, q2, *, prehashed: bool = False,
                   mode: str = "find") -> Probe:
    """The kernel's function in plain torch, on any device."""
    check_args(tk1, tk2, tval, q1, q2, mode)
    cap = tk1.shape[-1]
    start, i1, i2 = probe_chains(tk1, tk2, q1, q2, prehashed=prehashed,
                                 mode=mode)
    slot1 = (start + i1) & (cap - 1)
    if tk1.dim() == 1:
        k1, k2, val = tk1[slot1], tk2[slot1], tval[slot1]
    else:                       # row by row for a stacked table
        k1, k2, val = (tk1.gather(-1, slot1), tk2.gather(-1, slot1),
                       tval.gather(-1, slot1))
    found = (k1 == q1) & (k2 == q2)
    slot = slot1
    if mode == "insert":
        slot = torch.where(found, slot1, (start + i2) & (cap - 1))
    return slot.to(torch.int32), found, val


def ht_probe_many_plain(jobs: Sequence[ProbeJob]) -> List[Probe]:
    """:func:`ht_probe_plain` of each job, in order."""
    return [ht_probe_plain(*job[:5], prehashed=job[5], mode=job[6])
            for job in jobs]


# --------------------------------------------------------------------- #
# the probe as one op, for tracers and meta tensors
# --------------------------------------------------------------------- #

WINDOW = 8             # slots a lane reads a round: csrc/ht_probe.cu's tile
_SCHEMA = ("(Tensor tk1, Tensor tk2, Tensor tval, Tensor q1, Tensor q2, "
           "bool prehashed, bool insert) -> (Tensor, Tensor, Tensor)")


@functools.lru_cache(maxsize=None)
def probe_op():
    """The probe as the custom op ``repro_torch::ht_probe``, registered at
    first use: one op, as the kernel is one launch, for a dispatch mode to
    see whole, with :func:`ht_probe_plain` as its implementation and a
    fake one that gives the outputs' shapes, so that it runs on ``meta``
    tensors (the plain version's chain loop reads the host each round).
    ``kernels/ops.py::ht_probe_many`` routes meta tensors, and CPU ones
    under a dispatch mode, through it; CUDA tensors never."""
    def impl(tk1, tk2, tval, q1, q2, prehashed, insert):
        return ht_probe_plain(tk1, tk2, tval, q1, q2, prehashed=prehashed,
                              mode=MODES[insert])

    op = torch.library.custom_op("repro_torch::ht_probe", impl,
                                 mutates_args=(), schema=_SCHEMA)

    @op.register_fake
    def _(tk1, tk2, tval, q1, q2, prehashed, insert):
        check_args(tk1, tk2, tval, q1, q2, MODES[insert])
        return (torch.empty_like(q1), torch.empty_like(q1, dtype=torch.bool),
                torch.empty_like(q1))

    return op


def probe_bytes(lanes: int) -> int:
    """The bytes one probe of ``lanes`` lanes moves as the kernel reads
    them, one round: the two query words and the three outputs (slot,
    found, val) once, and one ``WINDOW``-slot window of the table's three
    words a lane (a chain that ends in its first window, as in a sparse
    table), not the whole table."""
    return lanes * (4 + 4 + 4 + 1 + 4 + WINDOW * 3 * 4)


# --------------------------------------------------------------------- #
# CUDA kernel
# --------------------------------------------------------------------- #

# csrc/ht_probe.cu's Job: 8 pointers (k1, k2, val, q1, q2, slot, found,
# val_out), then cap, n, insert, prehashed
_JOB = struct.Struct("<8QIiII")


def _bind(lib: ctypes.CDLL) -> None:
    lib.ht_probe_launch.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
    lib.ht_probe_launch.restype = ctypes.c_int
    lib.ht_probe_max_jobs.argtypes = []
    lib.ht_probe_max_jobs.restype = ctypes.c_int
    if lib.ht_probe_max_jobs() != MAX_JOBS:
        raise RuntimeError(f"ht_probe.cu takes {lib.ht_probe_max_jobs()} "
                           f"jobs a launch, the wrapper {MAX_JOBS}")


def _check_job(job, device: torch.device) -> Tuple[int, int]:
    """The launch's checks, from shapes, dtypes, devices and contiguity
    alone; returns the job's rows (0 for a 1-D table) and lanes a row.
    On a failure :func:`check_args`, the plain version's full check,
    names the reason."""
    tk1, tk2, tval, q1, q2, _, mode = job
    cap = tk1.shape[-1] if tk1.dim() in (1, 2) else 0
    ok = (mode in MODES and q1.dim() == tk1.dim()
          and q1.shape[:-1] == tk1.shape[:-1]
          and cap > 0 and not cap & (cap - 1)
          and tk2.shape == tk1.shape and tval.shape == tk1.shape
          and q2.shape == q1.shape)
    for t in (tk1, tk2, tval, q1, q2):
        ok = (ok and t.dtype == torch.int32 and t.device == device
              and t.is_contiguous())
    if not ok:
        check_args(tk1, tk2, tval, q1, q2, mode)
        raise ValueError(f"every job of a launch must lie on {device}")
    n = q1.shape[-1]
    if n > MAX_LANES:
        raise ValueError(f"too many lanes for one job: {n}")
    return (tk1.shape[0] if tk1.dim() == 2 else 0), n


def _launch_packed(lib: ctypes.CDLL, packed, stream: int) -> int:
    """Launch the packed jobs, ``MAX_JOBS`` at a time; returns the number
    of launches made."""
    launches = 0
    for i in range(0, len(packed), MAX_JOBS):
        chunk = packed[i:i + MAX_JOBS]
        err = lib.ht_probe_launch(b"".join(job for _, job in chunk),
                                  len(chunk), max(n for n, _ in chunk),
                                  stream)
        if err != 0:
            raise RuntimeError(f"ht_probe kernel launch failed: CUDA error "
                               f"{err}")
        launches += 1
    return launches


def ht_probe_many_cuda(jobs: Sequence[ProbeJob],
                       ) -> Tuple[List[Probe], int]:
    """Launch the kernel over the jobs on the current stream of their
    device (no sync), one launch for every ``MAX_JOBS`` kernel jobs with
    lanes; a stacked job is one kernel job a row.  Returns ``(slot,
    found, val)`` per job, bitwise :func:`ht_probe_many_plain`'s, and the
    number of launches made.  Every tensor must lie on one CUDA device."""
    if not jobs:
        return [], 0
    device = jobs[0][0].device
    if device.type != "cuda":            # before building the kernel
        raise ValueError(f"ht_probe_cuda needs CUDA tensors: {device}")
    lib = _build.load(SOURCE, _bind)
    outs, packed = [], []
    for job in jobs:
        rows, n = _check_job(job, device)
        shape = (rows, n) if rows else (n,)
        # three allocations cost the host less than views of one buffer
        # (tools/probe_check.py's host-cost split; PERF.md)
        out = (torch.empty(shape, dtype=torch.int32, device=device),
               torch.empty(shape, dtype=torch.bool, device=device),
               torch.empty(shape, dtype=torch.int32, device=device))
        outs.append(out)
        if not n:
            continue
        tk1, tk2, tval, q1, q2, prehashed, mode = job
        cap = tk1.shape[-1]
        ptrs = [t.data_ptr() for t in (tk1, tk2, tval, q1, q2, *out)]
        # a row's byte offset in each tensor: tables, int32 queries and
        # outputs, bool found
        steps = [4 * cap] * 3 + [4 * n] * 3 + [n, 4 * n]
        for r in range(max(rows, 1)):
            packed.append((n, _JOB.pack(
                *(p + r * d for p, d in zip(ptrs, steps)), cap, n,
                mode == "insert", bool(prehashed))))
    if not packed:
        return outs, 0
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        return outs, _launch_packed(lib, packed, stream)
    with torch.cuda.device(device.index):
        return outs, _launch_packed(lib, packed, stream)


def ht_probe_cuda(tk1, tk2, tval, q1, q2, *, prehashed: bool = False,
                  mode: str = "find") -> Probe:
    """The one-job case of :func:`ht_probe_many_cuda`."""
    return ht_probe_many_cuda(
        [(tk1, tk2, tval, q1, q2, prehashed, mode)])[0][0]
