"""Write-ahead chunk journal for crash-consistent streaming recovery.

A copy of ``repro/checkpoint/journal.py`` (which imports no framework):
the same frames, so a journal written by either package replays in the
other byte for byte.

The summarizers checkpoint at *epoch* granularity (one epoch per dispatched
chunk), but checkpointing every chunk would serialize the whole engine
state onto the host at stream rate.  The journal closes the gap: every
chunk of caller-label changes is appended here — framed, checksummed and
fsynced — **before** it is dispatched to the engine, and the file is
compacted when an epoch checkpoint lands.  Recovery is then

    restore last valid epoch E  +  replay journal records with seq >= E

and, because chunk boundaries fully determine the engine-round/PRNG
schedule, the replayed run is leaf-bitwise equal to the uninterrupted one.

Frame format (little-endian), one record per journaled chunk::

    magic   4 bytes   b"JRN1"
    seq     8 bytes   chunk sequence number == flush_epoch the chunk enters
    length  4 bytes   payload byte length
    crc32   4 bytes   zlib.crc32(payload)
    payload           pickled list of (u, v, is_insert) caller-label changes

A crash can only tear the *tail* record (appends are sequential and each
append is fsynced before the chunk dispatches); :meth:`scan` stops at the
first frame that fails magic/length/CRC validation and reports it as a
torn tail rather than an error.  Duplicated records (a crash between the
append and the seq-counter advance, or an injected fault) are deduped by
sequence number at replay; a *gap* in the sequence means lost acknowledged
writes and is a hard error — replaying across it would silently diverge.

Compaction (:meth:`truncate`) rewrites the file atomically keeping only
records with ``seq >= keep_from_seq``.  The summarizers keep one retained
epoch of history (``keep_from_seq`` = previous checkpoint's epoch), so a
checkpoint whose arrays later fail their checksum can still fall back to
the previous epoch and re-earn the present via replay.
"""
from __future__ import annotations

import os
import pickle
import struct
import zlib
from typing import Iterable, List, Tuple

_MAGIC = b"JRN1"
_HEADER = struct.Struct("<4sQII")   # magic, seq, payload length, crc32


class ChunkJournal:
    """Append-only, fsynced, framed journal of dispatched chunks."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    # -- write side ------------------------------------------------------

    def append(self, seq: int, changes: Iterable[Tuple]) -> None:
        """Durably append one chunk *before* it is dispatched.

        Returns only once the record is on disk (fsync): if the process
        dies any time after dispatch, the chunk is replayable.
        """
        payload = pickle.dumps(list(changes),
                               protocol=pickle.HIGHEST_PROTOCOL)
        record = _HEADER.pack(_MAGIC, seq, len(payload),
                              zlib.crc32(payload)) + payload
        with open(self.path, "ab") as f:
            f.write(record)
            f.flush()
            os.fsync(f.fileno())

    def truncate(self, keep_from_seq: int = 0) -> None:
        """Atomically compact, keeping records with ``seq >= keep_from_seq``.

        Crash-safe: the new file is staged, fsynced and ``os.replace``d, so
        a reader sees either the old journal (stale records are filtered at
        replay) or the compacted one — never a half-rewritten file.
        """
        kept, _ = self.scan()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for seq, changes in kept:
                if seq < keep_from_seq:
                    continue
                payload = pickle.dumps(changes,
                                       protocol=pickle.HIGHEST_PROTOCOL)
                f.write(_HEADER.pack(_MAGIC, seq, len(payload),
                                     zlib.crc32(payload)) + payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        _dir = os.path.dirname(self.path)
        if _dir:
            fd = os.open(_dir, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)

    def reset(self) -> None:
        """Start a fresh journal (new stream into an old directory)."""
        if os.path.exists(self.path):
            os.remove(self.path)

    # -- read side -------------------------------------------------------

    def scan(self) -> Tuple[List[Tuple[int, list]], bool]:
        """All well-formed records in file order, plus a torn-tail flag.

        Stops at the first frame that fails validation (short header,
        bad magic, short payload, CRC mismatch): everything after a torn
        frame is unreachable garbage by construction, never silently
        reinterpreted as data.
        """
        records: List[Tuple[int, list]] = []
        if not os.path.exists(self.path):
            return records, False
        with open(self.path, "rb") as f:
            data = f.read()
        off = 0
        while off < len(data):
            if off + _HEADER.size > len(data):
                return records, True
            magic, seq, length, crc = _HEADER.unpack_from(data, off)
            if magic != _MAGIC:
                return records, True
            payload = data[off + _HEADER.size: off + _HEADER.size + length]
            if len(payload) < length or zlib.crc32(payload) != crc:
                return records, True
            records.append((seq, pickle.loads(payload)))
            off += _HEADER.size + length
        return records, False

    def replay(self, from_seq: int) -> List[Tuple[int, list]]:
        """Validated, deduplicated tail: records with ``seq >= from_seq``
        in strictly consecutive order.

        * records below ``from_seq`` are pre-checkpoint history → skipped;
        * a record repeating the previous seq is a duplicate → skipped;
        * a seq *jump* means an acknowledged chunk is missing → raise
          (recovering across the hole would be silent divergence).
        """
        records, _torn = self.scan()
        out: List[Tuple[int, list]] = []
        expect = from_seq
        for seq, changes in records:
            if seq < expect:
                continue                    # stale or duplicated record
            if seq > expect:
                raise RuntimeError(
                    f"journal gap: expected chunk seq {expect}, found {seq} "
                    f"in {self.path} — an acknowledged chunk is missing")
            out.append((seq, changes))
            expect += 1
        return out
