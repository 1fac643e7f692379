"""Durable committed-batch log: crash/restart recovery.

SURVEY.md §5.4: the reference keeps everything in memory (its only
resume-adjacent mechanism is the future-epoch buffer) and the build
plan calls for "an optional committed-batch log for restart".  This is
that log: an append-only file of (epoch, Batch) records with per-record
CRCs, replayed at startup to restore the committed history, the epoch
counter, and the duplicate-filter — so a restarted validator rejoins at
the epoch after its last commit instead of epoch 0.

Record format (all big-endian, following transport.message's TLV
style):  magic | u32 record_len | body | u32 crc32(record body), with
three record magics:

  "CLOG" — committed batch: u64 epoch | u32 n_proposers | per
  proposer (u32 id_len | id | u32 n_txs | per tx (u32 len | bytes)).

  "CCKP" — dedup-set checkpoint: u64 epoch | u32 n_epoch_sets | per
  set, oldest first (u32 n_txs | per tx (u32 len | bytes)) — a
  snapshot of the node's bounded committed-tx duplicate filter
  (HoneyBadger._committed_history) as of ``epoch``.  On restart the
  filter seeds from the LAST checkpoint and folds only the batches
  logged after it, instead of re-deriving tx sets from every batch in
  the log.

  "COrd" — ciphertext-ordered commit (Config.order_then_settle): u64
  epoch | u32 n_proposers | per proposer, sorted (u32 id_len | id |
  u32 ct_len | ct_bytes) — the agreed ACS output as raw RBC values,
  durable BEFORE threshold decryption runs.  Epoch e's COrd precedes
  its CLOG in the file; a crash between them leaves an ordered-ahead
  epoch that a restart re-enters into the settler (the ordering is
  never re-run).  The body bytes are a pure function of the agreed
  output map, so honest nodes' ordered logs are byte-identical —
  the cross-frontier fuzz invariant.

  "RCFG" — roster switch (dynamic membership): u32 version | u64
  activation_epoch | u32 n_members | per member (u32 id_len | id |
  u32 ip_len | ip | u32 port) | u32 digest_len | key-material digest
  — the durable witness of a finalized reshare ceremony, written
  strictly before any epoch orders under the new roster.  Recovery
  re-derives the ceremony from the replayed CLOG batches (the
  RECONFIG and dealing transactions are ordinary committed txs) and
  cross-checks the result against these records.

A torn tail (crash mid-append) is detected by length/CRC and
truncated away on open.  The fsync-on-commit policy is
Config.ledger_fsync.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from cleisthenes_tpu_torch.core.batch import Batch
from cleisthenes_tpu_torch.utils.determinism import guarded_by
from cleisthenes_tpu_torch.utils.lockcheck import new_lock

_MAGIC = b"CLOG"
_MAGIC_CKPT = b"CCKP"
_MAGIC_ORD = b"COrd"
_MAGIC_RCFG = b"RCFG"
# Lane-tagged twins (horizontal shard-out): lanes > 0 of an
# S-lane node share ONE log file with lane 0, appending records whose
# body is ``u32 lane | <the lane-agnostic body>`` under these magics.
# Lane 0 keeps the bare magics above, so a lanes=1 log — and lane 0's
# stream inside an S-lane log — stays byte-identical to the pre-lane
# format, and the bare replay()/replay_ordered() iterators (which
# filter by magic) never see lane traffic.  Per-lane recovery goes
# through ``BatchLog.lane_view(lane)``.
_MAGIC_LANE = b"LCLG"
_MAGIC_LANE_CKPT = b"LCKP"
_MAGIC_LANE_ORD = b"LOrd"


def encode_batch_body(epoch: int, batch: Batch) -> bytes:
    """The CRC-covered record body: (epoch, contributions).  Also the
    payload of CATCHUP responses (transport.message
    CatchupRespPayload), so a caught-up batch round-trips through the
    exact bytes a local commit would have logged — and f+1 "identical
    bodies" means f+1 identical LOG RECORDS."""
    return _encode_body(epoch, batch)


def decode_batch_body(body: bytes) -> Tuple[int, Batch]:
    return _decode_body(body)


def encode_ordered_body(epoch: int, output: Dict[str, bytes]) -> bytes:
    """The COrd record body: the epoch's agreed {proposer: raw RBC
    value} map in sorted-proposer order.  Deterministic bytes for a
    given ACS output — also the payload of ordered CATCHUP responses
    (transport.message.CatchupOrdPayload), so f+1 "identical bodies"
    means f+1 identical ORDERING records."""
    out: List[bytes] = [struct.pack(">Q", epoch)]
    out.append(struct.pack(">I", len(output)))
    for proposer in sorted(output):
        pid = proposer.encode("utf-8")
        out.append(struct.pack(">I", len(pid)))
        out.append(pid)
        ct = output[proposer]
        out.append(struct.pack(">I", len(ct)))
        out.append(ct)
    return b"".join(out)


def decode_ordered_body(body: bytes) -> Tuple[int, Dict[str, bytes]]:
    off = 0

    def u32() -> int:
        nonlocal off
        (v,) = struct.unpack_from(">I", body, off)
        off += 4
        return v

    (epoch,) = struct.unpack_from(">Q", body, off)
    off += 8
    output: Dict[str, bytes] = {}
    for _ in range(u32()):
        id_len = u32()
        proposer = body[off : off + id_len].decode("utf-8")
        off += id_len
        ct_len = u32()
        output[proposer] = body[off : off + ct_len]
        off += ct_len
    if off != len(body):
        raise ValueError("trailing bytes in ordered record")
    return epoch, output


def encode_reconfig_body(
    version: int,
    activation_epoch: int,
    members: Sequence[Tuple[str, str, int]],
    key_digest: bytes,
) -> bytes:
    """The RCFG record body: a committed roster switch — version,
    activation epoch, the (id, ip, port) member table and the
    key-material digest.  Written when a reshare ceremony finalizes,
    BEFORE the first epoch ordered under the new roster, so crash
    recovery replays the switch deterministically (the ceremony
    re-derives from replayed CLOG batches; the RCFG record is the
    durable witness recovery cross-checks against)."""
    out: List[bytes] = [
        struct.pack(">IQ", version, activation_epoch),
        struct.pack(">I", len(members)),
    ]
    for mid, ip, port in members:
        b_id = mid.encode("utf-8")
        b_ip = ip.encode("utf-8")
        out.append(struct.pack(">I", len(b_id)))
        out.append(b_id)
        out.append(struct.pack(">I", len(b_ip)))
        out.append(b_ip)
        out.append(struct.pack(">I", port))
    out.append(struct.pack(">I", len(key_digest)))
    out.append(key_digest)
    return b"".join(out)


def decode_reconfig_body(
    body: bytes,
) -> Tuple[int, int, List[Tuple[str, str, int]], bytes]:
    off = 0
    version, activation = struct.unpack_from(">IQ", body, off)
    off += 12

    def u32() -> int:
        nonlocal off
        (v,) = struct.unpack_from(">I", body, off)
        off += 4
        return v

    members: List[Tuple[str, str, int]] = []
    for _ in range(u32()):
        id_len = u32()
        mid = body[off : off + id_len].decode("utf-8")
        off += id_len
        ip_len = u32()
        ip = body[off : off + ip_len].decode("utf-8")
        off += ip_len
        port = u32()
        members.append((mid, ip, port))
    dig_len = u32()
    key_digest = body[off : off + dig_len]
    off += dig_len
    if off != len(body):
        raise ValueError("trailing bytes in reconfig record")
    return version, activation, members, key_digest


def _encode_body(epoch: int, batch: Batch) -> bytes:
    out: List[bytes] = [struct.pack(">Q", epoch)]
    contributions = batch.contributions
    out.append(struct.pack(">I", len(contributions)))
    for proposer in sorted(contributions):
        pid = proposer.encode("utf-8")
        out.append(struct.pack(">I", len(pid)))
        out.append(pid)
        txs = contributions[proposer]
        out.append(struct.pack(">I", len(txs)))
        for tx in txs:
            out.append(struct.pack(">I", len(tx)))
            out.append(tx)
    return b"".join(out)


def _frame_record(magic: bytes, body: bytes) -> bytes:
    return (
        magic
        + struct.pack(">I", len(body))
        + body
        + struct.pack(">I", zlib.crc32(body))
    )


def _encode_record(epoch: int, batch: Batch) -> bytes:
    return _frame_record(_MAGIC, _encode_body(epoch, batch))


def _encode_checkpoint_body(
    epoch: int, history: Sequence[Set[bytes]]
) -> bytes:
    out: List[bytes] = [
        struct.pack(">Q", epoch),
        struct.pack(">I", len(history)),
    ]
    for seen in history:
        out.append(struct.pack(">I", len(seen)))
        for tx in sorted(seen):  # deterministic bytes for a given set
            out.append(struct.pack(">I", len(tx)))
            out.append(tx)
    return b"".join(out)


def _decode_checkpoint_body(body: bytes) -> Tuple[int, List[Set[bytes]]]:
    off = 0

    def u32() -> int:
        nonlocal off
        (v,) = struct.unpack_from(">I", body, off)
        off += 4
        return v

    (epoch,) = struct.unpack_from(">Q", body, off)
    off += 8
    history: List[Set[bytes]] = []
    for _ in range(u32()):
        seen: Set[bytes] = set()
        for _ in range(u32()):
            tx_len = u32()
            seen.add(body[off : off + tx_len])
            off += tx_len
        history.append(seen)
    if off != len(body):
        raise ValueError("trailing bytes in checkpoint record")
    return epoch, history


def _decode_body(body: bytes) -> Tuple[int, Batch]:
    off = 0

    def u32() -> int:
        nonlocal off
        (v,) = struct.unpack_from(">I", body, off)
        off += 4
        return v

    (epoch,) = struct.unpack_from(">Q", body, off)
    off += 8
    contributions: Dict[str, List[bytes]] = {}
    for _ in range(u32()):
        id_len = u32()
        proposer = body[off : off + id_len].decode("utf-8")
        off += id_len
        txs: List[bytes] = []
        for _ in range(u32()):
            tx_len = u32()
            txs.append(body[off : off + tx_len])
            off += tx_len
        contributions[proposer] = txs
    if off != len(body):
        raise ValueError("trailing bytes in ledger record")
    return epoch, Batch(contributions=contributions)


def _lane_body(lane: int, body: bytes) -> bytes:
    return struct.pack(">I", lane) + body


def _split_lane_body(body: bytes) -> Tuple[int, bytes]:
    if len(body) < 4:
        raise ValueError("lane record body too short")
    (lane,) = struct.unpack_from(">I", body, 0)
    return lane, body[4:]


@guarded_by(
    "_lock", "_fh", "_last_epoch", "_last_checkpoint",
    "_last_ordered_epoch", "_lane_last_epoch", "_lane_last_ordered",
    "_lane_last_checkpoint",
)
class BatchLog:
    """Append-only durable log of committed batches.

    One lock guards the file handle and the recovered-state fields
    (commit path and CATCHUP serving run on different threads under
    the gRPC transport); ``*_locked`` methods assume the caller —
    or single-threaded construction — already holds exclusivity."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = new_lock()
        self._last_epoch: Optional[int] = None
        self._last_checkpoint: Optional[Tuple[int, List[Set[bytes]]]] = None
        self._last_ordered_epoch: Optional[int] = None
        # per-lane recovered state for lanes > 0 (lane 0 uses the bare
        # fields above); populated by _recover_locked and the lane
        # append paths, read through lane_view()
        self._lane_last_epoch: Dict[int, int] = {}
        self._lane_last_ordered: Dict[int, int] = {}
        self._lane_last_checkpoint: Dict[
            int, Tuple[int, List[Set[bytes]]]
        ] = {}
        # flight recorder (utils/trace.py), set by the owning node
        # when Config.trace is on: every append/checkpoint records a
        # "ledger" span (write+flush+fsync cost is a real commit-path
        # stage).  None = tracing off.
        self.trace = None
        # held even in __init__: the static rules exempt constructors,
        # but the runtime sanitizer (CLEISTHENES_LOCKCHECK=1) walks
        # into _recover_locked's own frame, which is not exempt
        with self._lock:
            self._recover_locked()
            self._fh = open(path, "ab")

    @staticmethod
    def _scan(data: bytes) -> Iterator[Tuple[int, bytes, bytes]]:
        """Walk validated records: yields (end_offset, magic, body) for
        every record whose framing, CRC and body parse check out,
        stopping at the first torn/corrupt one.  The single source of
        framing truth for both recovery and replay."""
        off = 0
        while off + 8 <= len(data):
            magic = data[off : off + 4]
            if (
                magic != _MAGIC
                and magic != _MAGIC_CKPT
                and magic != _MAGIC_ORD
                and magic != _MAGIC_RCFG
                and magic != _MAGIC_LANE
                and magic != _MAGIC_LANE_ORD
                and magic != _MAGIC_LANE_CKPT
            ):
                return
            (body_len,) = struct.unpack_from(">I", data, off + 4)
            end = off + 8 + body_len + 4
            if end > len(data):
                return
            body = data[off + 8 : off + 8 + body_len]
            (crc,) = struct.unpack_from(">I", data, off + 8 + body_len)
            if zlib.crc32(body) != crc:
                return
            try:
                if magic == _MAGIC:
                    _decode_body(body)
                elif magic == _MAGIC_ORD:
                    decode_ordered_body(body)
                elif magic == _MAGIC_RCFG:
                    decode_reconfig_body(body)
                elif magic == _MAGIC_LANE:
                    _decode_body(_split_lane_body(body)[1])
                elif magic == _MAGIC_LANE_ORD:
                    decode_ordered_body(_split_lane_body(body)[1])
                elif magic == _MAGIC_LANE_CKPT:
                    _decode_checkpoint_body(_split_lane_body(body)[1])
                else:
                    _decode_checkpoint_body(body)
            except (ValueError, struct.error, UnicodeDecodeError):
                return
            yield end, magic, body
            off = end

    def _recover_locked(self) -> None:
        """Scan the log, truncating any torn tail (construction-time:
        the instance is not shared yet)."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as fh:
            data = fh.read()
        good_end = 0
        for end, magic, body in self._scan(data):
            if magic == _MAGIC:
                self._last_epoch, _ = _decode_body(body)
            elif magic == _MAGIC_ORD:
                (self._last_ordered_epoch,) = struct.unpack_from(
                    ">Q", body, 0
                )
            elif magic == _MAGIC_CKPT:
                epoch, history = _decode_checkpoint_body(body)
                self._last_checkpoint = (epoch, history)
            elif magic == _MAGIC_LANE:
                lane, inner = _split_lane_body(body)
                self._lane_last_epoch[lane], _ = _decode_body(inner)
            elif magic == _MAGIC_LANE_ORD:
                lane, inner = _split_lane_body(body)
                (self._lane_last_ordered[lane],) = struct.unpack_from(
                    ">Q", inner, 0
                )
            elif magic == _MAGIC_LANE_CKPT:
                lane, inner = _split_lane_body(body)
                self._lane_last_checkpoint[lane] = _decode_checkpoint_body(
                    inner
                )
            # RCFG records are consumed via replay_reconfigs()
            good_end = end
        if good_end < len(data):  # torn/corrupt tail: drop it
            with open(self.path, "r+b") as fh:
                fh.truncate(good_end)

    def _append_record_locked(self, rec: bytes) -> None:
        self._fh.write(rec)
        self._fh.flush()
        if self.fsync:
            # fsync=True deployments opt into blocking the dispatcher
            # until the batch is on disk (crash recovery needs the
            # barrier); the cost is traced as a "ledger" span
            fd = self._fh.fileno()
            os.fsync(fd)  # staticcheck: allow[CONC004] durable-commit barrier, fsync=True opt-in

    def append(self, epoch: int, batch: Batch) -> None:
        rec = _encode_record(epoch, batch)
        tr = self.trace
        t0 = 0.0 if tr is None else tr.now()
        with self._lock:
            self._append_record_locked(rec)
            self._last_epoch = epoch
        if tr is not None:
            tr.complete(
                "ledger", "wal_append", t0, epoch=epoch, bytes=len(rec)
            )

    def append_ordered(self, epoch: int, output: Dict[str, bytes]) -> bytes:
        """Durably record ``epoch``'s ciphertext-ordered commit (the
        agreed ACS output) BEFORE threshold decryption runs — the
        ordered frontier's WAL write (Config.order_then_settle).
        Returns the encoded body (the bytes CATCHUP serves and the
        cross-node byte-identity invariant compares)."""
        body = encode_ordered_body(epoch, output)
        self.append_ordered_body(epoch, body)
        return body

    def append_ordered_body(self, epoch: int, body: bytes) -> None:
        """``append_ordered`` for a body already in hand (a COrd
        catch-up adoption): the WAL persists the EXACT bytes the
        quorum agreed on, so the durable record, the catch-up serving
        store, and the fuzzer's byte-identity witness can never
        diverge."""
        rec = _frame_record(_MAGIC_ORD, body)
        tr = self.trace
        t0 = 0.0 if tr is None else tr.now()
        with self._lock:
            self._append_record_locked(rec)
            self._last_ordered_epoch = epoch
        if tr is not None:
            tr.complete(
                "ledger", "wal_ordered", t0, epoch=epoch, bytes=len(rec)
            )

    def append_checkpoint(
        self, epoch: int, history: Sequence[Set[bytes]]
    ) -> None:
        """Snapshot the bounded dedup window (oldest epoch-set first)
        as of ``epoch``'s commit.  A torn checkpoint truncates away on
        the next open exactly like a torn batch record."""
        rec = _frame_record(
            _MAGIC_CKPT, _encode_checkpoint_body(epoch, history)
        )
        tr = self.trace
        t0 = 0.0 if tr is None else tr.now()
        with self._lock:
            self._append_record_locked(rec)
            self._last_checkpoint = (epoch, [set(s) for s in history])
        if tr is not None:
            tr.complete(
                "ledger", "wal_checkpoint", t0, epoch=epoch, bytes=len(rec)
            )

    def append_reconfig(
        self,
        version: int,
        activation_epoch: int,
        members: Sequence[Tuple[str, str, int]],
        key_digest: bytes,
    ) -> None:
        """Durably record a finalized roster switch (dynamic
        membership): written when the reshare ceremony completes,
        strictly BEFORE any epoch orders under the new roster."""
        rec = _frame_record(
            _MAGIC_RCFG,
            encode_reconfig_body(
                version, activation_epoch, members, key_digest
            ),
        )
        tr = self.trace
        t0 = 0.0 if tr is None else tr.now()
        with self._lock:
            self._append_record_locked(rec)
        if tr is not None:
            tr.complete(
                "ledger",
                "wal_reconfig",
                t0,
                version=version,
                activation_epoch=activation_epoch,
            )

    def replay_reconfigs(
        self,
    ) -> Iterator[Tuple[int, int, List[Tuple[str, str, int]], bytes]]:
        """All (version, activation_epoch, members, key_digest)
        reconfig records, oldest first — recovery's cross-check that
        the ceremony re-derived from the replayed batches matches what
        the crashed process had durably switched to."""
        with open(self.path, "rb") as fh:
            data = fh.read()
        for _end, magic, body in self._scan(data):
            if magic == _MAGIC_RCFG:
                yield decode_reconfig_body(body)

    def replay(self) -> Iterator[Tuple[int, Batch]]:
        """All committed (epoch, batch) records, oldest first
        (checkpoint records are skipped — see ``last_checkpoint``)."""
        with open(self.path, "rb") as fh:
            data = fh.read()
        for _end, magic, body in self._scan(data):
            if magic == _MAGIC:
                yield _decode_body(body)

    def replay_ordered(self) -> Iterator[Tuple[int, bytes]]:
        """All ciphertext-ordered (epoch, COrd body) records, oldest
        first.  A restart settles ordered-ahead epochs (COrd with no
        matching CLOG yet) from here — the ordering is never re-run."""
        with open(self.path, "rb") as fh:
            data = fh.read()
        for _end, magic, body in self._scan(data):
            if magic == _MAGIC_ORD:
                (epoch,) = struct.unpack_from(">Q", body, 0)
                yield epoch, body

    @property
    def last_epoch(self) -> Optional[int]:
        with self._lock:
            return self._last_epoch

    @property
    def last_ordered_epoch(self) -> Optional[int]:
        """Epoch of the newest COrd record, or None when the log holds
        no (intact) ordered record."""
        with self._lock:
            return self._last_ordered_epoch

    @property
    def last_checkpoint(self) -> Optional[Tuple[int, List[Set[bytes]]]]:
        """(epoch, dedup epoch-sets) of the newest checkpoint record,
        or None when the log holds no (intact) checkpoint."""
        with self._lock:
            return self._last_checkpoint

    def close(self) -> None:
        with self._lock:
            self._fh.close()

    def lane_view(self, lane: int) -> "_LaneLog":
        """The per-lane facade of this log (horizontal shard-out):
        lane 0 is the log itself — its records keep the bare magics,
        byte-identical to a single-lane build — and lanes > 0 get a
        delegating view that appends/replays ``u32 lane``-prefixed
        lane-magic records in the SAME file.  Restart recovery
        re-enters every lane's ordered-unsettled window independently
        by replaying its own view."""
        if lane == 0:
            return self
        return _LaneLog(self, lane)


class _LaneLog:
    """BatchLog facade for one lane > 0: the batch_log API surface the
    protocol plane consumes, with every record lane-tagged and every
    replay/last-* read filtered to this lane.  Shares the parent's
    file handle, lock and trace recorder; ``close()`` is a no-op (the
    lane-0 owner closes the file)."""

    __slots__ = ("_log", "lane")

    def __init__(self, log: BatchLog, lane: int):
        if lane < 1:
            raise ValueError(f"lane view lane={lane} must be >= 1")
        self._log = log
        self.lane = lane

    @property
    def path(self) -> str:
        return self._log.path

    @property
    def fsync(self) -> bool:
        return self._log.fsync

    @property
    def trace(self):
        return self._log.trace

    @trace.setter
    def trace(self, recorder) -> None:
        # lanes share the node's recorder; the primary installs it
        # once on the parent and lane installs are idempotent aliases
        self._log.trace = recorder

    def append(self, epoch: int, batch: Batch) -> None:
        log = self._log
        rec = _frame_record(
            _MAGIC_LANE, _lane_body(self.lane, _encode_body(epoch, batch))
        )
        tr = log.trace
        t0 = 0.0 if tr is None else tr.now()
        with log._lock:
            log._append_record_locked(rec)
            log._lane_last_epoch[self.lane] = epoch
        if tr is not None:
            tr.complete(
                "ledger", "wal_append", t0, epoch=epoch, bytes=len(rec),
                lane=self.lane,
            )

    def append_ordered(self, epoch: int, output: Dict[str, bytes]) -> bytes:
        body = encode_ordered_body(epoch, output)
        self.append_ordered_body(epoch, body)
        return body

    def append_ordered_body(self, epoch: int, body: bytes) -> None:
        log = self._log
        rec = _frame_record(_MAGIC_LANE_ORD, _lane_body(self.lane, body))
        tr = log.trace
        t0 = 0.0 if tr is None else tr.now()
        with log._lock:
            log._append_record_locked(rec)
            log._lane_last_ordered[self.lane] = epoch
        if tr is not None:
            tr.complete(
                "ledger", "wal_ordered", t0, epoch=epoch, bytes=len(rec),
                lane=self.lane,
            )

    def append_checkpoint(
        self, epoch: int, history: Sequence[Set[bytes]]
    ) -> None:
        log = self._log
        rec = _frame_record(
            _MAGIC_LANE_CKPT,
            _lane_body(self.lane, _encode_checkpoint_body(epoch, history)),
        )
        tr = log.trace
        t0 = 0.0 if tr is None else tr.now()
        with log._lock:
            log._append_record_locked(rec)
            log._lane_last_checkpoint[self.lane] = (
                epoch,
                [set(s) for s in history],
            )
        if tr is not None:
            tr.complete(
                "ledger", "wal_checkpoint", t0, epoch=epoch,
                bytes=len(rec), lane=self.lane,
            )

    def append_reconfig(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "dynamic membership is not supported at lanes > 1 "
            "(Config.lanes docs): no RCFG records in lane streams"
        )

    def replay(self) -> Iterator[Tuple[int, Batch]]:
        with open(self._log.path, "rb") as fh:
            data = fh.read()
        for _end, magic, body in self._log._scan(data):
            if magic == _MAGIC_LANE:
                lane, inner = _split_lane_body(body)
                if lane == self.lane:
                    yield _decode_body(inner)

    def replay_ordered(self) -> Iterator[Tuple[int, bytes]]:
        with open(self._log.path, "rb") as fh:
            data = fh.read()
        for _end, magic, body in self._log._scan(data):
            if magic == _MAGIC_LANE_ORD:
                lane, inner = _split_lane_body(body)
                if lane == self.lane:
                    (epoch,) = struct.unpack_from(">Q", inner, 0)
                    yield epoch, inner

    def replay_reconfigs(self):
        return iter(())  # lanes never carry roster switches

    @property
    def last_epoch(self) -> Optional[int]:
        log = self._log
        with log._lock:
            return log._lane_last_epoch.get(self.lane)

    @property
    def last_ordered_epoch(self) -> Optional[int]:
        log = self._log
        with log._lock:
            return log._lane_last_ordered.get(self.lane)

    @property
    def last_checkpoint(self) -> Optional[Tuple[int, List[Set[bytes]]]]:
        log = self._log
        with log._lock:
            return log._lane_last_checkpoint.get(self.lane)

    def close(self) -> None:
        pass  # the lane-0 owner closes the shared file


__all__ = [
    "BatchLog",
    "encode_batch_body",
    "decode_batch_body",
    "encode_ordered_body",
    "decode_ordered_body",
    "encode_reconfig_body",
    "decode_reconfig_body",
]
