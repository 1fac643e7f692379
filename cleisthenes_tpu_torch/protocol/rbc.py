"""RBC: Bracha reliable broadcast with erasure coding + Merkle proofs.

Completes the reference's all-panics skeleton (reference rbc/rbc.go:38-100)
per its own spec (reference docs/RBC-EN.md:28-45):

  propose:  split value into K = N-2f data shards, RS-encode to N
            shards, build a Merkle tree over them, send VAL_j =
            (root h, branch b(j), shard s(j)) to node j
            (rbc/rbc.go:98-100 `shard`; docs/RBC-EN.md:28-33).
  VAL:      (from the proposer only) verify the branch, multicast
            ECHO with the same (h, b(j), s(j)) (docs/RBC-EN.md:34).
  ECHO:     verify branch (rbc/rbc.go:93-95 `validateMessage`); on
            N-f valid ECHOs interpolate from N-2f shards, *recompute
            the root* to catch a Byzantine proposer, then send
            READY(h) (rbc/rbc.go:88-90 `interpolate`;
            docs/RBC-EN.md:35-39).
  READY:    f+1 READY(h) -> send READY(h) if not yet sent; 2f+1
            READY(h) + N-2f verified shards -> decode and deliver
            (docs/RBC-EN.md:41-42).

Crypto never runs on the message path: inbound ECHO proofs park in a
pending pool (one slot per sender) and the decode+root-recheck parks
as a request; the shared ``protocol.hub.CryptoHub`` pulls all pending
work — across every concurrent RBC instance of the epoch — into
batched device dispatches when some instance's quorum threshold makes
results necessary (SURVEY.md §7 hard part 3's per-epoch accumulation
buffers; the reference's N^2-branch-hash cost model is
docs/HONEYBADGER-EN.md:96).  Only the single VAL proof is verified
inline: our own ECHO must go out immediately and nothing else would
trigger a flush that early.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.ops.backend import BatchCrypto
from cleisthenes_tpu_torch.ops.payload import join_payload, split_payload
from cleisthenes_tpu_torch.transport.message import RbcPayload, RbcType

# Per-root shard length sanity cap (a Byzantine proposer must not make
# honest nodes buffer huge shards; envelopes are separately capped by
# transport.message.MAX_FIELD_BYTES).
MAX_SHARD_BYTES = 16 * 1024 * 1024

# id-keyed branch-shape memo: entries hold the branch TUPLE (a few
# hundred bytes — pinning the id against recycling, same discipline as
# the hub's token table) rather than the whole payload, whose shard
# bytes would otherwise keep dead epochs' data resident until the
# wholesale clear at the cap
_BRANCH_SHAPE_MEMO: dict = {}
_BRANCH_SHAPE_MEMO_CAP = 1 << 14


class RBC:
    """One reliable-broadcast instance: (epoch, proposer).

    Mirrors the reference struct (rbc/rbc.go:9-36): n, f, proposer, the
    erasure codec, per-type bookkeeping, and a broadcaster — with the
    request repositories realized as per-root dicts enforcing
    one-vote-per-sender.
    """

    def __init__(
        self,
        *,
        config: Config,
        crypto: BatchCrypto,
        epoch: int,
        proposer: str,
        owner: str,
        member_ids: Sequence[str],
        out,
        hub=None,
        bank=None,
        index=None,
        trace=None,
        metrics=None,
        scope=None,
    ) -> None:
        self.n = config.n
        self.f = config.f
        # READY deliver threshold: 2f+1 baseline, n-f under
        # Config.reduced_quorum (Config.quorum_large)
        self.q_large = config.quorum_large
        self.k = config.data_shards
        self.epoch = epoch
        self.proposer = proposer
        self.owner = owner
        self.members: List[str] = sorted(member_ids)
        if len(self.members) != self.n:
            raise ValueError(
                f"roster size {len(self.members)} != n={self.n}"
            )
        self.crypto = crypto
        self.out = out  # PayloadBroadcaster: broadcast / send_to
        if hub is None:  # standalone use (unit tests): private hub
            from cleisthenes_tpu_torch.protocol.hub import CryptoHub

            hub = CryptoHub(crypto)
        self.hub = hub
        # ECHO/READY receipt state lives in the roster-wide EchoBank
        # (protocol.echobank): ACS shares ONE bank across the epoch's
        # N instances so columnar waves update struct-of-arrays slices;
        # standalone use (unit tests) gets a private single-instance
        # bank — the same arrays, width 1.
        if bank is None:
            from cleisthenes_tpu_torch.protocol.echobank import EchoBank

            bank = EchoBank(
                member_ids, config.f, inst_ids=[proposer], metrics=metrics,
                quorum_large=config.quorum_large,
            )
            index = 0
        self.bank = bank
        self.index = index
        bank.attach(index, self)
        # scope is (owner, epoch): a hub may be SHARED by many
        # in-proc validators (cluster-batched dispatches), and one
        # node advancing epochs must only drop ITS clients.  Lane
        # shard-out (Config.lanes) further qualifies ``scope`` with
        # the lane id — sibling lanes of one node share the hub and
        # run the same epoch numbers concurrently, so epoch GC must
        # be lane-scoped too; at lanes=1, scope == owner.
        self.hub.register((owner if scope is None else scope, epoch), self)
        # flight recorder (None = tracing off; utils/trace.py)
        self.trace = trace
        # owner-node metrics (None in standalone unit tests): only the
        # duplicate-vote absorption counter is touched here
        self.metrics = metrics

        # hook set by ACS: fn(proposer_id, value_bytes)
        self.on_deliver: Optional[Callable[[str, bytes], None]] = None

        self._member_set = frozenset(self.members)
        self._echo_sent = False
        self._ready_root: Optional[bytes] = None  # root we READY'd
        # One ECHO and one READY per sender per *instance* (a correct
        # node sends exactly one of each; reference rbc/request.go:30-42
        # repositories are keyed by ConnId) — the claim/dedup state
        # lives in the EchoBank's [sender, instance] arrays, which also
        # bound the distinct roots an instance ever counts to n.  The
        # slot is claimed at arrival; a sender whose proof later fails
        # verification has burned its one vote.
        # depth of the padded tree the proposer must have built
        # (precomputed: _precheck runs once per delivered ECHO)
        p = 1
        self._depth = 0
        while p < self.n:
            p <<= 1
            self._depth += 1
        # root -> set of verified ECHO senders
        self._echo_senders: Dict[bytes, Set[str]] = {}
        # root -> shard_index -> shard bytes (branch-verified)
        self._shards: Dict[bytes, Dict[int, bytes]] = {}
        self._shard_len: Dict[bytes, int] = {}
        # roots whose decode+recheck is wanted (ready/echo quorum hit)
        self._decode_req: Set[bytes] = set()
        self._bad_roots: Set[bytes] = set()  # failed interpolation recheck
        self._decoded: Dict[bytes, bytes] = {}  # successful decode cache
        self._value: Optional[bytes] = None

    # -- public API (reference rbc/rbc.go:38-76) ---------------------------

    def value(self) -> Optional[bytes]:
        """The delivered value, or None (reference rbc/rbc.go:69-71)."""
        return self._value

    @property
    def delivered(self) -> bool:
        return self._value is not None

    def propose(self, value: bytes) -> None:
        """Shard, build the Merkle tree, send VAL_j to each node j
        (reference rbc/rbc.go:42-44 `broadcast` + :98-100 `shard`)."""
        if self.owner != self.proposer:
            raise ValueError(
                f"{self.owner!r} cannot propose in {self.proposer!r}'s RBC"
            )
        if len(value) > self.k * MAX_SHARD_BYTES - 4 - self.k * 128:
            # shards receivers would reject in _check_proof: fail fast
            raise ValueError(
                f"value of {len(value)} bytes exceeds the "
                f"{self.k} x {MAX_SHARD_BYTES}-byte shard capacity"
            )
        tr = self.trace
        t0 = 0.0 if tr is None else tr.now()
        data = split_payload(value, self.k)
        shards = self.crypto.erasure.encode(data)  # (n, L)
        tree = self.crypto.merkle.build(shards)
        root = tree.root
        if tr is not None:
            tr.complete(
                "rbc", "propose", t0, epoch=self.epoch, bytes=len(value)
            )
        for j, member in enumerate(self.members):
            payload = RbcPayload(
                type=RbcType.VAL,
                proposer=self.proposer,
                epoch=self.epoch,
                root_hash=root,
                branch=tuple(tree.branch(j)),
                shard=shards[j].tobytes(),
                shard_index=j,
            )
            self.out.send_to(member, payload)

    def handle_message(self, sender: str, payload: RbcPayload) -> None:
        """Public entry (reference rbc/rbc.go:46-54)."""
        if not isinstance(payload, RbcPayload):
            return
        if self.delivered or sender not in self._member_set:
            return
        if payload.type == RbcType.VAL:
            self._handle_val(sender, payload)
        elif payload.type == RbcType.ECHO:
            self._handle_echo(sender, payload)
        elif payload.type == RbcType.READY:
            self._handle_ready(sender, payload)

    # -- handlers ----------------------------------------------------------

    def _precheck(self, payload: RbcPayload) -> bool:
        return self._precheck_fields(
            payload.root_hash,
            payload.branch,
            payload.shard,
            payload.shard_index,
        )

    def _precheck_fields(
        self, root: bytes, branch: tuple, shard: bytes, shard_index: int
    ) -> bool:
        """Structural validation — everything except the branch hash
        check itself (reference rbc/rbc.go:93-95 `validateMessage`
        minus the crypto, which the hub batches).

        The branch-shape walk memoizes ON OBJECT IDENTITY: the codec's
        payload memo shares one branch tuple across a broadcast's N
        receivers, so the per-sibling length walk runs once per wire
        payload, not once per delivery (the held tuple pins the id);
        the remaining checks are a handful of scalar compares."""
        if not (0 <= shard_index < self.n):
            return False
        if not (0 < len(shard) <= MAX_SHARD_BYTES):
            return False
        if len(root) != 32:
            return False
        if len(branch) != self._depth:
            return False
        ent = _BRANCH_SHAPE_MEMO.get(id(branch))
        if ent is not None and ent[0] is branch:
            ok = ent[1]
        else:
            ok = all(len(b) == 32 for b in branch)
            if len(_BRANCH_SHAPE_MEMO) >= _BRANCH_SHAPE_MEMO_CAP:
                _BRANCH_SHAPE_MEMO.clear()
            _BRANCH_SHAPE_MEMO[id(branch)] = (branch, ok)
        if not ok:
            return False
        # Shards of one root must agree on length (RS needs a matrix).
        # _shard_len only ever holds BRANCH-VERIFIED lengths (set in
        # _handle_val after _check_proof and in _make_echo_cb), so an
        # unverified Byzantine ECHO cannot poison the expectation and
        # wedge honest traffic (ADVICE.md high finding).
        want_len = self._shard_len.get(root)
        if want_len is not None and len(shard) != want_len:
            return False
        return True

    def _check_proof(self, payload: RbcPayload) -> bool:
        """Full inline verification (VAL only — ECHO proofs batch
        through the hub).  The one sanctioned direct crypto call in
        protocol/: a single proposer branch per instance, and the ECHO
        reply cannot wait for a wave."""
        if not self._precheck(payload):
            return False
        return self.crypto.merkle.verify_branch(  # staticcheck: allow[DET003] inline VAL check
            payload.root_hash,
            payload.shard,
            list(payload.branch),
            payload.shard_index,
        )

    def _handle_val(self, sender: str, payload: RbcPayload) -> None:
        """docs/RBC-EN.md:34 — echo the received (h, b(j), s(j)) to all.

        Only the proposer may send VAL, and only the first one counts
        (reference rbc/rbc.go:56-58)."""
        if sender != self.proposer or self._echo_sent:
            return
        if not self._check_proof(payload):
            return
        # verified: this length is now the root's authoritative one
        self._shard_len.setdefault(payload.root_hash, len(payload.shard))
        self._echo_sent = True
        if self.trace is not None:
            self.trace.instant(
                "rbc", "val", epoch=self.epoch, proposer=self.proposer
            )
        self.out.broadcast(
            RbcPayload(
                type=RbcType.ECHO,
                proposer=self.proposer,
                epoch=self.epoch,
                root_hash=payload.root_hash,
                branch=payload.branch,
                shard=payload.shard,
                shard_index=payload.shard_index,
            )
        )

    def _handle_echo(self, sender: str, payload: RbcPayload) -> None:
        self.handle_echo_fast(
            sender,
            payload.root_hash,
            payload.branch,
            payload.shard,
            payload.shard_index,
        )

    def handle_echo_fast(
        self,
        sender: str,
        root: bytes,
        branch: tuple,
        shard: bytes,
        shard_index: int,
    ) -> None:
        """docs/RBC-EN.md:35-39 (reference rbc/rbc.go:60-62) — the
        field-level scalar entry; the columnar EchoBatchPayload path
        runs the same claim through EchoBank.batch_echo, which hoists
        the dedup/delivered/membership filters into vectorized row
        operations and calls ``_echo_item`` per surviving item."""
        bank = self.bank
        si = bank.sidx.get(sender)
        if si is None:
            return
        if bank.echo_seen[si, self.index]:  # one ECHO per sender
            if self.metrics is not None:
                self.metrics.dedup_absorbed.inc()
            return
        self._echo_item(si, sender, root, branch, shard, shard_index)

    def _echo_item(
        self,
        si: int,
        sender: str,
        root: bytes,
        branch: tuple,
        shard: bytes,
        shard_index: int,
    ) -> None:
        """Claim + park one deduped ECHO (the per-item protocol logic
        under both delivery paths).  The branch proof is NOT verified
        here: the proof parks in the bank's contiguous pending slot
        and verifies in the hub's next batched dispatch — triggered
        below the moment this root could reach its N-f quorum."""
        if not self._precheck_fields(root, branch, shard, shard_index):
            return
        bank = self.bank
        # slot claimed; burns if the proof later fails verification
        pot = bank.echo_claim(self.index, si, root)
        bank.pending[self.index].append(
            (root, sender, shard, shard_index, branch)
        )
        self.hub.mark_dirty(self)
        if (
            pot >= self.n - self.f
            and self._ready_root is None
            and root not in self._bad_roots
        ):
            self.hub.request_flush()
        self._maybe_deliver(root)

    def handle_ready_root(self, sender: str, root: bytes) -> None:
        """READY without a payload object (columnar batch path) —
        guards mirror handle_message's."""
        if self.delivered or sender not in self._member_set:
            return
        self._handle_ready_root(sender, root)

    def _handle_ready(self, sender: str, payload: RbcPayload) -> None:
        """docs/RBC-EN.md:41-42 (reference rbc/rbc.go:64-66)."""
        self._handle_ready_root(sender, payload.root_hash)

    def _handle_ready_root(self, sender: str, root: bytes) -> None:
        if len(root) != 32:
            return
        bank = self.bank
        si = bank.sidx.get(sender)
        if si is None:
            return
        cnt = bank.ready_add(self.index, si, root)
        if cnt is None:  # one READY per sender (dedup counted in bank)
            return
        # f+1 READY(h) -> relay READY(h) once (amplification step)
        if cnt >= self.f + 1 and self._ready_root is None:
            self._send_ready(root)
        self._maybe_deliver(root)

    # -- quorum actions ----------------------------------------------------

    def _send_ready(self, root: bytes) -> None:
        self._ready_root = root
        if self.trace is not None:
            # fires at most once per instance (_ready_root gates every
            # caller): the READY quorum-crossing marker
            self.trace.instant(
                "rbc", "ready", epoch=self.epoch, proposer=self.proposer
            )
        self.out.broadcast(
            RbcPayload(
                type=RbcType.READY,
                proposer=self.proposer,
                epoch=self.epoch,
                root_hash=root,
            )
        )

    def _request_decode(self, root: bytes) -> None:
        """Ask the hub for interpolate + re-encode + root recheck
        (docs/RBC-EN.md:37-39) at its next flush."""
        if (
            root in self._decoded
            or root in self._bad_roots
            or root in self._decode_req
        ):
            return
        self._decode_req.add(root)
        if self.trace is not None:
            # the ECHO-quorum crossing: a decode+recheck became wanted
            self.trace.instant(
                "rbc",
                "echo_quorum",
                epoch=self.epoch,
                proposer=self.proposer,
            )
        self.hub.mark_dirty(self)

    def _maybe_deliver(self, root: bytes) -> None:
        """q_large READY(h) + N-2f verified shards -> deliver
        (docs/RBC-EN.md:41-42; q_large = 2f+1 baseline, n-f reduced)."""
        if self.delivered:
            return
        if self.bank.ready_count(self.index, root) < self.q_large:
            return
        value = self._decoded.get(root)
        if value is None:
            # decode (or the shard verifications feeding it) is still
            # pending: stage the request and flush if work exists
            self._request_decode(root)
            if root in self._decode_req or self.bank.pending[self.index]:
                self.hub.request_flush()
            if self.delivered:
                return  # the flush's quorum pass delivered already
            value = self._decoded.get(root)
            if value is None:
                return
        self._value = value
        if self.trace is not None:
            self.trace.instant(
                "rbc",
                "deliver",
                epoch=self.epoch,
                proposer=self.proposer,
                bytes=len(value),
            )
        # free per-root buffers; the instance is terminal now — the
        # bank's sentinel row drops every later vote vectorized
        self._shards.clear()
        self._echo_senders.clear()
        self._decode_req.clear()
        self.bank.deactivate(self.index)
        if self.on_deliver is not None:
            self.on_deliver(self.proposer, value)

    # -- hub client protocol (protocol.hub.CryptoHub) ----------------------

    def drain_pending(self, wave) -> None:
        """Move pending crypto work into the wave's typed columns
        (protocol.hub.HubWave): every parked ECHO proof as a branch
        item, every staged decode whose matrix is complete as a decode
        item (shard BYTES in index order — the hub builds each unique
        matrix once instead of one np.stack per client)."""
        pend = self.bank.pending[self.index]
        if self.delivered or not (pend or self._decode_req):
            return  # fast path: the hub may drain a client twice/round
        # pending ECHO proofs -> batched branch verification: the
        # bank's contiguous arrival-order slot pops WHOLESALE into the
        # wave's branch columns (no per-root dict walk)
        if pend:
            self.bank.pending[self.index] = []
            add = wave.add_branch
            for root, sender, shard, sidx, branch in pend:
                add(
                    self,
                    root,
                    shard,
                    branch,
                    sidx,
                    (root, sender, shard, sidx),
                )
        # staged decode requests with enough verified shards; sorted:
        # _decode_req is a set of 32-byte roots, and its hash order
        # (PYTHONHASHSEED-dependent) would otherwise decide decode
        # batching and READY emission order across instances
        for root in sorted(self._decode_req):
            if root in self._decoded or root in self._bad_roots:
                self._decode_req.discard(root)
                continue
            shards_map = self._shards.get(root, {})
            if len(shards_map) < self.k:
                continue  # stays staged until shards verify
            self._decode_req.discard(root)
            idxs = tuple(sorted(shards_map)[: self.k])
            wave.add_decode(
                root,
                idxs,
                [shards_map[i] for i in idxs],
                self._make_decode_cb(root),
                n=self.n,
            )

    def on_branch_verdicts(self, ctxs, oks) -> None:
        """Bulk ECHO-branch verdicts from the hub (one call per flush
        instead of a per-echo closure — at N=64 the closures alone
        were ~1.8 s of an epoch).  ctx = (root, sender, shard, sidx).

        A root crossing its N-f echo quorum here stages its decode
        request IMMEDIATELY (not in after_crypto_flush): the hub
        re-drains verdict-marked clients before running the round's
        decode column, so the decode rides THIS wave's single decode
        dispatch instead of a follow-on round's."""
        if self.delivered:
            return
        shard_len = self._shard_len
        echo_senders = self._echo_senders
        shards = self._shards
        re_mark = False
        for (root, sender, shard, sidx), ok in zip(ctxs, oks):
            if not ok:
                # invalid: the sender's one slot stays burned, but the
                # claim leaves the bank's quorum POTENTIAL — otherwise
                # f parked forgeries would push pot past n-f forever
                # and every later honest echo would request a flush
                self.bank.echo_drop(self.index, root)
                continue
            # length authority comes only from verified shards; a
            # verified shard conflicting with the established length
            # is a Byzantine proposer mixing lengths under one tree —
            # drop it, RS needs a rectangular matrix
            want = shard_len.setdefault(root, len(shard))
            if len(shard) != want:
                self.bank.echo_drop(self.index, root)
                continue
            echo_senders.setdefault(root, set()).add(sender)
            shards.setdefault(root, {})[sidx] = shard
            re_mark = True
        if not re_mark:
            return
        # stage any echo-quorum decode now (same guards as
        # after_crypto_flush; _request_decode dedups staged roots)
        if self._ready_root is None:
            quorum = self.n - self.f
            for root, senders in echo_senders.items():
                if len(senders) >= quorum and root not in self._bad_roots:
                    self._request_decode(root)
        # a staged decode may just have reached k shards — stay on
        # the hub's dirty list so this wave round (or the next)
        # collects it (no decode staged -> nothing new to offer)
        if self._decode_req:
            self.hub.mark_dirty(self)

    def _make_decode_cb(self, root: bytes):
        def cb(data) -> None:
            if data is None:
                self._bad_roots.add(root)
                return
            try:
                self._decoded[root] = join_payload(data)
            except ValueError:  # corrupt length framing from proposer
                self._bad_roots.add(root)

        return cb

    def after_crypto_flush(self) -> None:
        """Quorum logic over freshly-verified state; new decode
        requests staged here are picked up by the flush loop's next
        collection round."""
        if self.delivered:
            return
        # N-f verified ECHOs -> stage decode (READY follows a
        # successful root recheck, docs/RBC-EN.md:35-39)
        for root, senders in list(self._echo_senders.items()):
            if (
                len(senders) >= self.n - self.f
                and self._ready_root is None
                and root not in self._bad_roots
            ):
                self._request_decode(root)
                if root in self._decoded:
                    self._send_ready(root)
        for root in list(self._decoded):
            if (
                self._ready_root is None
                and len(self._echo_senders.get(root, ())) >= self.n - self.f
            ):
                self._send_ready(root)
        for root in self.bank.ready_roots(self.index):
            if self.delivered:
                break
            self._maybe_deliver(root)


__all__ = ["RBC", "MAX_SHARD_BYTES"]
