"""EchoBank: vectorized ECHO/READY receipt state across RBC instances.

An epoch runs N concurrent RBC instances (one per proposer,
docs/HONEYBADGER-EN.md:85-89), and within one wave a sender emits one
ECHO and one READY per instance — the coalescer ships them as ONE
columnar payload each (transport.message EchoBatchPayload /
ReadyBatchPayload).  Per-instance scalar processing of such a wave
costs O(N) python set/dict operations per (sender, receiver) frame;
after the hub moved dispatch off the critical path, this per-payload
receipt mass is what the critical-path reports attribute to the
delivery plane (ROADMAP "Async-path wall clock").

The bank is the VoteBank treatment applied to RBC: one
struct-of-arrays per ACS holding every instance's ECHO/READY receipt
state, so a columnar wave's dedup, membership, delivered-instance
filtering and quorum counting run as a handful of numpy row operations,
and only threshold CROSSINGS (f+1 READY relay, 2f+1 deliver probe, the
N-f echo-quorum flush request — a constant number per instance) fall
back to the per-instance protocol logic in RBC.

Array layouts put the wave's axis LAST: receipt state is indexed
``seen[sender, instance]`` so one frame's dedup probe is a contiguous
row, and delivered/halted instances fold into ONE ``state`` vector (a
huge sentinel — every later delivery for them drops in the same
vectorized filter, before any python-level dispatch).

Quorum counting is per (root, instance): distinct Merkle roots map to
rows of the counting matrices through a registry, so a Byzantine
proposer equivocating different roots to different receivers keeps
fully separate counters — the bank can never conflate two roots'
quorums (the Equivocator coalition runs against exactly this).
Registry growth is bounded by the one-vote-per-(sender, instance)
claim discipline: at most senders x instances distinct roots can ever
be counted.

Pending (hub-unverified) ECHO proofs park per instance in contiguous
arrival-order lists — ``pending[instance]`` — which RBC.drain_pending
pops WHOLESALE into the hub wave's branch columns, replacing the old
per-root dict-of-dicts walk with one list handoff.

Consistency contract: the bank is the SINGLE source of truth for
ECHO/READY receipt state.  RBC's scalar path (per-payload deliveries,
unit tests, non-columnar transports) writes through the same arrays,
so columnar and scalar deliveries interleave freely and the
``Config.delivery_columnar`` transport arms cannot diverge here.

Quorum semantics mirrored from RBC (docs/RBC-EN.md:35-42): +1
increments under one-vote-per-sender dedup make exact-equality
crossing detection (cnt == f+1) equivalent to the
>=-with-idempotent-guard scalar form; the 2f+1 deliver probe stays >=
because decode completion re-probes ride later arrivals.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Byzantine batches can mint unlimited distinct proposer tuples; the
# index cache clears wholesale at the cap (honest traffic reuses a
# handful of tuples per wave).
_PROP_CACHE_CAP = 4096

# state sentinel for delivered/halted instances: live instances sit at
# 0, so one vectorized compare drops every late vote for a terminal
# instance (same discipline as votebank._HALTED)
_HALTED = 1 << 62


class EchoBank:
    """Struct-of-arrays ECHO/READY receipt state for up to ``n_inst``
    RBC instances over a fixed roster."""

    def __init__(
        self,
        member_ids: Sequence[str],
        f: int,
        inst_ids: Optional[Sequence[str]] = None,
        metrics=None,
        quorum_large: Optional[int] = None,
    ) -> None:
        self.members: List[str] = sorted(member_ids)
        self.f = f
        # the READY deliver threshold: 2f+1 in the baseline trust
        # model, n-f under Config.reduced_quorum (identical whenever
        # n = 3f+1 exactly — see Config.quorum_large)
        self.q_large = 2 * f + 1 if quorum_large is None else quorum_large
        # owner-node metrics (None in standalone unit tests): only the
        # duplicate-vote absorption counter is touched here
        self.metrics = metrics
        self.sidx: Dict[str, int] = {
            m: i for i, m in enumerate(self.members)
        }
        insts = self.members if inst_ids is None else list(inst_ids)
        self.iidx: Dict[str, int] = {p: i for i, p in enumerate(insts)}
        ns, n_inst = len(self.members), len(insts)
        # [sender, instance]: one frame's dedup probe is a contiguous
        # row (wave axis last, like votebank.bval_seen)
        self.echo_seen = np.zeros((ns, n_inst), dtype=bool)
        self.ready_seen = np.zeros((ns, n_inst), dtype=bool)
        # 0 = live; _HALTED once the instance delivered — the
        # vectorized stale filter every batch entry applies first
        self.state = np.zeros(n_inst, dtype=np.int64)
        self.rbcs: List[object] = [None] * n_inst
        # pending (unverified) ECHO proofs per instance, contiguous
        # arrival order: (root, sender, shard, shard_index, branch).
        # RBC.drain_pending pops a slot wholesale into hub columns.
        self.pending: List[list] = [[] for _ in range(n_inst)]
        # root registry: distinct root bytes -> row of the counting
        # matrices.  Bounded by the claim discipline (a row is only
        # ever allocated for a vote that claimed its one
        # (sender, instance) slot), so <= senders x instances rows.
        self._root_rows: Dict[bytes, int] = {}
        cap0 = max(4, n_inst)
        # [root_row, instance] quorum counters, wave axis last:
        # echo_pot counts CLAIMED echoes (pending + verified — the
        # flush-trigger potential), ready_cnt distinct READY senders
        self.echo_pot = np.zeros((cap0, n_inst), dtype=np.int32)
        self.ready_cnt = np.zeros((cap0, n_inst), dtype=np.int32)
        self._prop_cache: "Dict[tuple, Tuple[np.ndarray, np.ndarray, bool]]" = {}

    # -- membership --------------------------------------------------------

    def attach(self, index: int, rbc) -> None:
        self.rbcs[index] = rbc

    def deactivate(self, index: int) -> None:
        """Delivered/halted instance: every later delivery for it
        drops in the vectorized state filter, and its pending slot is
        released (the instance is terminal — nothing will drain it)."""
        self.state[index] = _HALTED
        self.pending[index] = []

    # -- root registry -----------------------------------------------------

    def _row(self, root: bytes) -> int:
        row = self._root_rows.get(root)
        if row is None:
            row = len(self._root_rows)
            self._root_rows[root] = row
            if row >= self.echo_pot.shape[0]:
                grow = self.echo_pot.shape[0]
                self.echo_pot = np.vstack(
                    (self.echo_pot, np.zeros_like(self.echo_pot[:grow]))
                )
                self.ready_cnt = np.vstack(
                    (self.ready_cnt, np.zeros_like(self.ready_cnt[:grow]))
                )
        return row

    # -- scalar write-through (RBC's non-columnar path) --------------------

    def echo_claim(self, index: int, sender_idx: int, root: bytes) -> int:
        """Claim one sender's ECHO slot for ``index`` and count it
        against ``root``; returns the new echo potential (pending +
        verified claims) for the (root, instance).  The caller has
        already passed dedup + precheck — a claim is final (an invalid
        proof burns the sender's one slot, reference rbc semantics)."""
        self.echo_seen[sender_idx, index] = True
        row = self._row(root)
        self.echo_pot[row, index] += 1
        return int(self.echo_pot[row, index])

    def echo_drop(self, index: int, root: bytes) -> None:
        """A claimed ECHO failed hub verification (or carried a
        conflicting shard length): remove it from the quorum POTENTIAL
        so burned claims cannot keep triggering flush requests — the
        sender's claim bit stays burned (one vote, spent)."""
        row = self._root_rows.get(root)
        if row is not None and self.echo_pot[row, index] > 0:
            self.echo_pot[row, index] -= 1

    def ready_add(
        self, index: int, sender_idx: int, root: bytes
    ) -> Optional[int]:
        """Record one READY; returns the new distinct-sender count for
        (root, instance), or None on a duplicate sender."""
        if self.ready_seen[sender_idx, index]:
            if self.metrics is not None:
                self.metrics.dedup_absorbed.inc()
            return None
        self.ready_seen[sender_idx, index] = True
        row = self._row(root)
        self.ready_cnt[row, index] += 1
        return int(self.ready_cnt[row, index])

    def ready_count(self, index: int, root: bytes) -> int:
        row = self._root_rows.get(root)
        return 0 if row is None else int(self.ready_cnt[row, index])

    def echo_potential(self, index: int, root: bytes) -> int:
        row = self._root_rows.get(root)
        return 0 if row is None else int(self.echo_pot[row, index])

    def ready_roots(self, index: int) -> list:
        """Roots with at least one READY receipt for ``index``, in
        registry insertion order (deterministic: the registry is an
        insertion-ordered dict, never a set)."""
        cnt = self.ready_cnt
        return [
            root
            for root, row in self._root_rows.items()
            if cnt[row, index] > 0
        ]

    # -- columnar delivery (ACS batch path) --------------------------------

    def _indices(
        self, proposers: tuple
    ) -> "Tuple[np.ndarray, np.ndarray, bool]":
        """(instance index array, source position array, has_dups) —
        computed once per distinct proposers tuple (the codec's decode
        memo shares one tuple across a broadcast's receivers, so this
        builds once per wire payload).  Unknown proposers drop at
        cache build; positions keep the per-instance columns (roots,
        branches, shards) aligned after the drop."""
        ent = self._prop_cache.get(proposers)
        if ent is None:
            iidx = self.iidx
            pairs = [
                (iidx[p], k)
                for k, p in enumerate(proposers)
                if p in iidx
            ]
            arr = np.asarray([i for i, _k in pairs], dtype=np.int64)
            pos = np.asarray([k for _i, k in pairs], dtype=np.int64)
            dups = len(set(proposers)) != len(proposers)
            if len(self._prop_cache) >= _PROP_CACHE_CAP:
                self._prop_cache.clear()
            ent = (arr, pos, dups)
            self._prop_cache[proposers] = ent
        return ent

    def batch_ready(self, sender: str, proposers: tuple, roots: tuple) -> None:
        """One sender's READYs fanned across ``proposers``
        (ReadyBatchPayload): vectorized membership + delivered filter
        + dedup + per-(root, instance) counting; only threshold
        crossings reach RBC."""
        si = self.sidx.get(sender)
        if si is None:
            return
        pi, pos, dups = self._indices(proposers)
        if pi.size == 0:
            return
        rbcs = self.rbcs
        if dups:
            # only Byzantine batches repeat an instance: the scalar
            # gate preserves exact first-vote-wins semantics
            for i, k in zip(pi, pos):
                rbc = rbcs[i]
                if rbc is not None:
                    rbc.handle_ready_root(sender, roots[k])
            return
        live = self.state[pi] == 0
        if not live.all():
            pi, pos = pi[live], pos[live]
            if pi.size == 0:
                return
        # malformed roots drop before any slot claim or dedup tally,
        # exactly like the scalar length gate
        lens_ok = np.fromiter(
            (len(roots[k]) == 32 for k in pos), dtype=bool, count=pi.size
        )
        if not lens_ok.all():
            pi, pos = pi[lens_ok], pos[lens_ok]
            if pi.size == 0:
                return
        seen = self.ready_seen[si, pi]
        if seen.any():
            if self.metrics is not None:
                self.metrics.dedup_absorbed.inc(int(seen.sum()))
            fresh = ~seen
            pi, pos = pi[fresh], pos[fresh]
            if pi.size == 0:
                return
        self.ready_seen[si, pi] = True
        rows = np.fromiter(
            (self._row(roots[k]) for k in pos),
            dtype=np.int64,
            count=pi.size,
        )
        cnt = self.ready_cnt
        np.add.at(cnt, (rows, pi), 1)
        after = cnt[rows, pi]
        f = self.f
        # f+1 same READY -> relay once (exact crossing: dedup makes
        # counts advance in +1 steps, docs/RBC-EN.md:41)
        for k in np.nonzero(after == f + 1)[0]:
            rbc = rbcs[pi[k]]
            if (
                rbc is not None
                and not rbc.delivered
                and rbc._ready_root is None
            ):
                rbc._send_ready(roots[pos[k]])
        # q_large reached: deliver probe (>= — post-crossing READYs
        # re-probe a decode that completed since, like the scalar path)
        for k in np.nonzero(after >= self.q_large)[0]:
            rbc = rbcs[pi[k]]
            if rbc is not None and not rbc.delivered:
                rbc._maybe_deliver(roots[pos[k]])

    def batch_echo(
        self,
        sender: str,
        shard_index: int,
        proposers: tuple,
        roots: tuple,
        branches: tuple,
        shards: tuple,
    ) -> None:
        """One sender's ECHOes fanned across ``proposers``
        (EchoBatchPayload): membership, delivered-instance and dedup
        filtering vectorized; surviving items park their proofs in the
        bank's contiguous pending slots via RBC (precheck + quorum
        probes are per-item protocol logic)."""
        si = self.sidx.get(sender)
        if si is None:
            return
        pi, pos, dups = self._indices(proposers)
        if pi.size == 0:
            return
        rbcs = self.rbcs
        if dups:
            for i, k in zip(pi, pos):
                rbc = rbcs[i]
                if rbc is not None and not rbc.delivered:
                    rbc.handle_echo_fast(
                        sender, roots[k], branches[k], shards[k], shard_index
                    )
            return
        live = self.state[pi] == 0
        if not live.all():
            pi, pos = pi[live], pos[live]
            if pi.size == 0:
                return
        seen = self.echo_seen[si, pi]
        if seen.any():
            if self.metrics is not None:
                self.metrics.dedup_absorbed.inc(int(seen.sum()))
            fresh = ~seen
            pi, pos = pi[fresh], pos[fresh]
            if pi.size == 0:
                return
        for i, k in zip(pi, pos):
            rbc = rbcs[i]
            if rbc is not None:
                rbc._echo_item(
                    si, sender, roots[k], branches[k], shards[k], shard_index
                )


__all__ = ["EchoBank"]
