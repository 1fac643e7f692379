"""ACS: asynchronous common subset = N x RBC + N x BBA.

The component the reference names as required but never started
("TODO : HoneyBadger must have ACS", reference honeybadger.go:19;
composition depicted in img/acs.png and described at
docs/HONEYBADGER-EN.md:85-89):

  - input v        -> RBC_self.propose(v)
  - RBC_j delivers -> input 1 to BBA_j (if BBA_j has no input yet)
  - n-f BBAs output 1 -> input 0 to every BBA without input
  - all N BBAs decided -> wait for RBC_j delivery for every j with
    BBA_j = 1 (guaranteed by RBC totality: some correct node delivered
    RBC_j, or no correct node would have voted 1) -> output the union
    {j: value_j} for BBA_j = 1

Properties (docs/HONEYBADGER-EN.md:34-37): Validity (output contains
the inputs of >= n-2f correct nodes), Agreement (all correct nodes
output the same set), Totality (all correct nodes eventually output).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.ops.backend import BatchCrypto
from cleisthenes_tpu_torch.ops.coin import CommonCoin
from cleisthenes_tpu_torch.ops.tpke import ThresholdSecretShare
from cleisthenes_tpu_torch.protocol.bba import BBA
from cleisthenes_tpu_torch.protocol.rbc import RBC
from cleisthenes_tpu_torch.transport.message import (
    BbaPayload,
    BbaType,
    CoinPayload,
    RbcPayload,
)


class CoinRowStore:
    """Round-keyed columnar coin-share rows for one epoch's N BBAs.

    A profile showed the per-share coin ingestion chain
    (batch handler -> per-instance dispatch -> pool add, ~573k scalar
    calls per N=64 epoch) as the largest protocol cost after echoes.
    This store replaces it with ROW semantics: one sender's whole
    share fan-out (a CoinBatchPayload, or a width-1 single) is ONE
    append here, and per-instance pools materialize shares lazily —
    bounded to the f+1 the threshold needs on the fast path, and
    completely at every hub-flush boundary, where pools therefore
    hold exactly what the eager path would have held (the burn/
    replacement/verdict logic is untouched).

    Pools are NOT fully materialized at flush time: BBA._top_up_coin
    pulls only until the threshold is index-coverable, and surplus
    rows stay parked here; the burn/replacement logic re-pulls on the
    re-marked flush round, and the per-instance ``watch`` re-notifies
    when a replayed index leaves a threshold-size pool under-covered.

    DoS bounds: rounds are capped at bba.MAX_ROUNDS (bounding the
    by_round table); per-sender FRESH rows are capped per round at
    2n (an honest sender emits at most one share per instance per
    round — n width-1 singles in the worst schedule); replayed frames
    are fresh-filtered before any cap or count is touched; and
    per-instance dedup stays in SharePool (first share per sender
    wins), so a Byzantine sender still only ever burns its own slot.
    """

    __slots__ = (
        "members",
        "threshold",
        "_iidx",
        "by_round",
        "_col_memo",
        "_watch_rnd",
    )
    _COL_MEMO_CAP = 4096
    MAX_COIN_ROW_ROUNDS = 256

    def __init__(self, members: Sequence[str], threshold: int) -> None:
        self.members = list(members)
        self.threshold = threshold
        self._iidx = {p: i for i, p in enumerate(self.members)}
        # rnd -> [rows, counts, notified, (sender,inst) seen,
        #         per-sender fresh-row counts]
        self.by_round: Dict[int, list] = {}
        # id(proposers) -> (proposers, {proposer: column}, idx array) —
        # the codec payload memo shares one proposers tuple across a
        # broadcast's receivers, so these build once per wire payload
        # (width-1 singles bypass the memo entirely: each single is a
        # fresh tuple that could never hit and would churn the table)
        self._col_memo: dict = {}
        # per-instance watched ROUND (-1 = off): re-notify arrivals
        # for exactly the round whose pool is threshold-size but
        # index-under-covered — the coin analog of the
        # dec-share crossing-stall fix.  Round-scoped, so a watch can
        # never burn a DIFFERENT round's one-shot crossing flag.
        self._watch_rnd = np.full(len(self.members), -1, dtype=np.int64)

    def watch_on(self, proposer_index: int, rnd: int) -> None:
        self._watch_rnd[proposer_index] = rnd

    def watch_off(self, proposer_index: int) -> None:
        self._watch_rnd[proposer_index] = -1

    def add(
        self, sender: str, rnd: int, index: int, proposers, d, e, z
    ) -> list:
        """Append one sender row; returns the member names whose
        DISTINCT-SENDER share count just crossed the threshold (fires
        at most once per (round, instance)) plus any round-watched
        instances the row contains.

        Counting must be per (sender, instance) — exactly the dedup
        SharePool applies — or a replayed/duplicated frame inflates a
        count past the threshold with too few distinct senders, burns
        the one-shot crossing, and the real quorum later arrives
        unannounced (liveness stall found by the n=7 coalition test)."""
        n = len(self.members)
        if not (1 <= index <= n):
            return []  # a bad Shamir index must not inflate counts
        if not (0 <= rnd < self.MAX_COIN_ROW_ROUNDS):
            return []  # bounds the by_round table (DoS): ~4KB+n^2
            # bits of state per allocated round, and a coin decides
            # each round w.p. 1/2 — P(honest round >= 256) ~ 2^-256
        si = self._iidx.get(sender)
        if si is None:
            return []
        ent = self.by_round.get(rnd)
        if ent is None:
            ent = self.by_round[rnd] = [
                [],
                np.zeros(n, dtype=np.int32),
                np.zeros(n, dtype=bool),
                np.zeros((n, n), dtype=bool),  # (sender, inst) seen
                {},  # sender -> fresh rows this round
            ]
        rows, counts, notified, seen, sender_rows = ent
        if len(proposers) == 1:
            ci = self._iidx.get(proposers[0])
            idx = (
                np.asarray([ci], dtype=np.int64)
                if ci is not None
                else np.empty(0, dtype=np.int64)
            )
        else:
            idx = self._memo(proposers)[2]
        fresh = idx[~seen[si, idx]]
        if fresh.size == 0:
            return []  # pure replay: consumes no cap, changes nothing
        # freshness-gated per-round cap: an honest sender emits at
        # most one share per instance per round, i.e. <= n fresh rows
        # even in the all-singles worst schedule
        nrows = sender_rows.get(sender, 0)
        if nrows >= 2 * n:
            return []
        sender_rows[sender] = nrows + 1
        rows.append((sender, index, proposers, d, e, z))
        seen[si, fresh] = True
        counts[fresh] += 1
        after = counts[fresh]
        crossed_thr = fresh[(after >= self.threshold) & ~notified[fresh]]
        notified[crossed_thr] = True  # the one-shot flag: thresholds only
        watched = fresh[self._watch_rnd[fresh] == rnd]
        if crossed_thr.size == 0 and watched.size == 0:
            return []
        members = self.members
        out = [members[i] for i in crossed_thr]
        for i in watched:
            if i not in crossed_thr:
                out.append(members[i])
        return out

    def count(self, rnd: int, proposer_index: int) -> int:
        ent = self.by_round.get(rnd)
        return int(ent[1][proposer_index]) if ent is not None else 0

    def _memo(self, proposers):
        ent = self._col_memo.get(id(proposers))
        if ent is None or ent[0] is not proposers:
            m = {p: i for i, p in enumerate(proposers)}
            iidx = self._iidx
            idx = np.asarray(
                [iidx[p] for p in proposers if p in iidx],
                dtype=np.int64,
            )
            if len(self._col_memo) >= self._COL_MEMO_CAP:
                self._col_memo.clear()
            ent = (proposers, m, idx)
            self._col_memo[id(proposers)] = ent
        return ent

    def col(self, proposers, me: str):
        """Column of ``me`` in a row's proposers tuple (id-memoized;
        width-1 rows bypass the memo — see __init__)."""
        if len(proposers) == 1:
            return 0 if proposers[0] == me else None
        return self._memo(proposers)[1].get(me)


class ACS:
    """One common-subset instance (one per epoch)."""

    def __init__(
        self,
        *,
        config: Config,
        crypto: BatchCrypto,
        epoch: int,
        owner: str,
        member_ids: Sequence[str],
        coin: CommonCoin,
        coin_secret: ThresholdSecretShare,
        out,
        hub=None,
        coin_issue_sink=None,
        trace=None,
        metrics=None,
        scope=None,
    ) -> None:
        self.n = config.n
        self.f = config.f
        self.epoch = epoch
        self.owner = owner
        # the hub-scope owner key (defaults to ``owner``): lane
        # shard-out (Config.lanes) runs S sibling HoneyBadger
        # instances per node against ONE shared hub, and each lane's
        # epoch GC must only drop ITS OWN epoch's clients — so lanes
        # > 0 qualify the scope with the lane id while ``owner``
        # keeps its protocol meaning (the member id this ACS
        # proposes under).  Lane 0 passes scope == owner, keeping
        # the single-lane scope keys byte-identical.
        self.scope = owner if scope is None else scope
        self.members: List[str] = sorted(member_ids)
        self._member_set = frozenset(self.members)
        # fn(epoch, {proposer: value}) fired exactly once
        self.on_output: Optional[Callable[[int, Dict[str, bytes]], None]] = None

        if hub is None:  # standalone use: one shared hub per ACS so
            # the epoch's 2N instances still batch together
            from cleisthenes_tpu_torch.protocol.hub import CryptoHub

            hub = CryptoHub(crypto)
        self.hub = hub
        # one vote bank per epoch: every BBA instance's BVAL/AUX state
        # as struct-of-arrays, so columnar waves update vectorized
        # (protocol.votebank)
        from cleisthenes_tpu_torch.protocol.votebank import VoteBank

        self.bank = VoteBank(
            self.members, config.f, metrics=metrics,
            quorum_large=config.quorum_large,
        )
        # the RBC twin of the vote bank: ECHO/READY receipt state for
        # every instance as struct-of-arrays (protocol.echobank), so
        # columnar echo/ready waves update vectorized too
        from cleisthenes_tpu_torch.protocol.echobank import EchoBank

        self.echo_bank = EchoBank(
            self.members, config.f, metrics=metrics,
            quorum_large=config.quorum_large,
        )
        self.rbcs: Dict[str, RBC] = {}
        self.bbas: Dict[str, BBA] = {}
        for index, proposer in enumerate(self.members):
            rbc = RBC(
                config=config,
                crypto=crypto,
                epoch=epoch,
                proposer=proposer,
                owner=owner,
                member_ids=self.members,
                out=out,
                hub=hub,
                bank=self.echo_bank,
                index=index,
                trace=trace,
                metrics=metrics,
                scope=self.scope,
            )
            rbc.on_deliver = self._on_rbc_deliver
            self.rbcs[proposer] = rbc
            bba = BBA(
                config=config,
                epoch=epoch,
                proposer=proposer,
                owner=owner,
                member_ids=self.members,
                coin=coin,
                coin_secret=coin_secret,
                out=out,
                hub=hub,
                bank=self.bank,
                index=index,
                coin_issue_sink=coin_issue_sink,
                trace=trace,
                metrics=metrics,
                scope=self.scope,
            )
            bba.on_decide = self._on_bba_decide
            self.bbas[proposer] = bba

        self._input_given: Set[str] = set()  # BBAs we provided input to
        self._zero_phase = False  # n-f ones seen, 0s injected
        self._output: Optional[Dict[str, bytes]] = None
        # columnar coin ingestion: every coin share (batch or single)
        # lands here as a row; BBAs pull lazily (see CoinRowStore)
        self._coin_rows = CoinRowStore(self.members, coin.pub.threshold)
        self._coin_threshold = coin.pub.threshold
        for bba in self.bbas.values():
            bba.coin_rows = self._coin_rows

    # -- public API --------------------------------------------------------

    def input(self, value: bytes) -> None:
        """Propose this node's value (the HoneyBadger TPKE ciphertext,
        docs/HONEYBADGER-EN.md:58-61)."""
        self.rbcs[self.owner].propose(value)

    def output(self) -> Optional[Dict[str, bytes]]:
        return self._output

    @property
    def done(self) -> bool:
        return self._output is not None

    def handle_message(self, sender: str, payload) -> None:
        """Route by payload kind + instance (proposer)."""
        proposer = getattr(payload, "proposer", None)
        if proposer not in self.rbcs:
            return
        if isinstance(payload, RbcPayload):
            self.rbcs[proposer].handle_message(sender, payload)
        elif isinstance(payload, CoinPayload):
            # width-1 row: singles and batches share ONE ingestion
            # path, so threshold crossing is purely row-count based
            if sender in self._member_set:
                self._coin_row(
                    sender,
                    payload.round,
                    payload.index,
                    (proposer,),
                    (payload.d,),
                    (payload.e,),
                    (payload.z,),
                )
        elif isinstance(payload, BbaPayload):
            self.bbas[proposer].handle_message(sender, payload)

    def _coin_row(
        self, sender: str, rnd: int, index: int, proposers, d, e, z
    ) -> None:
        crossed = self._coin_rows.add(
            sender, rnd, index, proposers, d, e, z
        )
        for proposer in crossed:
            bba = self.bbas.get(proposer)
            if bba is not None and not bba.halted and bba.round == rnd:
                bba.on_coin_rows(rnd)

    # -- columnar wave payloads (transport.message batch kinds) ------------

    def handle_bba_batch(self, sender: str, p) -> None:
        """One vote fanned across many instances: BVAL/AUX go through
        the vectorized bank; TERM (a handful per instance, ever) stays
        scalar (transport._columnarize)."""
        t, rnd, value = p.type, p.round, p.value
        if t == BbaType.TERM:
            bbas = self.bbas
            for proposer in p.proposers:
                bba = bbas.get(proposer)
                if bba is not None:
                    bba.handle_vote(sender, t, rnd, value)
            return
        self.bank.batch_vote(
            sender, t == BbaType.BVAL, rnd, value, p.proposers
        )

    def handle_coin_batch(self, sender: str, p) -> None:
        """One sender's coin shares fanned across instances: ONE row
        append in the CoinRowStore — per-instance pools pull lazily
        (replacing the per-share dispatch chain a profile
        put at ~573k scalar calls per N=64 epoch)."""
        if sender not in self.bank.sidx:
            return
        self._coin_row(
            sender, p.round, p.index, p.proposers, p.d, p.e, p.z
        )

    def handle_ready_batch(self, sender: str, p) -> None:
        """One sender's READYs fanned across instances
        (ReadyBatchPayload): membership, delivered-instance filtering,
        dedup and per-(root, instance) counting all run vectorized in
        the EchoBank; only threshold crossings reach RBC logic."""
        self.echo_bank.batch_ready(sender, p.proposers, p.roots)

    def handle_echo_batch(self, sender: str, p) -> None:
        """One sender's ECHOes fanned across instances
        (EchoBatchPayload): the membership + delivered + dedup gates
        hoist into the EchoBank's vectorized row filters; surviving
        items park per instance via RBC's claim logic."""
        self.echo_bank.batch_echo(
            sender, p.shard_index, p.proposers, p.roots, p.branches, p.shards
        )

    # -- wave-routed ingest columns (protocol.router.WaveRouter) -----------

    def handle_vote_wave(self, items) -> None:
        """One delivery wave's BVAL/AUX/TERM votes across ALL senders
        and instances (wave routing: one handler dispatch for the
        whole column).  Non-TERM votes group by (type, round, value)
        — one sender's columnar batch and a width-1 scalar vote are
        the same row shape — and each group updates the VoteBank
        wholesale in a single vectorized pass (VoteBank.wave_vote).
        TERM stays scalar (a handful per instance, ever)."""
        bank = self.bank
        sidx = bank.sidx
        bbas = self.bbas
        groups: Dict[tuple, list] = {}
        for sender, t, rnd, value, proposers in items:
            if t == BbaType.TERM:
                for proposer in proposers:
                    bba = bbas.get(proposer)
                    if bba is not None:
                        bba.handle_vote(sender, t, rnd, value)
                continue
            si = sidx.get(sender)
            if si is None:
                continue
            key = (t, rnd, value)
            rows = groups.get(key)
            if rows is None:
                groups[key] = [(si, sender, proposers)]
            else:
                rows.append((si, sender, proposers))
        for (t, rnd, value), rows in groups.items():
            bank.wave_vote(t == BbaType.BVAL, rnd, value, rows)

    def handle_echo_wave(self, items) -> None:
        """One delivery wave's ECHOes across ALL senders: each row is
        one sender's fan-out (columnar batch, or a width-1 scalar
        ECHO) and runs the EchoBank's vectorized membership/delivered/
        dedup filters — one handler dispatch instead of one per
        payload."""
        batch_echo = self.echo_bank.batch_echo
        for sender, shard_index, proposers, roots, branches, shards in items:
            batch_echo(
                sender, shard_index, proposers, roots, branches, shards
            )

    def handle_ready_wave(self, items) -> None:
        """One delivery wave's READYs across ALL senders (row shape as
        in handle_echo_wave)."""
        batch_ready = self.echo_bank.batch_ready
        for sender, proposers, roots in items:
            batch_ready(sender, proposers, roots)

    def handle_coin_wave(self, items) -> None:
        """One delivery wave's coin shares across ALL senders: each
        row is one (sender, round) share fan-out and lands as ONE
        CoinRowStore append (per-instance pools pull lazily)."""
        sidx = self.bank.sidx
        for sender, rnd, index, proposers, d, e, z in items:
            if sender in sidx:
                self._coin_row(sender, rnd, index, proposers, d, e, z)

    # -- composition rules (img/acs.png) -----------------------------------

    def _on_rbc_deliver(self, proposer: str, value: bytes) -> None:
        # deliver_j -> BBA_j(1), unless we already voted (possibly 0)
        if proposer not in self._input_given:
            self._input_given.add(proposer)
            self.bbas[proposer].input(True)
        self._maybe_output()

    def _on_bba_decide(self, proposer: str, decision: bool) -> None:
        ones = sum(1 for b in self.bbas.values() if b.result() is True)
        if ones >= self.n - self.f and not self._zero_phase:
            # n-f BBAs delivered 1: vote 0 on everything still open
            self._zero_phase = True
            for p in self.members:
                if p not in self._input_given:
                    self._input_given.add(p)
                    self.bbas[p].input(False)
        self._maybe_output()

    def _maybe_output(self) -> None:
        if self._output is not None:
            return
        if any(not b.done for b in self.bbas.values()):
            return
        accepted = [p for p in self.members if self.bbas[p].result() is True]
        # totality: every 1-decided RBC will deliver; wait for them
        if any(not self.rbcs[p].delivered for p in accepted):
            return
        self._output = {p: self.rbcs[p].value() for p in accepted}
        if self.on_output is not None:
            self.on_output(self.epoch, dict(self._output))


__all__ = ["ACS"]
