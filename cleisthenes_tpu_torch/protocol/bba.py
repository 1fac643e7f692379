"""BBA: randomized binary Byzantine agreement with a threshold coin.

Completes the reference's skeleton (reference bba/bba.go:63-107,
bba/binary_set.go:7-11) per its own spec (reference docs/BBA-EN.md):

  round r, estimate est:
    broadcast BVAL(est)                              (docs/BBA-EN.md:39-44)
    on f+1  BVAL(v): relay BVAL(v) once              (docs/BBA-EN.md:47-52)
    on 2f+1 BVAL(v): bin_values U= {v}               (docs/BBA-EN.md:53-58,
                                                      bba/binary_set.go union)
    when bin_values first non-empty: broadcast AUX(w), w in bin_values
                                                     (docs/BBA-EN.md:134-139)
    await n-f AUX whose values are in bin_values -> vals
                                                     (docs/BBA-EN.md:140-156)
    s = common_coin(r)                               (docs/BBA-EN.md:163-177)
    vals == {b}: est = b; decide b if b == s
    else:        est = s; next round

The common coin is the threshold VUF of ops.coin: each node broadcasts
one share per (instance, round); f+1 verified shares combine to the
network-global bit.  Share verification is batched through the
BatchCrypto seam (one device dispatch per reveal under 'cuda').

Termination (the part docs/BBA-EN.md leaves open): deciding alone must
not stop a node — rounds need n-f live participants, so a decided node
keeps participating with its estimate pinned to the decision, and a
Bracha-style TERM gadget provides the actual exit: broadcast TERM(b)
on decision; adopt-decide on f+1 TERM(b); halt on 2f+1 TERM(b)
(>= f+1 of those are correct, so every correct node eventually adopts
and halts too).

The epoch/round bookkeeping mirrors the reference struct
(bba/bba.go:27-61): n, f, proposer, epoch + internal round,
sentBvalSet, est/dec binaries, per-type repos, and the future-message
buffer (bba/request.go:28-32 semantics, here applied to rounds within
the instance; epochs are buffered one level up by HoneyBadger).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.ops.coin import CommonCoin
from cleisthenes_tpu_torch.ops.tpke import (
    DhShare,
    SharePool,
    ThresholdSecretShare,
)
from cleisthenes_tpu_torch.transport.message import (
    BbaPayload,
    BbaType,
    CoinPayload,
)

# A Byzantine peer must not park unbounded state for distant rounds.
ROUND_HORIZON = 8
MAX_BUFFERED_PER_SENDER = 4 * ROUND_HORIZON
# Probabilistic termination: P(not done) halves per round; 1000 rounds
# is unreachable in practice and bounds state against pathology.
MAX_ROUNDS = 1000


class _Round:
    """Per-round SEND + coin state (the reference keeps one flat set
    because it never finished multi-round flow; bba/bba.go:44-51).
    BVAL/AUX RECEIPT state lives in the shared VoteBank row — single
    source of truth for both the columnar and the scalar delivery
    paths (protocol.votebank)."""

    __slots__ = (
        "bval_sent",
        "aux_sent",
        "coin_share_sent",
        "coin_shares",
        "coin_value",
        "advanced",
        "rows_pulled",
    )

    def __init__(self, coin_threshold: int) -> None:
        self.bval_sent: Set[bool] = set()
        self.aux_sent: Optional[bool] = None
        self.coin_share_sent = False
        # sender-keyed with burned-slot tracking: a Byzantine peer can
        # only ever occupy (and burn) its own slot, never censor an
        # honest node's share or force repeated re-verification
        self.coin_shares = SharePool(coin_threshold)
        self.coin_value: Optional[bool] = None
        self.advanced = False
        # cursor into the ACS CoinRowStore's row list for this round
        # (lazy columnar ingestion; see acs.CoinRowStore)
        self.rows_pulled = 0


class BBA:
    """One binary-agreement instance: (epoch, proposer)."""

    def __init__(
        self,
        *,
        config: Config,
        epoch: int,
        proposer: str,
        owner: str,
        member_ids,
        coin: CommonCoin,
        coin_secret: ThresholdSecretShare,
        out,
        hub=None,
        bank=None,
        index: Optional[int] = None,
        coin_issue_sink: Optional[Callable] = None,
        trace=None,
        metrics=None,
        scope=None,
    ) -> None:
        self.n = config.n
        self.f = config.f
        # bin_values / TERM-halt threshold: 2f+1 baseline, n-f
        # under Config.reduced_quorum (Config.quorum_large)
        self.q_large = config.quorum_large
        self.epoch = epoch
        self.proposer = proposer
        self.owner = owner
        self.members = sorted(member_ids)
        self._member_set = frozenset(self.members)
        if bank is None:  # standalone use (unit tests): private row
            from cleisthenes_tpu_torch.protocol.votebank import VoteBank

            bank = VoteBank(
                self.members, config.f, inst_ids=[proposer],
                metrics=metrics, quorum_large=config.quorum_large,
            )
            index = 0
        self.bank = bank
        self.index = index
        bank.attach(index, self)
        self.coin = coin
        self.coin_secret = coin_secret
        self.out = out
        # when set, coin-share issuance defers to the owner's
        # per-drain batch (one exponentiation dispatch for a whole
        # wave of instances) instead of 4 scalar host exps here
        self.coin_issue_sink = coin_issue_sink
        if hub is None:  # standalone use (unit tests): private hub
            from cleisthenes_tpu_torch.ops.backend import BatchCrypto
            from cleisthenes_tpu_torch.protocol.hub import CryptoHub

            hub = CryptoHub(
                BatchCrypto(
                    coin.backend, config.n, config.f, config.data_shards,
                    device=coin.device,
                )
            )
        self.hub = hub
        # see rbc.py note: lane shard-out qualifies scope per lane
        self.hub.register((owner if scope is None else scope, epoch), self)
        # flight recorder (None = tracing off; utils/trace.py)
        self.trace = trace
        # owner-node metrics (None in standalone unit tests): only the
        # duplicate-vote absorption counter is touched here
        self.metrics = metrics

        self.round = 0
        self.est: Optional[bool] = None
        self.decided: Optional[bool] = None  # dec (bba/bba.go:50)
        self.halted = False
        self.on_decide: Optional[Callable[[str, bool], None]] = None

        self._coin_threshold = coin.pub.threshold
        # set by ACS after construction: the epoch's shared columnar
        # coin-row store (None in standalone/unit-test use, where the
        # scalar per-share path below carries everything)
        self.coin_rows = None
        self._rounds: Dict[int, _Round] = {0: _Round(coin.pub.threshold)}
        self._term_sent = False
        self._term_recv: Dict[bool, Set[str]] = {True: set(), False: set()}
        self._term_voted: Set[str] = set()
        # (round -> [(sender, payload)]) future-round parking
        self._future: Dict[int, List[Tuple[str, object]]] = {}
        self._buffered_per_sender: Dict[str, int] = {}

    # -- public API (reference bba/bba.go:63-87) ---------------------------

    def result(self) -> Optional[bool]:
        """Reference bba/bba.go:78-80."""
        return self.decided

    @property
    def done(self) -> bool:
        return self.decided is not None

    def input(self, est: bool) -> None:
        """Reference bba/bba.go:69-71 HandleInput: set the initial
        estimate and open round 0.  Ignored if the instance already
        derived an estimate (it advanced rounds passively before the
        caller got around to providing input — ACS inputs 0 late)."""
        if self.halted or self.est is not None:
            return
        self.est = bool(est)
        self._broadcast_bval(self.round, self.est)

    def handle_message(self, sender: str, payload) -> None:
        """Reference bba/bba.go:74-76 HandleMessage + :89-99 muxRequest."""
        if self.halted or sender not in self._member_set:
            return
        if isinstance(payload, BbaPayload):
            if payload.type == BbaType.TERM:
                self._handle_term(sender, payload.value)
                return
            self._gated(sender, payload, payload.round)
        elif isinstance(payload, CoinPayload):
            self._gated(sender, payload, payload.round)

    # -- scalar entry points (columnar wave payloads) ----------------------

    def handle_vote(self, sender: str, t, rnd: int, value: bool) -> None:
        """BVAL/AUX/TERM without a payload object: the columnar batch
        path's per-instance call.  Off-round votes fall back to the
        parking path (payload built lazily — parking is the rare
        case)."""
        if self.halted or sender not in self._member_set:
            return
        if t == BbaType.TERM:
            self._handle_term(sender, value)
            return
        if rnd == self.round:
            if t == BbaType.BVAL:
                self._handle_bval(sender, value)
            else:
                self._handle_aux(sender, value)
            return
        if rnd < self.round:
            return  # stale: skip even the payload allocation
        self._gated(
            sender,
            BbaPayload(t, self.proposer, self.epoch, rnd, value),
            rnd,
        )

    def handle_coin(
        self, sender: str, rnd: int, index: int, d: int, e: int, z: int
    ) -> None:
        """Coin share without a payload object (columnar batch path)."""
        if self.halted or sender not in self._member_set:
            return
        self.handle_coin_fast(sender, rnd, index, d, e, z)

    def handle_coin_fast(
        self, sender: str, rnd: int, index: int, d: int, e: int, z: int
    ) -> None:
        """handle_coin minus the halted/membership gate — for callers
        that already checked both (ACS.handle_coin_batch hoists them
        out of its per-instance loop)."""
        if rnd == self.round:
            self._handle_coin_share_scalar(sender, index, d, e, z)
            return
        if rnd < self.round:
            return  # stale: skip the payload allocation
        self._gated(
            sender,
            CoinPayload(self.proposer, self.epoch, rnd, index, d, e, z),
            rnd,
        )

    # -- round gating ------------------------------------------------------

    def _gated(self, sender: str, payload, rnd: int) -> None:
        """Process current-round messages; park future rounds within
        the horizon (bba/request.go:28-32 pattern, per-round)."""
        if rnd < self.round:
            return  # stale: quorums it could join are already closed
        if rnd >= MAX_ROUNDS:
            # Liveness cutoff: an instance that somehow reaches round
            # MAX_ROUNDS can never decide, because the messages that
            # would let it are dropped here.  Accepted deliberately:
            # each round ends with probability >= 1/2, so P(reaching
            # round 1000) ~ 2^-1000 — the bound exists only to cap
            # state against a pathological/Byzantine round counter.
            return
        if rnd > self.round:
            if rnd > self.round + ROUND_HORIZON:
                return
            count = self._buffered_per_sender.get(sender, 0)
            if count >= MAX_BUFFERED_PER_SENDER:
                return
            self._buffered_per_sender[sender] = count + 1
            self._future.setdefault(rnd, []).append((sender, payload))
            return
        self._dispatch(sender, payload)

    def _dispatch(self, sender: str, payload) -> None:
        if isinstance(payload, BbaPayload):
            if payload.type == BbaType.BVAL:
                self._handle_bval(sender, payload.value)
            elif payload.type == BbaType.AUX:
                self._handle_aux(sender, payload.value)
        elif isinstance(payload, CoinPayload):
            self._handle_coin_share(sender, payload)

    # -- BVAL / AUX (reference bba/bba.go:101-107, empty in skeleton) ------

    def _cur(self) -> _Round:
        return self._rounds[self.round]

    def _broadcast_bval(self, rnd: int, value: bool) -> None:
        r = self._rounds[rnd]
        if value in r.bval_sent:
            return
        r.bval_sent.add(value)
        self.out.broadcast(
            BbaPayload(
                type=BbaType.BVAL,
                proposer=self.proposer,
                epoch=self.epoch,
                round=rnd,
                value=value,
            )
        )

    def _handle_bval(self, sender: str, value: bool) -> None:
        si = self.bank.sidx.get(sender)
        if si is None:
            return
        cnt = self.bank.bval_add(self.index, si, value)
        if cnt is None:  # duplicate
            return
        # f+1 same bval -> relay once (docs/BBA-EN.md:47-52; the
        # sentBvalSet of bba/bba.go:48)
        if cnt >= self.f + 1:
            self.on_bval_relay(value)
        # q_large -> bin_values union (docs/BBA-EN.md:53-58)
        if cnt >= self.q_large:
            self.on_bval_bin(value)

    def on_bval_relay(self, value: bool) -> None:
        """f+1 BVAL crossing (idempotent: bval_sent dedups)."""
        self._broadcast_bval(self.round, value)

    def on_bval_bin(self, value: bool) -> None:
        """2f+1 BVAL crossing: bin_values growth (idempotent)."""
        vi = 1 if value else 0
        if self.bank.bin_flags[self.index, vi]:
            return
        self.bank.set_bin(self.index, value)
        r = self._cur()
        if r.aux_sent is None:
            r.aux_sent = value
            self.out.broadcast(
                BbaPayload(
                    type=BbaType.AUX,
                    proposer=self.proposer,
                    epoch=self.epoch,
                    round=self.round,
                    value=value,
                )
            )
        # bin_values growth can complete the AUX quorum
        self._maybe_request_coin()
        self._maybe_advance()

    def _handle_aux(self, sender: str, value: bool) -> None:
        si = self.bank.sidx.get(sender)
        if si is None:
            return
        if not self.bank.aux_add(self.index, si, value):
            return  # duplicate
        self._maybe_request_coin()
        self._maybe_advance()

    def on_aux_quorum(self) -> None:
        """Columnar-path trigger: the n-f AUX quorum became reachable."""
        self._maybe_request_coin()
        self._maybe_advance()

    def _aux_quorum(self) -> bool:
        """n-f AUX messages whose values are in bin_values
        (docs/BBA-EN.md:140-156)."""
        return self.bank.aux_good(self.index) >= self.n - self.f

    # -- common coin (docs/BBA-EN.md:163-181) ------------------------------

    def _coin_id(self, rnd: int) -> bytes:
        return b"%d|%s|%d" % (self.epoch, self.proposer.encode(), rnd)

    def _maybe_request_coin(self) -> None:
        """First AUX quorum -> contribute our coin share for this round."""
        r = self._cur()
        if r.coin_share_sent or not self._aux_quorum():
            return
        r.coin_share_sent = True
        if self.trace is not None:
            self.trace.instant(
                "coin",
                "share_issue",
                epoch=self.epoch,
                proposer=self.proposer,
                round=self.round,
            )
        if self.coin_issue_sink is not None:
            # the drain batches every queued instance's issue into one
            # dispatch and calls broadcast_coin_share back
            self.coin_issue_sink(self, self.round)
            return
        share = self.coin.share(self.coin_secret, self._coin_id(self.round))
        self.broadcast_coin_share(self.round, share)

    def broadcast_coin_share(self, rnd: int, share) -> None:
        # deliberately NOT gated on halted: the share is a deterministic
        # public VUF value, and a node that decides via TERM between
        # queueing a coin issue and draining it must still contribute —
        # slower peers may be one share short of the coin threshold
        # (the deferred-issue drain)
        self.out.broadcast(
            CoinPayload(
                proposer=self.proposer,
                epoch=self.epoch,
                round=rnd,
                index=share.index,
                d=share.d,
                e=share.e,
                z=share.z,
            )
        )

    def _handle_coin_share(self, sender: str, p: CoinPayload) -> None:
        self._handle_coin_share_scalar(sender, p.index, p.d, p.e, p.z)

    def _handle_coin_share_scalar(
        self, sender: str, index: int, d: int, e: int, z: int
    ) -> None:
        r = self._cur()
        if r.coin_value is not None or not (1 <= index <= self.n):
            return
        if r.coin_shares.add_lazy(sender, index, d, e, z):
            # below the threshold there is nothing a hub flush could
            # usefully verify for this pool — defer the dirty mark
            # (and the DhShare materialization) until the coin can
            # actually reveal; the post-burn replacement path re-marks
            # explicitly in _on_coin_verdicts
            if len(r.coin_shares) >= self._coin_threshold:
                self.hub.mark_dirty(self)
                self._maybe_reveal_coin()
        elif self.metrics is not None:
            self.metrics.dedup_absorbed.inc()

    def _maybe_reveal_coin(self) -> None:
        """Threshold reached -> flush the hub: OUR shares verify in the
        same dispatch as every other concurrent instance's pooled
        shares (and the epoch's pending TPKE/branch work)."""
        r = self._cur()
        if r.coin_value is not None:
            return
        self._top_up_coin(r)
        if len(r.coin_shares) < self.coin.pub.threshold:
            return
        self.hub.request_flush()

    # -- columnar coin rows (acs.CoinRowStore) -----------------------------

    def _pull_coin_rows(self, rnd: int, r: "_Round", target: int) -> None:
        """Materialize this instance's shares from the ACS row store
        into the round's pool, up to ``target`` pool entries — the
        callers (_top_up_coin) pull only until the threshold is
        index-coverable; surplus rows stay parked in the store and
        never materialize."""
        store = self.coin_rows
        if store is None:
            return
        ent = store.by_round.get(rnd)
        if ent is None:
            return
        rows = ent[0]
        cur = r.rows_pulled
        if cur >= len(rows):
            return
        pool = r.coin_shares
        me = self.proposer
        col_of = store.col
        while cur < len(rows) and len(pool) < target:
            sender, index, proposers, d, e, z = rows[cur]
            cur += 1
            ci = col_of(proposers, me)
            if ci is not None:
                pool.add_lazy(sender, index, d[ci], e[ci], z[ci])
        r.rows_pulled = cur

    def _top_up_coin(self, r: "_Round") -> None:
        """Pull from the row store until the threshold is COVERABLE
        (distinct Shamir indices) or the store has no more rows for
        this round; arm the store's re-notify watch when a replayed
        index leaves a threshold-size pool under-covered (the coin
        analog of the dec-share crossing-stall fix)."""
        pool = r.coin_shares
        while pool.covered() < pool.threshold:
            before = len(pool)
            self._pull_coin_rows(
                self.round,
                r,
                before + (pool.threshold - pool.covered()),
            )
            if len(pool) == before:
                break  # store exhausted for this round
        store = self.coin_rows
        if store is not None and self.index is not None:
            if pool.covered() < pool.threshold:
                store.watch_on(self.index, self.round)
            else:
                store.watch_off(self.index)

    def on_coin_rows(self, rnd: int) -> None:
        """ACS notification: the store's round-``rnd`` rows reached
        the coin threshold for this instance (or this instance just
        entered a round whose rows already had, or it is watched and
        a fresh row arrived)."""
        if self.halted or rnd != self.round:
            return
        r = self._rounds.get(rnd)
        if r is None or r.coin_value is not None:
            return
        self._top_up_coin(r)
        if len(r.coin_shares) >= self._coin_threshold:
            self.hub.mark_dirty(self)
            self.hub.request_flush()

    # -- hub client protocol (protocol.hub.CryptoHub) ----------------------

    def drain_pending(self, wave) -> None:
        if self.halted:
            return
        r = self._rounds.get(self.round)
        if r is None or r.coin_value is not None:
            return
        # flush boundary: top the pool up until the threshold is
        # COVERABLE (distinct Shamir indices), not until the store is
        # empty — surplus rows stay parked and never materialize
        # (burns recompute coverage, so deficits re-pull here on the
        # re-marked flush round)
        self._top_up_coin(r)
        pool = r.coin_shares
        senders, shs = pool.collect_pending(pool.need_more())
        if not senders:
            return
        pub, base, context = self.coin.group_params(
            self._coin_id(self.round)
        )
        rnd = self.round
        wave.add_share(
            pub,
            base,
            context,
            senders,
            shs,
            lambda snd, ok, rnd=rnd: self._on_coin_verdicts(rnd, snd, ok),
        )

    def _on_coin_verdicts(self, rnd: int, senders, ok) -> None:
        r = self._rounds.get(rnd)
        if r is None:
            return
        r.coin_shares.apply_verdicts(senders, ok)
        if not all(ok) and r.coin_shares.need_more():
            # an invalid share burned a collected slot: the surplus
            # shares already PARKED in the pool are the replacements,
            # and under dirty-set flushing nothing else would re-offer
            # them (no new arrival is coming — every share may already
            # be here).  Re-mark so the flush loop's next collection
            # round pulls them; without this the coin stays unrevealed
            # forever (a liveness break).
            self.hub.mark_dirty(self)

    def after_crypto_flush(self) -> None:
        if self.halted:
            return
        r = self._rounds.get(self.round)
        if r is None or r.coin_value is not None:
            return
        valid = r.coin_shares.ready()
        if valid is None:
            return
        r.coin_value = self.coin.toss(self._coin_id(self.round), valid)
        if self.trace is not None:
            self.trace.instant(
                "coin",
                "reveal",
                epoch=self.epoch,
                proposer=self.proposer,
                round=self.round,
                value=bool(r.coin_value),
            )
        if self.coin_rows is not None and self.index is not None:
            self.coin_rows.watch_off(self.index)
        self._maybe_advance()

    # -- round transition --------------------------------------------------

    def _maybe_advance(self) -> None:
        r = self._cur()
        if r.advanced or r.coin_value is None or not self._aux_quorum():
            return
        vals = self.bank.aux_vals(self.index)  # docs/BBA-EN.md:140-156
        coin = r.coin_value
        r.advanced = True
        if len(vals) == 1:
            (b,) = vals
            next_est = b
            if b == coin and self.decided is None:
                self._decide(b)
        else:
            next_est = coin
        if self.decided is not None:
            # decided nodes keep participating, estimate pinned, so
            # laggards' rounds retain n-f live members
            next_est = self.decided
        self.round += 1
        self.est = next_est
        if self.trace is not None:
            self.trace.instant(
                "bba",
                "round",
                epoch=self.epoch,
                proposer=self.proposer,
                round=self.round,
            )
        self._rounds[self.round] = _Round(self.coin.pub.threshold)
        self.bank.reset_row(self.index, self.round)
        self._broadcast_bval(self.round, next_est)
        # late entry: the store may already hold a coin quorum for the
        # new round (its crossing notification fired before we got
        # here and skipped us — round mismatch); any watch armed for
        # the finished round is stale now
        store = self.coin_rows
        if store is not None and self.index is not None:
            store.watch_off(self.index)
            if store.count(self.round, self.index) >= self._coin_threshold:
                self.on_coin_rows(self.round)
        # GC old round, replay parked messages for the new one
        self._rounds.pop(self.round - 1, None)
        replay_round = self.round
        for sender, payload in self._future.pop(replay_round, []):
            cnt = self._buffered_per_sender.get(sender, 0)
            if cnt > 0:
                self._buffered_per_sender[sender] = cnt - 1
            if self.halted:
                break
            # re-gate instead of dispatching blindly: a nested advance
            # during this replay moves self.round past replay_round,
            # and these parked votes must then be dropped as stale, not
            # counted into a later round's quorums
            self._gated(sender, payload, replay_round)

    # -- decision & termination --------------------------------------------

    def _decide(self, b: bool) -> None:
        self.decided = b
        if self.trace is not None:
            self.trace.instant(
                "bba",
                "decide",
                epoch=self.epoch,
                proposer=self.proposer,
                round=self.round,
                value=bool(b),
            )
        if not self._term_sent:
            self._term_sent = True
            self.out.broadcast(
                BbaPayload(
                    type=BbaType.TERM,
                    proposer=self.proposer,
                    epoch=self.epoch,
                    round=self.round,
                    value=b,
                )
            )
        if self.on_decide is not None:
            self.on_decide(self.proposer, b)

    def _handle_term(self, sender: str, value: bool) -> None:
        if sender in self._term_voted:
            if self.metrics is not None:
                self.metrics.dedup_absorbed.inc()
            return
        self._term_voted.add(sender)
        self._term_recv[value].add(sender)
        n_votes = len(self._term_recv[value])
        if n_votes >= self.f + 1 and self.decided is None:
            self._decide(value)  # adopt: f+1 guarantees a correct voter
        if n_votes >= self.q_large:
            # enough correct nodes have decided and broadcast TERM that
            # every correct node will adopt+halt without our help
            self.halted = True
            self._rounds.clear()
            self._future.clear()
            self.bank.deactivate(self.index)
            if self.coin_rows is not None and self.index is not None:
                self.coin_rows.watch_off(self.index)


__all__ = ["BBA", "ROUND_HORIZON", "MAX_ROUNDS"]
