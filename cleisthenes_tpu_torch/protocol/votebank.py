"""VoteBank: vectorized BVAL/AUX bookkeeping across BBA instances.

An epoch runs N concurrent BBA instances (one per proposer,
docs/HONEYBADGER-EN.md:85-89), and within one wave a sender emits the
same logical vote across most of them — the coalescer ships it as ONE
columnar payload (transport.message BbaBatchPayload).  Per-instance
scalar processing of such a wave costs O(N) python set/dict operations
per (sender, receiver) frame, which at N=64 is ~1.8M handler calls per
epoch — the single largest protocol-plane cost after crypto.

The bank is the batched-kernel answer applied to the host plane: one
struct-of-arrays per ACS holding every instance's current-round vote
state, so a columnar wave updates a [n_instances] slice in a handful
of numpy operations, and only threshold CROSSINGS (f+1 relay, 2f+1
bin_values growth, n-f AUX quorum — a constant number per instance
per round) fall back to the per-instance protocol logic in BBA.

Array layouts put the wave's axis LAST: receipt state is indexed
``seen[sender, value, instance]`` so one frame's update touches a
contiguous row, and activity + round fold into ONE ``round_state``
vector (the instance's current round, or a huge sentinel once halted
— every later vote for it compares stale and drops in the same
vectorized filter).  At n=64 the fixed per-numpy-op cost dominates
this function, so the layout exists to minimize op COUNT (measured
~40% off batch_vote at N=64), not element traffic.

Consistency contract: the bank is the SINGLE source of truth for
BVAL/AUX receipt state of each instance's current round.  BBA's
scalar path (off-round replays, unit tests, non-columnar transports)
writes through the same arrays, so columnar and scalar deliveries can
interleave freely.  When an instance advances a round, its row resets;
when it halts, its row deactivates and every later delivery for it is
dropped vectorized, before any python-level dispatch.

Quorum semantics mirrored from BBA (reference docs/BBA-EN.md:39-58,
134-156): +1 increments make exact-equality crossing detection
(cnt == f+1, cnt == 2f+1) equivalent to the >=-with-idempotent-guard
scalar form.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Byzantine batches can mint unlimited distinct proposer tuples; the
# index cache clears wholesale at the cap (honest traffic reuses a
# handful of tuples per wave).
_PROP_CACHE_CAP = 4096

# round_state sentinel for halted instances: any real vote round
# (< bba.MAX_ROUNDS = 1000) compares STALE against it, so halted rows
# drop in the same vectorized stale filter as old-round votes
_HALTED = 1 << 62


class VoteBank:
    """Struct-of-arrays vote state for up to ``n_inst`` BBA instances
    over a fixed roster."""

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
        # the bin_values growth threshold: 2f+1 in the baseline trust
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
        n_inst, ns = len(insts), len(self.members)
        # [sender, value, instance]: one frame's dedup probe is a
        # contiguous-row fancy index
        self.bval_seen = np.zeros((ns, 2, n_inst), dtype=bool)
        self.bval_cnt = np.zeros((2, n_inst), dtype=np.int32)
        self.aux_seen = np.zeros((ns, n_inst), dtype=bool)
        self.aux_cnt = np.zeros((2, n_inst), dtype=np.int32)
        # bin_flags[i, v]: v in instance i's current-round bin_values
        # (instance-major: BBA reads bin_flags[self.index, vi] scalar)
        self.bin_flags = np.zeros((n_inst, 2), dtype=bool)
        # edge-trigger memory: on_aux_quorum fires once per row (the
        # post-quorum AUX stream at N=64 was ~220k redundant probes
        # per epoch); bin_values growth re-probes via BBA directly
        self.aux_fired = np.zeros(n_inst, dtype=bool)
        # current round per instance; _HALTED once deactivated
        self.round_state = np.zeros(n_inst, dtype=np.int64)
        self.bbas: List[object] = [None] * n_inst
        self._prop_cache: "Dict[tuple, Tuple[np.ndarray, bool]]" = {}

    # -- membership --------------------------------------------------------

    def attach(self, index: int, bba) -> None:
        self.bbas[index] = bba

    def reset_row(self, index: int, rnd: int) -> None:
        """New round for one instance: receipt state starts empty."""
        self.bval_seen[:, :, index] = False
        self.bval_cnt[:, index] = 0
        self.aux_seen[:, index] = False
        self.aux_cnt[:, index] = 0
        self.bin_flags[index] = False
        self.aux_fired[index] = False
        self.round_state[index] = rnd

    def deactivate(self, index: int) -> None:
        """Halted instance: every later delivery drops vectorized (the
        sentinel makes any real round number compare stale)."""
        self.round_state[index] = _HALTED

    # -- scalar write-through (BBA's non-columnar path) --------------------

    def bval_add(self, index: int, sender_idx: int, value: bool):
        """Record one BVAL; returns the new count, or None if duplicate."""
        vi = 1 if value else 0
        row = self.bval_seen[sender_idx, vi]
        if row[index]:
            if self.metrics is not None:
                self.metrics.dedup_absorbed.inc()
            return None
        row[index] = True
        self.bval_cnt[vi, index] += 1
        return int(self.bval_cnt[vi, index])

    def aux_add(self, index: int, sender_idx: int, value: bool) -> bool:
        """Record one AUX; returns False on duplicate sender."""
        row = self.aux_seen[sender_idx]
        if row[index]:
            if self.metrics is not None:
                self.metrics.dedup_absorbed.inc()
            return False
        row[index] = True
        self.aux_cnt[1 if value else 0, index] += 1
        return True

    def set_bin(self, index: int, value: bool) -> None:
        self.bin_flags[index, 1 if value else 0] = True

    def aux_good(self, index: int) -> int:
        """AUX receipts whose value is in bin_values (the n-f quorum
        basis, docs/BBA-EN.md:140-156) — O(1) from the counters."""
        g = 0
        if self.bin_flags[index, 1]:
            g += int(self.aux_cnt[1, index])
        if self.bin_flags[index, 0]:
            g += int(self.aux_cnt[0, index])
        return g

    def aux_vals(self, index: int) -> set:
        """Distinct received-AUX values that are in bin_values."""
        vals = set()
        if self.bin_flags[index, 1] and self.aux_cnt[1, index] > 0:
            vals.add(True)
        if self.bin_flags[index, 0] and self.aux_cnt[0, index] > 0:
            vals.add(False)
        return vals

    # -- columnar delivery (ACS batch path) --------------------------------

    def _indices(self, proposers: tuple) -> "Tuple[np.ndarray, bool]":
        """(known-instance index array, has_duplicates) — computed once
        per distinct proposers tuple: unknown proposers drop at cache
        build (membership is fixed), and honest batches never repeat
        an instance, so batch_vote's dedup (np.unique, ~30% of its
        cost) runs only for flagged Byzantine payloads."""
        ent = self._prop_cache.get(proposers)
        if ent is None:
            iidx = self.iidx
            arr = np.asarray(
                [iidx[p] for p in proposers if p in iidx],
                dtype=np.int64,
            )
            dups = len(set(proposers)) != len(proposers)
            if len(self._prop_cache) >= _PROP_CACHE_CAP:
                self._prop_cache.clear()
            ent = (arr, dups)
            self._prop_cache[proposers] = ent
        return ent

    def wave_vote(
        self,
        is_bval: bool,
        rnd: int,
        value: bool,
        rows,
    ) -> None:
        """One delivery wave's same-(type, round, value) votes across
        MANY senders (wave routing, protocol.router): dedup + counting
        run as ONE concatenated fancy-index pass over the
        [sender, instance] arrays, and threshold crossings are
        detected by before/after comparison — counts may advance by
        more than +1 within a wave, so the exact-equality crossing of
        the per-payload paths generalizes to interval containment
        (before < thr <= after), which fires exactly once per
        (instance, threshold) under the same one-vote dedup.

        ``rows`` is a list of (sender_index, sender, proposers).  Rows
        with duplicate-instance proposers (only Byzantine batches) or
        any off-round instance fall back to the per-row batch_vote
        path AFTER the vectorized pass, which re-reads the round state
        and preserves the exact parking/stale semantics."""
        rs = self.round_state
        si_parts: list = []
        pi_parts: list = []
        fallback: list = []
        for si, sender, proposers in rows:
            pi, dups = self._indices(proposers)
            if pi.size == 0:
                continue
            if dups or (rs[pi] != rnd).any():
                fallback.append((sender, proposers))
                continue
            si_parts.append(np.full(pi.size, si, dtype=np.int64))
            pi_parts.append(pi)
        if si_parts:
            self._wave_apply(
                is_bval,
                value,
                np.concatenate(si_parts),
                np.concatenate(pi_parts),
            )
        for sender, proposers in fallback:
            self.batch_vote(sender, is_bval, rnd, value, proposers)

    def _wave_apply(
        self, is_bval: bool, value: bool, si_all, pi_all
    ) -> None:
        """The vectorized heart of wave_vote: every (sender, instance)
        pair is in-round and instance-unique per row; intra-wave
        duplicate pairs (replayed frames) dedup here, exactly like the
        seen-bit dedup absorbs them on the per-payload paths."""
        metrics = self.metrics
        n_inst = self.round_state.size
        key = si_all * n_inst + pi_all
        uniq_k, first_idx = np.unique(key, return_index=True)
        if uniq_k.size != key.size:
            if metrics is not None:
                metrics.dedup_absorbed.inc(int(key.size - uniq_k.size))
            first_idx.sort()
            si_all, pi_all = si_all[first_idx], pi_all[first_idx]
        vi = 1 if value else 0
        f = self.f
        q_large = self.q_large
        bbas = self.bbas
        if is_bval:
            seen_plane = self.bval_seen[:, vi]
        else:
            seen_plane = self.aux_seen
        seen = seen_plane[si_all, pi_all]
        if seen.any():
            if metrics is not None:
                metrics.dedup_absorbed.inc(int(seen.sum()))
            fresh = ~seen
            si_all, pi_all = si_all[fresh], pi_all[fresh]
            if pi_all.size == 0:
                return
        seen_plane[si_all, pi_all] = True
        uniq, adds = np.unique(pi_all, return_counts=True)
        if is_bval:
            cnt = self.bval_cnt[vi]
            before = cnt[uniq]
            cnt[uniq] = after = before + adds.astype(np.int32)
            # f+1 same bval -> relay once; q_large -> bin_values union
            # (docs/BBA-EN.md:47-58) — interval crossings, fired after
            # ALL of the wave's adds landed
            for i in uniq[(before < f + 1) & (after >= f + 1)]:
                bba = bbas[i]
                if bba is not None and not bba.halted:
                    bba.on_bval_relay(value)
            for i in uniq[(before < q_large) & (after >= q_large)]:
                bba = bbas[i]
                if bba is not None and not bba.halted:
                    bba.on_bval_bin(value)
        else:
            cnt = self.aux_cnt[vi]
            cnt[uniq] += adds.astype(np.int32)
            binf = self.bin_flags[uniq]
            good = self.aux_cnt[1][uniq] * binf[:, 1] + (
                self.aux_cnt[0][uniq] * binf[:, 0]
            )
            n = len(self.members)
            trig = uniq[(good >= n - f) & ~self.aux_fired[uniq]]
            if trig.size == 0:
                return
            self.aux_fired[trig] = True
            for i in trig:
                bba = bbas[i]
                if bba is not None and not bba.halted:
                    bba.on_aux_quorum()

    def batch_vote(
        self,
        sender: str,
        is_bval: bool,
        rnd: int,
        value: bool,
        proposers: tuple,
    ) -> None:
        """One sender's vote fanned across ``proposers``: vectorized
        dedup + counting for in-round instances; off-round instances
        fall back to BBA's scalar gate (parking / stale-drop).  The
        hot path (every instance in-round, vote fresh — the honest
        wave shape) runs a minimal op count; `.all()`/`.any()` probes
        divert the rare mixed cases onto slower branches."""
        si = self.sidx.get(sender)
        if si is None:
            return
        pi, dups = self._indices(proposers)
        if pi.size == 0:
            return
        rs = self.round_state[pi]
        on = rs == rnd
        if on.all():
            sel = pi
        else:
            # future rounds: scalar fallback (rare — round-horizon
            # parking; replay order is preserved by BBA._future).
            # Stale (rnd < current round, or halted at the sentinel)
            # drops vectorized — same as _gated's stale return,
            # without N python calls per frame.
            fut = pi[rs < rnd]
            if fut.size:
                from cleisthenes_tpu_torch.transport.message import BbaType

                t = BbaType.BVAL if is_bval else BbaType.AUX
                for i in fut:
                    bba = self.bbas[i]
                    if bba is not None:
                        bba.handle_vote(sender, t, rnd, value)
            sel = pi[on]
            if sel.size == 0:
                return
        if dups:  # only Byzantine batches repeat instances
            sel = np.unique(sel)
        vi = 1 if value else 0
        metrics = self.metrics
        if is_bval:
            row = self.bval_seen[si, vi]
            seen = row[sel]
            if seen.any():
                new = sel[~seen]
                if metrics is not None:
                    metrics.dedup_absorbed.inc(int(sel.size - new.size))
                if new.size == 0:
                    return
            else:
                new = sel
            row[new] = True
            cnt = self.bval_cnt[vi]
            cnt[new] += 1
            cnts = cnt[new]
            relay = new[cnts == self.f + 1]
            grow = new[cnts == self.q_large]
            bbas = self.bbas
            # f+1 same bval -> relay once; q_large -> bin_values union
            # (docs/BBA-EN.md:47-58)
            for i in relay:
                bba = bbas[i]
                if bba is not None and not bba.halted:
                    bba.on_bval_relay(value)
            for i in grow:
                bba = bbas[i]
                if bba is not None and not bba.halted:
                    bba.on_bval_bin(value)
        else:
            row = self.aux_seen[si]
            seen = row[sel]
            if seen.any():
                new = sel[~seen]
                if metrics is not None:
                    metrics.dedup_absorbed.inc(int(sel.size - new.size))
                if new.size == 0:
                    return
            else:
                new = sel
            row[new] = True
            cnt = self.aux_cnt[vi]
            cnt[new] += 1
            # quorum trigger: good >= n-f (>=, not ==: bin_values
            # growth also moves `good`, so equality could be skipped;
            # post-quorum extras are cheap idempotent no-ops in BBA)
            binf = self.bin_flags[new]
            good = self.aux_cnt[1][new] * binf[:, 1] + (
                self.aux_cnt[0][new] * binf[:, 0]
            )
            n = len(self.members)
            trig = new[(good >= n - self.f) & ~self.aux_fired[new]]
            if trig.size == 0:
                return
            # fire ONCE per row: post-quorum receipts change nothing
            # the quorum path reads (advancement re-probes happen on
            # coin reveal and bin growth, which have their own
            # triggers); vals are read at advance time either way
            self.aux_fired[trig] = True
            bbas = self.bbas
            for i in trig:
                bba = bbas[i]
                if bba is not None and not bba.halted:
                    bba.on_aux_quorum()


__all__ = ["VoteBank"]
