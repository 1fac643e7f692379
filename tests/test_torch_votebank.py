# The reference's tests/test_votebank.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""VoteBank (protocol/votebank.py): columnar BVAL/AUX receipt state.

The bank is the single source of truth for the current round's vote
bookkeeping across all of an epoch's BBA instances; these tests pin
the columnar/scalar equivalence and the Byzantine-shaped edges the
batch path must absorb (duplicate proposers in one frame, stale
rounds, unknown senders/instances, halted rows)."""

import numpy as np

from cleisthenes_tpu_torch.protocol.votebank import VoteBank
from cleisthenes_tpu_torch.transport.message import BbaType

MEMBERS = [f"n{i}" for i in range(4)]


class _StubBBA:
    """Records crossing callbacks; stands in for protocol.bba.BBA."""

    def __init__(self):
        self.halted = False
        self.relays = []
        self.bins = []
        self.aux_quorums = 0
        self.parked = []

    def on_bval_relay(self, value):
        self.relays.append(value)

    def on_bval_bin(self, value):
        self.bins.append(value)

    def on_aux_quorum(self):
        self.aux_quorums += 1

    def handle_vote(self, sender, t, rnd, value):
        self.parked.append((sender, t, rnd, value))


def _bank(f=1):
    bank = VoteBank(MEMBERS, f)
    bbas = []
    for i, m in enumerate(MEMBERS):
        b = _StubBBA()
        bank.attach(i, b)
        bbas.append(b)
    return bank, bbas


def test_scalar_and_columnar_counts_agree():
    bank, bbas = _bank()
    # columnar: n0 votes BVAL(True) across all instances
    bank.batch_vote("n0", True, 0, True, tuple(MEMBERS))
    # scalar write-through for one instance from n1
    assert bank.bval_add(2, bank.sidx["n1"], True) == 2
    assert int(bank.bval_cnt[1, 2]) == 2
    assert int(bank.bval_cnt[1, 0]) == 1
    # duplicate scalar add is rejected
    assert bank.bval_add(2, bank.sidx["n1"], True) is None


def test_crossings_fire_exactly_once_per_threshold():
    bank, bbas = _bank(f=1)
    # f+1 = 2 distinct senders -> relay; 2f+1 = 3 -> bin growth
    for s in ("n0", "n1", "n2"):
        bank.batch_vote(s, True, 0, True, tuple(MEMBERS))
    for b in bbas:
        assert b.relays == [True]
        assert b.bins == [True]
    # a 4th sender crosses no new threshold
    bank.batch_vote("n3", True, 0, True, tuple(MEMBERS))
    for b in bbas:
        assert b.relays == [True] and b.bins == [True]


def test_duplicate_proposers_in_one_frame_count_once():
    bank, bbas = _bank(f=1)
    dup = (MEMBERS[0],) * 5 + tuple(MEMBERS)
    bank.batch_vote("n0", True, 0, True, dup)
    assert int(bank.bval_cnt[1, 0]) == 1  # one sender, one count


def test_duplicate_frames_from_same_sender_count_once():
    bank, bbas = _bank(f=1)
    bank.batch_vote("n0", True, 0, True, tuple(MEMBERS))
    bank.batch_vote("n0", True, 0, True, tuple(MEMBERS))
    assert int(bank.bval_cnt[1, 0]) == 1


def test_stale_votes_drop_without_scalar_fallback():
    bank, bbas = _bank()
    bank.reset_row(0, 3)  # instance 0 is at round 3
    bank.batch_vote("n0", True, 1, True, (MEMBERS[0],))
    assert bbas[0].parked == []  # stale: vectorized drop
    assert int(bank.bval_cnt[1, 0]) == 0


def test_future_votes_park_via_scalar_fallback():
    bank, bbas = _bank()
    bank.batch_vote("n0", True, 2, True, (MEMBERS[1],))
    assert bbas[1].parked == [("n0", BbaType.BVAL, 2, True)]


def test_unknown_sender_and_instance_ignored():
    bank, bbas = _bank()
    bank.batch_vote("stranger", True, 0, True, tuple(MEMBERS))
    bank.batch_vote("n0", True, 0, True, ("ghost",))
    assert not bank.bval_seen.any()


def test_halted_rows_drop_vectorized():
    bank, bbas = _bank()
    bank.deactivate(1)
    bank.batch_vote("n0", True, 0, True, tuple(MEMBERS))
    assert int(bank.bval_cnt[1, 1]) == 0
    assert int(bank.bval_cnt[1, 0]) == 1


def test_aux_quorum_trigger_needs_bin_flags():
    bank, bbas = _bank(f=1)  # n-f = 3
    for s in ("n0", "n1", "n2"):
        bank.batch_vote(s, False, 0, True, tuple(MEMBERS))  # AUX
    # no bin flags yet: no quorum callbacks
    assert all(b.aux_quorums == 0 for b in bbas)
    bank.set_bin(0, True)
    # quorum computed on the NEXT aux arrival for instance 0
    bank.batch_vote("n3", False, 0, True, (MEMBERS[0],))
    assert bbas[0].aux_quorums == 1
    assert bank.aux_good(0) == 4
    assert bank.aux_vals(0) == {True}


def test_reset_row_clears_everything():
    bank, bbas = _bank()
    bank.batch_vote("n0", True, 0, True, tuple(MEMBERS))
    bank.batch_vote("n0", False, 0, False, tuple(MEMBERS))
    bank.set_bin(0, True)
    bank.reset_row(0, 1)
    assert not bank.bval_seen[:, :, 0].any()
    assert not bank.aux_seen[:, 0].any()
    assert not bank.bin_flags[0].any()
    assert bank.round_state[0] == 1
    # other rows untouched
    assert bank.bval_seen[:, :, 1].any()
