# The reference's tests/test_attest.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Attested sender log tests (protocol/attest.py, Config.attested_log
/ Config.reduced_quorum).

Unit layer: slot extraction semantics, vault refusal + restart
monotonicity, the authenticator's counter policy (replay, regression,
missing/forged trailers, fork evidence -> exclusion).

Cluster layer: the Equivocator behavior mounted under
``attested_log=True`` — its per-receiver RBC lies hit the vault at the
``sign_wire_wave`` egress, ship self-incriminating ``refused=1``
stamps, and every honest receiver records the counter-fork evidence
and excludes the sender while the honest ledgers stay identical.  The
reduced-quorum (2f+1) arm rides the same plane: n=5/f=2 commits with
``quorum_large = n - f``.

Module carries the ``faults`` marker (ci.sh fault-regression stage).
"""

import pytest

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.protocol.attest import (
    ATTEST_LEN,
    AttestationDirectory,
    AttestingAuthenticator,
    payload_slots,
)
from cleisthenes_tpu_torch.protocol.byzantine import Equivocator
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster
from cleisthenes_tpu_torch.transport.message import (
    BbaPayload,
    BbaType,
    BundlePayload,
    EchoBatchPayload,
    Message,
    RbcPayload,
    RbcType,
)

pytestmark = pytest.mark.faults


# ---------------------------------------------------------------------------
# unit: slots and vault
# ---------------------------------------------------------------------------


def _slots(payload):
    out = []
    payload_slots(payload, out)
    return out


def test_payload_slot_semantics():
    """Slots bind exactly the statements a correct node makes once:
    RBC roots per (epoch, proposer, type), BBA AUX/TERM values per
    round — and BVAL (legally two-valued) is NOT slotted."""
    val = RbcPayload(RbcType.VAL, "p", 3, root_hash=b"R" * 32)
    assert _slots(val) == [(("rbc", 3, "p", int(RbcType.VAL)), b"R" * 32)]
    # per-receiver branch/shard differences do NOT change the slot digest
    val2 = RbcPayload(
        RbcType.VAL, "p", 3, root_hash=b"R" * 32, shard=b"x", shard_index=1
    )
    assert _slots(val2) == _slots(val)
    aux = BbaPayload(BbaType.AUX, "p", 3, 0, True)
    assert _slots(aux) == [(("bba", 3, "p", 0, int(BbaType.AUX)), b"\x01")]
    bval = BbaPayload(BbaType.BVAL, "p", 3, 0, True)
    assert _slots(bval) == []
    batch = EchoBatchPayload(
        epoch=3, shard_index=0, proposers=("a", "b"),
        roots=(b"A" * 32, b"B" * 32), branches=((), ()), shards=(b"", b""),
    )
    assert len(_slots(batch)) == 2
    bundle = BundlePayload(items=(val, aux, bval))
    assert len(_slots(bundle)) == 2


def test_vault_refuses_forks_and_survives_restart():
    """First digest per slot wins; a different digest is refused (and
    counted) but the same digest re-attests freely.  Re-attaching —
    the process-restart path — bumps the incarnation while KEEPING the
    slot registry, so a crash cannot launder a second dealing."""
    d = AttestationDirectory()
    vault = d.attach("n0")
    a = RbcPayload(RbcType.ECHO, "p", 0, root_hash=b"A" * 32)
    b = RbcPayload(RbcType.ECHO, "p", 0, root_hash=b"B" * 32)
    assert vault.observe(a) is False
    assert vault.observe(a) is False  # same statement: fine
    assert vault.observe(b) is True  # fork: refused
    assert vault.refusals == 1
    inc1 = vault.incarnation
    vault2 = d.attach("n0")  # "restart"
    assert vault2.incarnation == inc1 + 1
    assert vault2.observe(b) is True  # registry survived the restart
    assert vault2.observe(a) is False


def _pair(directory=None):
    """Two attesting authenticators sharing one pair key."""
    d = directory or AttestationDirectory()
    key = b"k" * 32
    a = AttestingAuthenticator("a", {"b": key}, d.attach("a"))
    b = AttestingAuthenticator("b", {"a": key}, d.attach("b"))
    return a, b, d


def _msg(root=b"R" * 32, epoch=0):
    return Message(
        sender_id="a",
        timestamp=1.0,
        payload=RbcPayload(RbcType.VAL, "a", epoch, root_hash=root),
    )


def test_authenticator_counter_policy():
    """Replays, stripped trailers and forged trailer MACs are rejected
    loudly; fresh frames verify."""
    a, b, _ = _pair()
    m1 = a.sign(_msg(), "b")
    assert len(m1.attestation) == ATTEST_LEN
    assert b.verify(m1) is True
    # exact replay: the (incarnation, seq) pair was already seen
    assert b.verify(m1) is False
    assert b.attest_stats["regressions"] == 1
    # stripped trailer
    m2 = a.sign(_msg(epoch=1), "b")
    stripped = Message(m2.sender_id, m2.timestamp, m2.payload, m2.signature)
    assert b.verify(stripped) is False
    assert b.attest_stats["missing"] == 1
    # forged trailer MAC (flip one byte)
    att = bytearray(m2.attestation)
    att[-1] ^= 0x01
    forged = Message(
        m2.sender_id, m2.timestamp, m2.payload, m2.signature, bytes(att)
    )
    assert b.verify(forged) is False
    assert b.attest_stats["bad_mac"] == 1
    # the untampered original still verifies after all that
    assert b.verify(m2) is True


def test_refused_stamp_is_fork_evidence_not_a_sender_ban():
    """A refused=1 stamp — the only thing an equivocator can ship for
    a forked slot — makes the receiver record fork evidence in the
    directory and reject THAT frame.  The sender's refused=0 traffic
    must keep verifying: at n = 2f+1 the accused node's honest votes
    are load-bearing, so detection is per-statement omission plus an
    accusation, never a wholesale frame ban."""
    a, b, d = _pair()
    assert b.verify(a.sign(_msg(root=b"A" * 32), "b"))
    m_forked = a.sign(_msg(root=b"B" * 32), "b")  # vault refuses
    assert b.verify(m_forked) is False
    assert b.attest_stats["forks"] == 1
    assert b.accused_senders() == {"a"}
    assert d.accused == {"a"}
    assert d.fork_reports["a"][0][0] == "b"  # (reporter, inc, seq)
    # an honest (refused=0) frame from the accused sender still flows
    assert b.verify(a.sign(_msg(root=b"A" * 32, epoch=2), "b")) is True
    # but a second lie is rejected and tallied just like the first
    assert b.verify(a.sign(_msg(root=b"C" * 32, epoch=2), "b")) is False
    assert b.attest_stats["forks"] == 2


def test_incarnation_regression_rejected():
    """Pre-restart frames (old incarnation) replayed after a restart
    are counter regressions, not valid traffic."""
    d = AttestationDirectory()
    key = b"k" * 32
    a1 = AttestingAuthenticator("a", {"b": key}, d.attach("a"))
    old = a1.sign(_msg(), "b")
    a2 = AttestingAuthenticator("a", {"b": key}, d.attach("a"))  # restart
    b = AttestingAuthenticator("b", {"a": key}, d.attach("b"))
    assert b.verify(a2.sign(_msg(), "b")) is True  # incarnation 2
    assert b.verify(old) is False  # incarnation 1: regression
    assert b.attest_stats["regressions"] == 1


# ---------------------------------------------------------------------------
# cluster: equivocation under the attested log
# ---------------------------------------------------------------------------


def _drive(cluster, bad=(), txs=12, max_rounds=30):
    honest = [i for i in cluster.ids if i not in bad]
    for i in range(txs):
        cluster.submit(b"tx-%04d" % i, node_id=honest[i % len(honest)])
    cluster.run_until_drained(max_rounds=max_rounds, skip=bad)
    return cluster.assert_agreement(skip=bad)


def test_equivocator_detected_and_excluded_under_attested_log():
    """The tentpole contract: an Equivocator under attested_log=True
    ships self-incriminating refused=1 stamps — honest receivers
    record counter-fork evidence (the exclusion surface the reconfig
    plane evicts on), reject the lied frames, and commit identical
    ledgers (equivocation degraded to omission of the lies)."""
    bad = "node000"
    c = SimulatedCluster(
        n=4,
        batch_size=8,
        seed=13,
        config=Config(n=4, batch_size=8, attested_log=True, crypto_backend="cpu"),
        behaviors={bad: Equivocator(seed=21)},
    )
    depth = _drive(c, (bad,))
    assert depth >= 1
    assert c.behaviors[bad].rewrites > 0, "the adversary never lied"
    # the equivocator's vault refused at least one forked slot
    assert c.auths[bad].vault.refusals > 0
    # fork evidence reached the directory, against the equivocator ONLY
    assert c.attest_dir.accused == {bad}
    reporters = {rep for rep, _, _ in c.attest_dir.fork_reports[bad]}
    assert reporters and bad not in reporters
    # every reporter holds the accusation at its authenticator
    for nid in reporters:
        assert c.auths[nid].accused_senders() == {bad}
        assert c.auths[nid].attest_stats["forks"] > 0
    # and no honest node was ever accused of anything
    for nid in c.ids:
        if nid != bad:
            assert c.auths[nid].vault.refusals == 0


def test_attested_log_clean_run_has_no_evidence():
    """Baseline attested run (no adversary): trailers verify, no
    forks, no exclusions, no refusals — the plane is inert overhead."""
    c = SimulatedCluster(
        n=4,
        batch_size=8,
        seed=5,
        config=Config(n=4, batch_size=8, attested_log=True, crypto_backend="cpu"),
    )
    assert _drive(c) >= 1
    assert c.attest_dir.accused == set()
    for nid in c.ids:
        st = c.auths[nid].attest_stats
        assert st["forks"] == 0
        assert st["missing"] == 0
        assert st["bad_mac"] == 0
        assert c.auths[nid].vault.refusals == 0


def test_attested_arm_matches_plain_ledgers():
    """ARM pin: the attested_log=True arm commits the same ledger
    bytes as the attested_log=False baseline for an identical seeded
    run — the trailer is additive, never schedule-changing."""
    ledgers = {}
    for flag in (False, True):
        cfg = (
            Config(n=4, batch_size=8, attested_log=True, crypto_backend="cpu")
            if flag
            else Config(n=4, batch_size=8, attested_log=False, crypto_backend="cpu")
        )
        c = SimulatedCluster(n=4, batch_size=8, seed=7, config=cfg)
        assert _drive(c, txs=8) >= 1
        ledgers[flag] = [
            tuple(b.tx_list())
            for b in c.nodes[c.ids[0]].committed_batches
        ]
    assert ledgers[False] == ledgers[True]


# ---------------------------------------------------------------------------
# reduced-quorum arm
# ---------------------------------------------------------------------------


def test_reduced_quorum_requires_attested_log():
    with pytest.raises(ValueError, match="requires attested_log"):
        Config(n=5, reduced_quorum=True, attested_log=False, crypto_backend="cpu")


def test_reduced_quorum_arithmetic():
    """n=5 carries f=2 in reduced mode (3f+1 would need n=7): the
    large quorum is n-f=3 and the erasure split is n-2f=1 data shard;
    at the baseline shape n=3f+1 the two arms agree exactly."""
    cfg = Config(n=5, attested_log=True, reduced_quorum=True, crypto_backend="cpu")
    assert (cfg.f, cfg.quorum_large) == (2, 3)
    base = Config(n=7, reduced_quorum=False, crypto_backend="cpu")
    red = Config(n=7, f=2, attested_log=True, reduced_quorum=True, crypto_backend="cpu")
    assert base.quorum_large == red.quorum_large == 5  # n=3f+1: identical


def test_reduced_quorum_cluster_commits_n5():
    """An n=5 roster tolerating f=2 — impossible under 3f+1 — commits
    and agrees under the attested 2f+1 trust model."""
    c = SimulatedCluster(
        n=5,
        config=Config(
            n=5, batch_size=8, attested_log=True, reduced_quorum=True, crypto_backend="cpu"
        ),
        seed=11,
    )
    assert _drive(c, txs=10) >= 1
    committed = sum(
        len(b) for b in c.nodes[c.ids[0]].committed_batches
    )
    assert committed == 10


def test_reduced_quorum_survives_equivocator_at_full_budget():
    """n=5, f=2 reduced quorum with an equivocating member: the
    attested log converts the equivocation to omission and the
    remaining 4 >= n-f honest nodes stay live and consistent."""
    bad = "node004"
    c = SimulatedCluster(
        n=5,
        config=Config(
            n=5,
            batch_size=8,
            attested_log=True,
            reduced_quorum=True,
            crypto_backend="cpu",
        ),
        seed=17,
        behaviors={bad: Equivocator(seed=23)},
    )
    depth = _drive(c, (bad,), txs=10)
    assert depth >= 1
    assert c.behaviors[bad].rewrites > 0
    # detection fired iff the equivocator actually forked a slot that
    # reached a receiver; with per-receiver VAL/ECHO lies it must have
    assert c.attest_dir.accused == {bad}
