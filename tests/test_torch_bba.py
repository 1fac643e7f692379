# The reference's tests/test_bba.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""BBA protocol tests: agreement, validity, probabilistic termination,
crash/Byzantine tolerance — full multi-node instances over the
deterministic in-proc transport (the behavior matrix of reference
docs/BBA-EN.md, which the skeleton bba/bba.go:63-107 never filled in)."""

import dataclasses

import pytest

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.ops import tpke
from cleisthenes_tpu_torch.ops.coin import CommonCoin
from cleisthenes_tpu_torch.protocol.bba import BBA
from cleisthenes_tpu_torch.transport.base import HmacAuthenticator
from cleisthenes_tpu_torch.transport.broadcast import ChannelBroadcaster
from cleisthenes_tpu_torch.transport.channel import ChannelNetwork
from cleisthenes_tpu_torch.transport.message import BbaType, CoinPayload


class BbaHandler:
    def __init__(self, bba: BBA):
        self.bba = bba

    def serve_request(self, msg):
        self.bba.handle_message(msg.sender_id, msg.payload)


def make_bba_network(n, seed=None, auth=False, proposer_idx=0):
    cfg = Config(n=n, crypto_backend="cpu")
    ids = [f"node{i}" for i in range(n)]
    proposer = ids[proposer_idx]
    pub, secrets = tpke.deal(n, cfg.f + 1, seed=7)
    coin = CommonCoin(pub, backend="cpu")
    net = ChannelNetwork(seed=seed)
    bbas = {}
    for i, node_id in enumerate(ids):
        bba = BBA(
            config=cfg,
            epoch=0,
            proposer=proposer,
            owner=node_id,
            member_ids=ids,
            coin=coin,
            coin_secret=secrets[i],
            out=ChannelBroadcaster(net, node_id, ids),
        )
        bbas[node_id] = bba
        net.join(
            node_id,
            BbaHandler(bba),
            HmacAuthenticator.derive(b"master", node_id, ids) if auth else None,
        )
    return cfg, net, bbas


def assert_agreement(bbas, skip=()):
    decisions = {
        nid: b.result() for nid, b in bbas.items() if nid not in skip
    }
    assert all(d is not None for d in decisions.values()), decisions
    assert len(set(decisions.values())) == 1, decisions
    return next(iter(decisions.values()))


@pytest.mark.parametrize("value", [True, False])
def test_bba_unanimous_input_decides_that_value(value):
    """Validity: if every correct node inputs v, the decision is v."""
    cfg, net, bbas = make_bba_network(4)
    for bba in bbas.values():
        bba.input(value)
    net.run()
    assert assert_agreement(bbas) == value


@pytest.mark.parametrize("seed", [1, 2, 3, 11, 42])
def test_bba_mixed_inputs_agree_under_adversarial_scheduling(seed):
    cfg, net, bbas = make_bba_network(4, seed=seed, auth=True)
    for i, bba in enumerate(bbas.values()):
        bba.input(i % 2 == 0)
    net.run()
    assert_agreement(bbas)


@pytest.mark.parametrize("seed", [5, 9])
def test_bba_n7_mixed_inputs(seed):
    cfg, net, bbas = make_bba_network(7, seed=seed)
    for i, bba in enumerate(bbas.values()):
        bba.input(i < 3)
    net.run()
    assert_agreement(bbas)


def test_bba_tolerates_f_crashes():
    cfg, net, bbas = make_bba_network(7, seed=3)
    net.crash("node5")
    net.crash("node6")
    for nid, bba in bbas.items():
        if nid not in ("node5", "node6"):
            bba.input(True)
    net.run()
    assert assert_agreement(bbas, skip=("node5", "node6")) is True


def test_bba_unanimous_with_crashes_keeps_validity():
    cfg, net, bbas = make_bba_network(4, seed=8)
    net.crash("node3")
    for nid, bba in bbas.items():
        if nid != "node3":
            bba.input(False)
    net.run()
    assert assert_agreement(bbas, skip=("node3",)) is False


def test_bba_all_instances_halt_after_decision():
    """The TERM gadget must fully drain: 2f+1 TERMs halt every node."""
    cfg, net, bbas = make_bba_network(4, seed=2)
    for bba in bbas.values():
        bba.input(True)
    net.run()
    for bba in bbas.values():
        assert bba.done
        assert bba.halted  # saw 2f+1 TERM


def test_bba_late_input_still_decides():
    """A node whose ACS input arrives late must catch up (the
    passive-participation path; ACS inputs 0 only after n-f ones)."""
    cfg, net, bbas = make_bba_network(4)
    for nid, bba in bbas.items():
        if nid != "node3":
            bba.input(True)
    net.run()
    bbas["node3"].input(True)
    net.run()
    assert_agreement(bbas)


def test_bba_garbage_coin_shares_are_rejected():
    """Byzantine coin shares must fail CP verification and never skew
    or block the coin (docs/BBA-EN.md:174-177 cooperation property)."""
    cfg, net, bbas = make_bba_network(4, seed=6)

    from cleisthenes_tpu_torch.transport.message import (
        decode_message,
        encode_message,
    )

    def corrupt_node2_coins(sender, receiver, wire):
        if sender != "node2":
            return wire
        msg = decode_message(wire)
        if isinstance(msg.payload, CoinPayload):
            bad = msg.payload._replace(d=12345, z=99999)
            return encode_message(dataclasses.replace(msg, payload=bad))
        return wire

    net.fault_filter = corrupt_node2_coins
    for bba in bbas.values():
        bba.input(True)
    net.run()
    assert assert_agreement(bbas) is True


def test_bba_byzantine_equivocating_bvals_no_split():
    """One node sending BVAL(0) to half and BVAL(1) to the other half
    must not break agreement."""
    cfg, net, bbas = make_bba_network(4, seed=13)

    from cleisthenes_tpu_torch.transport.message import (
        BbaPayload,
        decode_message,
        encode_message,
    )

    def equivocate(sender, receiver, wire):
        if sender != "node0":
            return wire
        msg = decode_message(wire)
        p = msg.payload
        if isinstance(p, BbaPayload) and p.type == BbaType.BVAL:
            flip = receiver in ("node1", "node3")
            bad = p._replace(value=p.value ^ flip)
            return encode_message(dataclasses.replace(msg, payload=bad))
        return wire

    net.fault_filter = equivocate
    for nid, bba in bbas.items():
        bba.input(nid in ("node0", "node1"))
    net.run()
    assert_agreement(bbas, skip=("node0",))


def test_bba_result_none_before_decision():
    cfg, net, bbas = make_bba_network(4)
    assert all(b.result() is None for b in bbas.values())
    assert all(not b.done for b in bbas.values())
