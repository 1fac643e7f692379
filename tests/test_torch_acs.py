# The reference's tests/test_acs.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""ACS tests: validity, agreement, totality (docs/HONEYBADGER-EN.md:34-37)
over the deterministic in-proc transport."""

import pytest

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.ops import tpke
from cleisthenes_tpu_torch.ops.backend import get_backend
from cleisthenes_tpu_torch.ops.coin import CommonCoin
from cleisthenes_tpu_torch.protocol.acs import ACS
from cleisthenes_tpu_torch.transport.base import HmacAuthenticator
from cleisthenes_tpu_torch.transport.broadcast import ChannelBroadcaster
from cleisthenes_tpu_torch.transport.channel import ChannelNetwork


class AcsHandler:
    def __init__(self, acs: ACS):
        self.acs = acs

    def serve_request(self, msg):
        self.acs.handle_message(msg.sender_id, msg.payload)


def make_acs_network(n, seed=None, auth=False):
    cfg = Config(n=n, crypto_backend="cpu")
    crypto = get_backend(cfg)
    ids = [f"node{i}" for i in range(n)]
    pub, secrets = tpke.deal(n, cfg.f + 1, seed=21)
    coin = CommonCoin(pub, backend="cpu")
    net = ChannelNetwork(seed=seed)
    acss = {}
    for i, node_id in enumerate(ids):
        acs = ACS(
            config=cfg,
            crypto=crypto,
            epoch=0,
            owner=node_id,
            member_ids=ids,
            coin=coin,
            coin_secret=secrets[i],
            out=ChannelBroadcaster(net, node_id, ids),
        )
        acss[node_id] = acs
        net.join(
            node_id,
            AcsHandler(acs),
            HmacAuthenticator.derive(b"acs-master", node_id, ids)
            if auth
            else None,
        )
    return cfg, net, acss


def proposals(acss):
    return {nid: f"proposal-from-{nid}".encode() * 8 for nid in acss}


def assert_common_output(acss, skip=()):
    outs = {nid: a.output() for nid, a in acss.items() if nid not in skip}
    assert all(o is not None for o in outs.values()), {
        k: (v if v is None else len(v)) for k, v in outs.items()
    }
    first = next(iter(outs.values()))
    for nid, o in outs.items():
        assert o == first, f"{nid} disagrees"
    return first


def test_acs_all_inputs_all_oucudat_same_set():
    cfg, net, acss = make_acs_network(4)
    props = proposals(acss)
    for nid, acs in acss.items():
        acs.input(props[nid])
    net.run()
    out = assert_common_output(acss)
    # validity: at least n-f proposals make it
    assert len(out) >= cfg.n - cfg.f
    for proposer, value in out.items():
        assert value == props[proposer]


@pytest.mark.parametrize("seed", [1, 4, 9, 23])
def test_acs_agreement_under_adversarial_scheduling(seed):
    cfg, net, acss = make_acs_network(4, seed=seed, auth=True)
    props = proposals(acss)
    for nid, acs in acss.items():
        acs.input(props[nid])
    net.run()
    out = assert_common_output(acss)
    assert len(out) >= cfg.n - cfg.f


@pytest.mark.parametrize("seed", [2, 7])
def test_acs_n7_with_f_crashed_nodes(seed):
    cfg, net, acss = make_acs_network(7, seed=seed)
    crashed = ("node5", "node6")
    for c in crashed:
        net.crash(c)
    props = proposals(acss)
    for nid, acs in acss.items():
        if nid not in crashed:
            acs.input(props[nid])
    net.run()
    out = assert_common_output(acss, skip=crashed)
    assert len(out) >= cfg.n - cfg.f
    # crashed nodes' proposals were never made, so can't be in the set
    for c in crashed:
        assert c not in out


def test_acs_silent_proposer_excluded_but_others_commit():
    """One correct-but-silent node (no input) must not block ACS."""
    cfg, net, acss = make_acs_network(4, seed=3)
    props = proposals(acss)
    for nid, acs in acss.items():
        if nid != "node2":
            acs.input(props[nid])
    net.run()
    out = assert_common_output(acss)
    assert len(out) >= cfg.n - cfg.f
    for proposer, value in out.items():
        assert value == props[proposer]


def test_acs_oucudat_fires_exactly_once():
    cfg, net, acss = make_acs_network(4)
    fired = []
    acss["node1"].on_output = lambda epoch, out: fired.append((epoch, out))
    props = proposals(acss)
    for nid, acs in acss.items():
        acs.input(props[nid])
    net.run()
    assert len(fired) == 1
    assert fired[0][0] == 0
    assert fired[0][1] == acss["node1"].output()


def test_coin_index_replay_does_not_stall():
    """A Byzantine member re-issuing an HONEST node's coin shares
    (same Shamir index, valid CP proof — the textbook share replay)
    must not stall any instance's coin: a threshold-SIZE pool can be
    index-under-covered, and the row store's watch re-notification
    must pull genuinely distinct indices as they arrive (the coin
    analog of the dec-share crossing-stall regression)."""
    for seed in (None, 3, 11):
        cfg, net, acss = make_acs_network(4, seed=seed)
        # node3 clones node0's coin secret: every share it issues is a
        # byte-perfect replay of node0's (valid, index-colliding)
        donor = acss["node0"].bbas["node0"].coin_secret
        for bba in acss["node3"].bbas.values():
            bba.coin_secret = donor
        props = proposals(acss)
        for nid, acs in acss.items():
            acs.input(props[nid])
        net.run()
        out = assert_common_output(acss)
        assert set(out) == set(props) or len(out) >= len(acss) - cfg.f
