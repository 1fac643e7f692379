# The reference's tests/test_rbc.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""RBC protocol tests: the behavior matrix the reference's TDD
placeholders enumerate (reference rbc/rbc_test.go:5-19,
rbc/rbc_internal_test.go:5-31) plus Byzantine cases, run as full
multi-node instances over the deterministic in-proc transport
(SURVEY.md §4.3 pattern)."""

import hashlib

import pytest

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.ops.backend import get_backend
from cleisthenes_tpu_torch.protocol.rbc import RBC
from cleisthenes_tpu_torch.transport.base import HmacAuthenticator
from cleisthenes_tpu_torch.transport.broadcast import ChannelBroadcaster
from cleisthenes_tpu_torch.transport.channel import ChannelNetwork
from cleisthenes_tpu_torch.transport.message import RbcType


class RbcHandler:
    """Minimal node: every inbound message goes to one RBC instance."""

    def __init__(self, rbc: RBC):
        self.rbc = rbc

    def serve_request(self, msg):
        self.rbc.handle_message(msg.sender_id, msg.payload)


def make_rbc_network(n, proposer_idx=0, seed=None, auth=False, epoch=0):
    cfg = Config(n=n, crypto_backend="cpu")
    crypto = get_backend(cfg)
    ids = [f"node{i}" for i in range(n)]
    proposer = ids[proposer_idx]
    net = ChannelNetwork(seed=seed)
    rbcs = {}
    master = b"test-master-secret"
    for node_id in ids:
        rbc = RBC(
            config=cfg,
            crypto=crypto,
            epoch=epoch,
            proposer=proposer,
            owner=node_id,
            member_ids=ids,
            out=ChannelBroadcaster(net, node_id, ids),
        )
        rbcs[node_id] = rbc
        net.join(
            node_id,
            RbcHandler(rbc),
            HmacAuthenticator.derive(master, node_id, ids) if auth else None,
        )
    return cfg, net, rbcs, proposer


PAYLOAD = b"tx-batch|" + bytes(range(256)) * 9 + b"|end"


def test_rbc_all_nodes_deliver_n4():
    cfg, net, rbcs, proposer = make_rbc_network(4)
    rbcs[proposer].propose(PAYLOAD)
    net.run()
    for node_id, rbc in rbcs.items():
        assert rbc.delivered, f"{node_id} did not deliver"
        assert rbc.value() == PAYLOAD


@pytest.mark.parametrize("seed", [1, 2, 3, 17])
def test_rbc_delivers_under_adversarial_scheduling(seed):
    cfg, net, rbcs, proposer = make_rbc_network(7, seed=seed, auth=True)
    rbcs[proposer].propose(PAYLOAD)
    net.run()
    for rbc in rbcs.values():
        assert rbc.value() == PAYLOAD


def test_rbc_tolerates_f_crashes():
    # n=7, f=2: crash two non-proposer nodes before the proposal
    cfg, net, rbcs, proposer = make_rbc_network(7, seed=5)
    net.crash("node5")
    net.crash("node6")
    rbcs[proposer].propose(PAYLOAD)
    net.run()
    for node_id, rbc in rbcs.items():
        if node_id in ("node5", "node6"):
            continue
        assert rbc.value() == PAYLOAD


def test_rbc_on_deliver_callback_fires_once():
    cfg, net, rbcs, proposer = make_rbc_network(4)
    got = []
    rbcs["node2"].on_deliver = lambda p, v: got.append((p, v))
    rbcs[proposer].propose(PAYLOAD)
    net.run()
    assert got == [(proposer, PAYLOAD)]


def test_rbc_rejects_non_proposer_val():
    """VAL from anyone but the proposer must be ignored
    (reference rbc/rbc.go:56-58 handleValueRequest is proposer-scoped)."""
    cfg, net, rbcs, proposer = make_rbc_network(4)
    impostor = "node3"
    # node3 crafts a full proposal as if it were the proposer
    fake = RBC(
        config=cfg,
        crypto=get_backend(cfg),
        epoch=0,
        proposer=impostor,  # its own instance id...
        owner=impostor,
        member_ids=list(rbcs),
        out=ChannelBroadcaster(net, impostor, list(rbcs)),
    )
    # ...but stamp the payloads with the real proposer's instance by
    # sending through the real network as node3: receivers route it to
    # proposer node0's instance, whose VAL check must reject node3.
    fake.proposer = proposer
    fake.owner = proposer  # bypass the local propose() ownership guard
    fake.propose(b"forged value")
    net.run()
    for rbc in rbcs.values():
        assert not rbc.delivered


def test_rbc_equivocating_proposer_never_splits_delivery():
    """A proposer sending two different values to two halves of the
    roster must not get two values delivered (agreement)."""
    n = 4
    cfg, net, rbcs, proposer = make_rbc_network(n)
    ids = sorted(rbcs)
    crypto = get_backend(cfg)

    # Byzantine proposer: two separate encodings, VALs interleaved
    def forged_vals(value):
        from cleisthenes_tpu_torch.ops.payload import split_payload
        from cleisthenes_tpu_torch.transport.message import RbcPayload

        data = split_payload(value, cfg.data_shards)
        shards = crypto.erasure.encode(data)
        tree = crypto.merkle.build(shards)
        return [
            RbcPayload(
                type=RbcType.VAL,
                proposer=proposer,
                epoch=0,
                root_hash=tree.root,
                branch=tuple(tree.branch(j)),
                shard=shards[j].tobytes(),
                shard_index=j,
            )
            for j in range(n)
        ]

    vals_a = forged_vals(b"value A" * 50)
    vals_b = forged_vals(b"value B" * 50)
    out = ChannelBroadcaster(net, proposer, ids)
    for j, node_id in enumerate(ids):
        out.send_to(node_id, vals_a[j] if j % 2 == 0 else vals_b[j])
    net.run()
    delivered = {r.value() for r in rbcs.values() if r.delivered}
    assert len(delivered) <= 1  # agreement: never two values


def test_rbc_tampered_echo_rejected_by_mac():
    """Bit-flipped wire bytes must be dropped by the authenticator
    (the implemented version of conn.go:134-137's TODO)."""
    cfg, net, rbcs, proposer = make_rbc_network(4, auth=True)

    from cleisthenes_tpu_torch.transport.message import decode_message

    tampered = []

    def flip_echo(sender, receiver, wire):
        if (
            sender == "node1"
            and decode_message(wire).payload.type == RbcType.ECHO
        ):
            tampered.append(1)
            return wire[:-1] + bytes([wire[-1] ^ 0xFF])
        return wire

    net.fault_filter = flip_echo
    rbcs[proposer].propose(PAYLOAD)
    net.run()
    assert tampered  # the filter actually hit ECHO frames
    # node1's tampered ECHOs are MAC-rejected, everyone else suffices
    for rbc in rbcs.values():
        assert rbc.value() == PAYLOAD
    assert all(
        ep.rejected > 0 for nid, ep in net._endpoints.items() if nid != "node1"
    )


def test_rbc_corrupt_shard_fails_branch_check():
    """A corrupted shard with a stale branch must fail Merkle
    verification (docs/RBC-EN.md:35) and never block honest delivery."""
    cfg, net, rbcs, proposer = make_rbc_network(7, seed=9)

    from cleisthenes_tpu_torch.transport.message import (
        decode_message,
        encode_message,
    )

    def corrupt_node1_echo(sender, receiver, wire):
        if sender != "node1":
            return wire
        msg = decode_message(wire)
        p = msg.payload
        if getattr(p, "type", None) == RbcType.ECHO:
            import dataclasses

            bad = p._replace(
                shard=bytes(len(p.shard))  # zeroed shard, same proof
            )
            return encode_message(dataclasses.replace(msg, payload=bad))
        return wire

    net.fault_filter = corrupt_node1_echo
    rbcs[proposer].propose(PAYLOAD)
    net.run()
    for rbc in rbcs.values():
        assert rbc.value() == PAYLOAD


def test_rbc_large_payload_roundtrip():
    payload = hashlib.sha256(b"seed").digest() * 4096  # 128 KiB
    cfg, net, rbcs, proposer = make_rbc_network(4)
    rbcs[proposer].propose(payload)
    net.run()
    for rbc in rbcs.values():
        assert rbc.value() == payload


def test_rbc_unverified_echo_cannot_poison_shard_length():
    """ADVICE.md high finding: a Byzantine member racing one
    junk ECHO (honest root, wrong-length shard, garbage branch) ahead
    of the honest traffic must not poison the expected shard length —
    pre-fix this wedged the victim forever (every honest ECHO and even
    the VAL failed the length precheck)."""
    from cleisthenes_tpu_torch.ops.payload import split_payload
    from cleisthenes_tpu_torch.transport.message import RbcPayload

    cfg, net, rbcs, proposer = make_rbc_network(4)
    crypto = rbcs[proposer].crypto

    # compute the honest root the proposer will use
    data = split_payload(PAYLOAD, cfg.data_shards)
    shards = crypto.erasure.encode(data)
    tree = crypto.merkle.build(shards)
    honest_len = shards.shape[1]
    depth = tree.depth

    junk = RbcPayload(
        type=RbcType.ECHO,
        proposer=proposer,
        epoch=0,
        root_hash=tree.root,
        branch=tuple(bytes(32) for _ in range(depth)),
        shard=b"\x5a" * (honest_len + 7),  # wrong length
        shard_index=0,
    )
    # attacker's ECHO lands at every honest node FIRST
    for victim in rbcs.values():
        victim.handle_message("node1", junk)

    rbcs[proposer].propose(PAYLOAD)
    net.run()
    for node_id, rbc in rbcs.items():
        assert rbc.value() == PAYLOAD, f"{node_id} wedged by poisoned len"
