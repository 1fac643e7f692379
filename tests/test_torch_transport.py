# The reference's tests/test_transport.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Transport layer tests: wire codec, authentication, channel network.

Models the reference's conn/comm tests (conn_test.go:32-202,
comm_test.go:27-96, SURVEY.md §4): full send -> wire -> verify ->
dispatch round trips over the in-proc transport, plus the adversarial
cases the reference's TODO ``verify`` (conn.go:134-137) could not test.
"""

import pytest

from cleisthenes_tpu_torch.transport import (
    BbaPayload,
    BbaType,
    ChannelNetwork,
    CoinPayload,
    ConnectionPool,
    DecSharePayload,
    HmacAuthenticator,
    Message,
    RbcPayload,
    RbcType,
    decode_message,
    encode_message,
)


def _payloads():
    return [
        RbcPayload(
            type=RbcType.VAL,
            proposer="node-2",
            epoch=7,
            root_hash=b"\x01" * 32,
            branch=(b"\x02" * 32, b"\x03" * 32),
            shard=bytes(range(200)),
            shard_index=3,
        ),
        RbcPayload(type=RbcType.READY, proposer="n0", epoch=0, root_hash=b"r" * 32),
        BbaPayload(type=BbaType.BVAL, proposer="n1", epoch=2, round=5, value=True),
        BbaPayload(type=BbaType.AUX, proposer="n1", epoch=2, round=0, value=False),
        CoinPayload(
            proposer="n3", epoch=1, round=2, index=4, d=2**255 - 19, e=12345, z=0
        ),
        DecSharePayload(proposer="n0", epoch=9, index=1, d=1, e=2**200, z=7),
    ]


class TestCodec:
    @pytest.mark.parametrize("payload", _payloads(), ids=lambda p: type(p).__name__)
    def test_round_trip(self, payload):
        msg = Message(
            sender_id="node-9", timestamp=123.5, payload=payload, signature=b"sig"
        )
        out = decode_message(encode_message(msg))
        assert out == msg

    def test_bad_magic_rejected(self):
        with pytest.raises(ValueError):
            decode_message(b"XXXX\x01\x03" + b"\x00" * 32)

    def test_truncated_rejected(self):
        wire = encode_message(
            Message("a", 0.0, RbcPayload(RbcType.READY, "p", 0, b"h"))
        )
        with pytest.raises(ValueError):
            decode_message(wire[:-3])

    def test_trailing_bytes_rejected(self):
        wire = encode_message(
            Message("a", 0.0, RbcPayload(RbcType.READY, "p", 0, b"h"))
        )
        with pytest.raises(ValueError):
            decode_message(wire + b"x")

    def test_oversized_length_field_rejected(self):
        """A Byzantine length prefix must not drive allocation."""
        wire = bytearray(
            encode_message(Message("a", 0.0, RbcPayload(RbcType.READY, "p", 0, b"h")))
        )
        wire[6:10] = (2**31).to_bytes(4, "big")  # sender_id length field
        with pytest.raises(ValueError):
            decode_message(bytes(wire))


_ROSTER = ["n0", "n1", "n2", "nX"]


def _auth(self_id, master=b"master", roster=_ROSTER):
    return HmacAuthenticator.derive(master, self_id, roster)


class TestAuthenticator:
    def test_cached_schedule_matches_hmac_new(self):
        """The precomputed inner/outer key schedule must be
        byte-identical to stdlib HMAC-SHA256 — for short keys, the
        64-byte block boundary, and over-long keys (hashed first)."""
        import hashlib
        import hmac as hmac_mod

        from cleisthenes_tpu_torch.transport.base import _hmac_sha256_fn

        for key in (b"k", b"x" * 32, b"y" * 64, b"z" * 200):
            fn = _hmac_sha256_fn(key)
            for msg in (b"", b"m", b"payload" * 100):
                assert fn(msg) == hmac_mod.new(
                    key, msg, hashlib.sha256
                ).digest()

    def test_sign_verify(self):
        n0, n1 = _auth("n0"), _auth("n1")
        msg = n0.sign(
            Message("n0", 1.0, RbcPayload(RbcType.READY, "p", 0, b"h")), "n1"
        )
        assert msg.signature != b""
        assert n1.verify(msg)

    def test_tamper_detected(self):
        n0, n1 = _auth("n0"), _auth("n1")
        msg = n0.sign(
            Message("n0", 1.0, RbcPayload(RbcType.READY, "p", 0, b"h")), "n1"
        )
        forged = Message("n0", 1.0, RbcPayload(RbcType.READY, "p", 1, b"h"), msg.signature)
        assert not n1.verify(forged)

    def test_third_member_cannot_forge_between_pair(self):
        """The ADVICE.md finding: with per-SENDER keys any
        roster member could compute every other member's key.  With
        per-PAIR keys, Byzantine nX (holding all of ITS pair keys)
        still cannot MAC a message n1->n0, because k_{n0,n1} is not
        among them."""
        import hmac as hmac_mod
        import hashlib

        from cleisthenes_tpu_torch.transport.message import signing_bytes

        nX, n0 = _auth("nX"), _auth("n0")
        msg = Message("n1", 1.0, RbcPayload(RbcType.READY, "p", 0, b"h"))
        # nX tries every key it holds
        for key in nX._peer_keys.values():
            forged = Message(
                msg.sender_id,
                msg.timestamp,
                msg.payload,
                hmac_mod.new(key, signing_bytes(msg), hashlib.sha256).digest(),
            )
            assert not n0.verify(forged)

    def test_wrong_pair_key_rejected(self):
        """A frame n0 signed for n1 must not verify at n2 (receiver
        binding)."""
        n0, n2 = _auth("n0"), _auth("n2")
        msg = n0.sign(
            Message("n0", 1.0, RbcPayload(RbcType.READY, "p", 0, b"h")), "n1"
        )
        assert not n2.verify(msg)

    def test_unknown_sender_rejected(self):
        n0 = _auth("n0")
        stranger = Message(
            "not-in-roster", 1.0, RbcPayload(RbcType.READY, "p", 0, b"h")
        )
        assert not n0.verify(stranger)

    def test_sign_refuses_wrong_sender(self):
        """sign() raises rather than emit a message every receiver
        would silently reject."""
        auth = _auth("n0")
        with pytest.raises(ValueError):
            auth.sign(
                Message("n1", 1.0, RbcPayload(RbcType.READY, "p", 0, b"h")),
                "n2",
            )

    def test_sign_requires_receiver(self):
        auth = _auth("n0")
        with pytest.raises(ValueError):
            auth.sign(Message("n0", 1.0, RbcPayload(RbcType.READY, "p", 0, b"h")))

    def test_payload_trailing_bytes_rejected(self):
        """Non-canonical payload bodies (trailing junk inside the
        length-prefixed body) must not decode — frame malleability."""
        from cleisthenes_tpu_torch.transport.message import (
            _KIND_BBA,
            _decode_payload,
            _encode_payload,
        )

        kind, body = _encode_payload(
            BbaPayload(BbaType.BVAL, "p", 0, 0, True)
        )
        assert kind == _KIND_BBA
        _decode_payload(kind, body)  # canonical: fine
        with pytest.raises(ValueError):
            _decode_payload(kind, body + b"\x00")


class _Collector:
    def __init__(self):
        self.got = []

    def serve_request(self, msg):
        self.got.append(msg)


def _mk_net(n=3, seed=None, master=b"k"):
    net = ChannelNetwork(seed=seed)
    collectors = {}
    roster = [f"n{i}" for i in range(n)]
    for nid in roster:
        collectors[nid] = _Collector()
        net.join(
            nid, collectors[nid], HmacAuthenticator.derive(master, nid, roster)
        )
    return net, collectors


def _msg(sender, epoch=0):
    return Message(sender, 0.0, RbcPayload(RbcType.READY, "p", epoch, b"h" * 32))


class TestChannelNetwork:
    def test_point_to_point_delivery(self):
        net, col = _mk_net()
        conn = net.connect("n0", "n1")
        conn.send(_msg("n0"))
        assert net.run() == 1
        assert len(col["n1"].got) == 1
        assert col["n1"].got[0].sender_id == "n0"

    def test_pool_broadcast(self):
        """Reference conn_test.go:138-202 (broadcast to the pool)."""
        net, col = _mk_net(4)
        pool = ConnectionPool()
        for peer in ("n1", "n2", "n3"):
            pool.add(net.connect("n0", peer))
        pool.broadcast(_msg("n0"))
        assert net.run() == 3
        for peer in ("n1", "n2", "n3"):
            assert len(col[peer].got) == 1
        assert len(col["n0"].got) == 0

    def test_tampered_wire_rejected(self):
        net, col = _mk_net()

        def flip(sender, receiver, wire):
            w = bytearray(wire)
            w[-1] ^= 0xFF  # corrupt MAC byte
            return bytes(w)

        net.fault_filter = flip
        net.connect("n0", "n1").send(_msg("n0"))
        net.run()
        assert col["n1"].got == []
        # rejection is visible for observability
        assert net._endpoints["n1"].rejected == 1

    def test_crash_drops_traffic(self):
        net, col = _mk_net()
        net.crash("n1")
        net.connect("n0", "n1").send(_msg("n0"))
        net.connect("n0", "n2").send(_msg("n0"))
        net.run()
        assert col["n1"].got == []
        assert len(col["n2"].got) == 1

    @pytest.mark.faults
    def test_crash_purges_inflight_and_restart_gets_fresh_inbox(self):
        """Fail-stop semantics: frames in flight to/from the node die
        with it, so a restart() cannot see pre-crash ghosts — it
        rejoins with a NEW handler and an empty inbox."""
        net, col = _mk_net(3)
        net.connect("n0", "n1").send(_msg("n0", epoch=1))
        net.connect("n1", "n2").send(_msg("n1", epoch=2))
        net.crash("n1")  # both in-flight frames involve n1: purged
        assert net.pending_count() == 0
        net.run()
        assert col["n1"].got == [] and col["n2"].got == []
        fresh = _Collector()
        net.restart("n1", fresh)
        net.connect("n0", "n1").send(_msg("n0", epoch=3))
        net.connect("n1", "n2").send(_msg("n1", epoch=4))
        net.run()
        # the restarted handler (not the old one) receives new traffic
        assert [m.payload.epoch for m in fresh.got] == [3]
        assert col["n1"].got == []
        assert [m.payload.epoch for m in col["n2"].got] == [4]

    def test_partition_and_heal(self):
        net, col = _mk_net()
        net.partition("n0", "n1")
        net.connect("n0", "n1").send(_msg("n0"))
        net.run()
        assert col["n1"].got == []
        net.heal("n0", "n1")
        net.connect("n0", "n1").send(_msg("n0"))
        net.run()
        assert len(col["n1"].got) == 1

    def test_seeded_scheduler_is_replayable(self):
        """Same seed -> identical adversarial interleaving (SURVEY §5.2)."""

        def run_once(seed):
            net, col = _mk_net(3, seed=seed)
            for e in range(20):
                net.connect("n0", "n2").send(_msg("n0", epoch=e))
                net.connect("n1", "n2").send(_msg("n1", epoch=e))
            net.run()
            return [(m.sender_id, m.payload.epoch) for m in col["n2"].got]

        a, b = run_once(42), run_once(42)
        assert a == b
        c = run_once(7)
        assert sorted(a) == sorted(c)
        assert a != c  # different seed, different order (40 msgs: collision ~0)

    def test_handler_cascade_drains(self):
        """Handlers that send more messages keep the scheduler busy
        (the pattern every protocol round uses)."""
        net = ChannelNetwork()

        class Relay:
            def __init__(self, nid, limit=5):
                self.nid = nid
                self.limit = limit
                self.seen = 0

            def serve_request(self, msg):
                self.seen += 1
                if msg.payload.epoch < self.limit:
                    net.connect(self.nid, "n0" if self.nid == "n1" else "n1").send(
                        Message(
                            self.nid,
                            0.0,
                            RbcPayload(
                                RbcType.READY, "p", msg.payload.epoch + 1, b"h"
                            ),
                        )
                    )

        r0, r1 = Relay("n0"), Relay("n1")
        net.join("n0", r0)
        net.join("n1", r1)
        net.connect("n0", "n1").send(_msg("n0", epoch=0))
        delivered = net.run()
        assert delivered == 6  # epochs 0..5 ping-pong
        assert r0.seen + r1.seen == 6


def test_codec_fuzz_never_crashes():
    """Decoder robustness: random and mutated frames must decode or
    raise ValueError — never any other exception (the channel layer
    catches exactly ValueError; anything else would kill a node on a
    Byzantine frame)."""
    import random

    from cleisthenes_tpu_torch.transport.message import (
        BbaBatchPayload,
        BbaPayload,
        BbaType,
        BundlePayload,
        CatchupReqPayload,
        CatchupRespPayload,
        CoinBatchPayload,
        CoinPayload,
        DecShareBatchPayload,
        DecSharePayload,
        EchoBatchPayload,
        Message,
        RbcPayload,
        RbcType,
        ReadyBatchPayload,
        decode_frame,
        encode_message,
    )

    rng = random.Random(1234)
    seeds = [
        Message(
            "node-a",
            1.5,
            BundlePayload(
                items=(
                    RbcPayload(RbcType.ECHO, "p", 1, b"r" * 32,
                               (b"x" * 32,), b"s" * 8, 1),
                    BbaPayload(BbaType.BVAL, "p", 1, 0, True),
                    CoinPayload("p", 1, 0, 1, 7, 8, 9),
                    DecSharePayload("p", 1, 1, 7, 8, 9),
                    CatchupReqPayload(1),
                    CatchupRespPayload(1, b"body"),
                    BbaBatchPayload(BbaType.BVAL, 1, 0, True, ("a", "b")),
                    CoinBatchPayload(1, 0, 2, ("a", "b"), (1, 2), (3, 4),
                                     (5, 6)),
                    DecShareBatchPayload(1, 2, ("a", "b"), (1, 2), (3, 4),
                                         (5, 6)),
                    ReadyBatchPayload(1, ("a", "b"), (b"q" * 32, b"w" * 32)),
                    EchoBatchPayload(
                        1, 3, ("a", "b"), (b"q" * 32, b"w" * 32),
                        ((b"x" * 32,), (b"y" * 32,)), (b"s1", b"s2"),
                    ),
                )
            ),
            b"m" * 32,
        ),
        Message("node-b", 2.0,
                RbcPayload(RbcType.READY, "p", 3, b"q" * 32), b"m" * 32),
    ]
    wires = [encode_message(m) for m in seeds]
    for m, w in zip(seeds, wires):
        assert decode_frame(w)[0] == m  # sanity
    for _ in range(3000):
        w = bytearray(rng.choice(wires))
        for _ in range(rng.randrange(1, 6)):
            op = rng.randrange(3)
            if op == 0 and w:  # mutate
                w[rng.randrange(len(w))] = rng.randrange(256)
            elif op == 1 and len(w) > 2:  # truncate
                del w[rng.randrange(1, len(w)) :]
            else:  # extend
                w += bytes(rng.randrange(256) for _ in range(rng.randrange(1, 9)))
        try:
            decode_frame(bytes(w))
        except ValueError:
            pass  # the one allowed failure mode
    # pure-random frames too
    for _ in range(2000):
        blob = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 120)))
        try:
            decode_frame(blob)
        except ValueError:
            pass


def test_echo_batch_columnarizes_and_roundtrips():
    """A turn's ECHO fan-out (one per instance, all at the sender's
    shard slot) merges into ONE EchoBatchPayload — the last
    O(N^2)-per-epoch class to go columnar — and survives the codec."""
    from cleisthenes_tpu_torch.transport.broadcast import _columnarize
    from cleisthenes_tpu_torch.transport.message import (
        EchoBatchPayload,
        Message,
        RbcPayload,
        RbcType,
        decode_frame,
        encode_message,
    )

    echoes = [
        RbcPayload(
            RbcType.ECHO, f"p{i}", 7, bytes([i]) * 32,
            (bytes([i]) * 32, bytes([64 + i]) * 32), bytes([i]) * 16, 3,
        )
        for i in range(4)
    ]
    items = _columnarize(list(echoes))
    assert len(items) == 1 and isinstance(items[0], EchoBatchPayload)
    batch = items[0]
    assert batch.epoch == 7 and batch.shard_index == 3
    assert batch.proposers == tuple(f"p{i}" for i in range(4))
    wire = encode_message(Message("s", 1.0, batch, b"m" * 32))
    got, _prefix = decode_frame(wire)
    assert got.payload == batch
