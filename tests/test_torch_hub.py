# The reference's tests/test_hub.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""CryptoHub: cross-instance batching of the live protocol hot path.

VERDICT.md item 3: the live path must use the batched kernels.
These tests prove (a) batched verification agrees with single-shot
verification, (b) a full epoch's crypto goes through the hub in FEW
batched dispatches instead of per-message singletons, and (c) invalid
work is rejected identically through the batched path.
"""

import numpy as np
import pytest

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.ops import tpke
from cleisthenes_tpu_torch.ops.backend import BatchCrypto
from cleisthenes_tpu_torch.ops.coin import CommonCoin
from cleisthenes_tpu_torch.protocol.hub import CryptoHub, HubWave, _Memo


class TestVerifyShareGroups:
    """The multi-group dual-pow fold (one dispatch for TPKE + coins)."""

    @pytest.mark.parametrize("backend", ["cpu", "cuda"])
    def test_groups_agree_with_single_calls(self, backend):
        pub_a, shares_a = tpke.deal(4, 2, seed=21)
        pub_b, shares_b = tpke.deal(7, 3, seed=22)
        svc_a = tpke.Tpke(pub_a, backend="cpu")
        ct = svc_a.encrypt(b"group-a")
        dss = [svc_a.dec_share(s, ct) for s in shares_a]
        coin = CommonCoin(pub_b, backend="cpu")
        cid = b"epoch|0"
        css = [coin.share(s, cid) for s in shares_b]
        # corrupt one share in each group
        dss[1] = tpke.DhShare(dss[1].index, dss[1].d, dss[1].e, dss[1].z + 1)
        css[4] = tpke.DhShare(css[4].index, css[4].d + 1, css[4].e, css[4].z)

        ga = (pub_a, ct.c1, dss, svc_a.context(ct))
        pub_c, base_c, ctx_c = coin.group_params(cid)
        gb = (pub_c, base_c, css, ctx_c)
        combined = tpke.verify_share_groups(
            [(ga[0], ga[1], ga[2], ga[3]), (gb[0], gb[1], gb[2], gb[3])],
            backend=backend, device="cpu",
        )
        singles = [
            tpke.verify_shares(ga[0], ga[1], ga[2], ga[3], backend="cpu", device="cpu"),
            tpke.verify_shares(gb[0], gb[1], gb[2], gb[3], backend="cpu", device="cpu"),
        ]
        assert combined == singles
        assert combined[0] == [True, False, True, True]
        assert combined[1][4] is False and sum(combined[1]) == 6


class TestSharePool:
    def test_deferred_verdicts_flow(self):
        pub, shares = tpke.deal(4, 2, seed=23)
        svc = tpke.Tpke(pub, backend="cpu")
        ct = svc.encrypt(b"pool")
        pool = tpke.SharePool(2)
        for i, s in enumerate(shares[:3]):
            assert pool.add(f"n{i}", svc.dec_share(s, ct))
        assert len(pool) == 3
        assert pool.ready() is None  # nothing verified yet
        senders, shs = pool.collect_pending()
        ok = svc.verify_dec_shares(ct, shs)
        pool.apply_verdicts(senders, ok)
        valid = pool.ready()
        assert valid is not None and len({v.index for v in valid}) >= 2
        # burned sender cannot resubmit after a bad verdict
        pool2 = tpke.SharePool(2)
        bad = tpke.DhShare(1, 2, 3, 4)
        pool2.add("evil", bad)
        s2, sh2 = pool2.collect_pending()
        pool2.apply_verdicts(s2, [False])
        assert not pool2.add("evil", svc.dec_share(shares[0], ct))

    def test_try_verified_compat(self):
        pub, shares = tpke.deal(4, 2, seed=24)
        svc = tpke.Tpke(pub, backend="cpu")
        ct = svc.encrypt(b"compat")
        pool = tpke.SharePool(2)
        pool.add("a", svc.dec_share(shares[0], ct))
        assert pool.try_verified(lambda s: svc.verify_dec_shares(ct, s)) is None
        pool.add("b", svc.dec_share(shares[1], ct))
        valid = pool.try_verified(lambda s: svc.verify_dec_shares(ct, s))
        assert valid is not None and len(valid) == 2


class TestHubBatching:
    def test_branch_groups_agree_with_singles(self):
        crypto = BatchCrypto("cpu", 8, 2, 4, device="cpu")
        hub = CryptoHub(crypto)
        rng = np.random.default_rng(31)
        shards = rng.integers(0, 256, size=(3, 8, 64), dtype=np.uint8)
        trees = crypto.merkle.build_batch(shards)
        results = {}

        class Sink:  # bulk-verdict client (the hub's branch contract)
            def on_branch_verdicts(self, ctxs, oks):
                for key, ok in zip(ctxs, oks):
                    results[key] = ok

        sink = Sink()
        wave = HubWave(hub.dedup)
        for t_i, t in enumerate(trees):
            for j in range(8):
                leaf = shards[t_i, j].tobytes()
                if t_i == 1 and j == 3:
                    leaf = b"\xff" + leaf[1:]  # corrupt
                wave.add_branch(
                    sink, t.root, leaf, tuple(t.branch(j)), j, (t_i, j)
                )
        hub._run_branches(*wave.take_branches())
        for t_i, t in enumerate(trees):
            for j in range(8):
                single = crypto.merkle.verify_branch(
                    t.root,
                    shards[t_i, j].tobytes()
                    if (t_i, j) != (1, 3)
                    else b"\xff" + shards[t_i, j].tobytes()[1:],
                    t.branch(j),
                    j,
                )
                assert results[(t_i, j)] == single
        assert results[(1, 3)] is False
        assert sum(results.values()) == 23

    def test_epoch_crypto_goes_through_hub_in_few_dispatches(self):
        """A full N=8 HBBFT epoch: every branch verify, decode and
        share verify rides the hub; total batched dispatches stay far
        below the per-message count (~N^2 branch + ~2N share singles)."""
        from tests.test_torch_honeybadger import (
            assert_identical_batches,
            make_hb_network,
            push_txs,
        )

        cfg, net, nodes = make_hb_network(8, batch_size=16)
        push_txs(nodes, 16)
        for hb in nodes.values():
            hb.start_epoch()
        net.run()
        assert_identical_batches(nodes)
        for hb in nodes.values():
            st = hb.hub.stats()
            # the work actually went through the hub...
            # >= n-f echoes/instance: at least one instance's quorum
            assert st["branch_items"] >= 8 * (8 - 2)
            assert st["share_items"] >= 8  # coins + dec shares
            assert st["decode_items"] >= 1
            # ...in batched dispatches, not one per item
            assert st["dispatches"] < st["branch_items"] + st["share_items"]
            assert st["dispatches"] <= 120, st
            # every flush that executed work logged its column width,
            # and the widths account for every item the hub ran
            assert hb.hub.wave_widths
            assert sum(hb.hub.wave_widths) == (
                st["branch_items"] + st["decode_items"] + st["share_items"]
            )


class TestMemoFifo:
    def test_fifo_evicts_oldest_insertion_only(self):
        m = _Memo(4)
        for i in range(4):
            m.put(i, i)
        m.put(4, 4)  # at cap: evicts key 0, keeps everything newer
        assert 0 not in m.map
        assert list(m.map) == [1, 2, 3, 4]
        m.put(2, 22)  # existing key: value refresh, no eviction
        assert m.map[2] == 22 and len(m.map) == 4
        m.put(5, 5)  # next eviction is the NEXT-oldest (1), not all
        assert list(m.map) == [2, 3, 4, 5]


class TestHubWaveIdDedup:
    def test_receiver_copies_collapse_to_one_slot(self):
        """In dedup mode, N clients offering the same decoded-payload
        objects (root/leaf/branch shared via the transport's payload
        memo) produce ONE unique slot; distinct content stays
        distinct even at equal values (identity, not equality)."""
        root, leaf, br = b"r" * 32, b"leaf", (b"s" * 32,)
        wave = HubWave(dedup=True)
        for client in ("a", "b", "c"):
            wave.add_branch(client, root, leaf, br, 1, ctx=client)
        # equal VALUES under different identities must not collapse
        # (bytes(bytearray(..)) forces fresh objects — same-code-object
        # literals would be constant-folded to the very same constant)
        wave.add_branch(
            "d",
            bytes(bytearray(root)),
            bytes(bytearray(leaf)),
            (bytes(bytearray(br[0])),),
            1,
            "d",
        )
        assert len(wave.b_slots) == 2
        assert len(wave.b_items) == 4
        assert [it[2] for it in wave.b_items] == [0, 0, 0, 1]
        # non-dedup mode: every item is its own slot
        wave2 = HubWave(dedup=False)
        wave2.add_branch("a", root, leaf, br, 1, "a")
        wave2.add_branch("b", root, leaf, br, 1, "b")
        assert len(wave2.b_slots) == 2


class TestHubLiveness:
    def test_poisoned_share_burn_and_recovery(self):
        """A Byzantine dec-share burns through the batched path and the
        epoch still commits (pool recovers with honest shares)."""
        from tests.test_torch_honeybadger import (
            assert_identical_batches,
            make_hb_network,
            push_txs,
        )
        from cleisthenes_tpu_torch.transport.message import DecSharePayload

        cfg, net, nodes = make_hb_network(4, batch_size=8, seed=3)
        bad = "node2"
        orig_post = net.post

        def tamper(sender_id, receiver_id, msg):
            p = msg.payload
            if sender_id == bad and isinstance(p, DecSharePayload):
                from cleisthenes_tpu_torch.transport.message import Message

                msg = Message(
                    msg.sender_id,
                    msg.timestamp,
                    DecSharePayload(
                        proposer=p.proposer,
                        epoch=p.epoch,
                        index=p.index,
                        d=p.d,
                        e=p.e,
                        z=(p.z + 1),
                    ),
                    msg.signature,
                )
            return orig_post(sender_id, receiver_id, msg)

        net.post = tamper
        push_txs(nodes, 8)
        for hb in nodes.values():
            hb.start_epoch()
        net.run()
        assert_identical_batches(nodes)
