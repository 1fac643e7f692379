# The reference's tests/test_core.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Core-layer tests, mirroring the reference's white-box unit tests
(queue_internal_test.go:9-146, member_map_internal_test.go:24-74,
member_map_test.go:9-21)."""

import pytest

from cleisthenes_tpu_torch import (
    Address,
    Batch,
    Config,
    EmptyQueueError,
    IndexBoundaryError,
    Member,
    MemberMap,
    TxQueue,
)
from cleisthenes_tpu_torch.core.request import (
    DuplicateRequestError,
    IncomingRequestRepository,
    RequestRepository,
)


class TestTxQueue:
    def test_fifo_order(self):
        q = TxQueue()
        for i in range(5):
            q.push(f"tx{i}")
        assert [q.poll() for _ in range(5)] == [f"tx{i}" for i in range(5)]

    def test_poll_empty_raises(self):
        with pytest.raises(EmptyQueueError):
            TxQueue().poll()

    def test_peek_does_not_remove(self):
        q = TxQueue()
        q.push("a")
        assert q.peek() == "a"
        assert len(q) == 1

    def test_peek_empty_raises(self):
        with pytest.raises(EmptyQueueError):
            TxQueue().peek()

    def test_at(self):
        q = TxQueue()
        for i in range(3):
            q.push(i)
        assert q.at(2) == 2
        assert len(q) == 3

    def test_at_out_of_bounds(self):
        q = TxQueue()
        q.push("x")
        with pytest.raises(IndexBoundaryError):
            q.at(1)
        with pytest.raises(IndexBoundaryError):
            q.at(-1)

    def test_len(self):
        q = TxQueue()
        assert q.len() == 0
        q.push(1)
        assert q.len() == 1


class TestMemberMap:
    def test_add_and_lookup(self):
        mm = MemberMap()
        m = Member("v0", Address("127.0.0.1", 5000))
        mm.add(m)
        assert mm.member("v0") == m
        assert "v0" in mm

    def test_delete(self):
        mm = MemberMap()
        mm.add(Member("v0"))
        mm.delete("v0")
        assert mm.member("v0") is None
        assert len(mm) == 0

    def test_members_sorted(self):
        mm = MemberMap()
        for name in ("v2", "v0", "v1"):
            mm.add(Member(name))
        assert [m.id for m in mm.members()] == ["v0", "v1", "v2"]

    def test_overwrite(self):
        mm = MemberMap()
        mm.add(Member("v0", Address("a", 1)))
        mm.add(Member("v0", Address("b", 2)))
        assert mm.member("v0").addr == Address("b", 2)


class TestConfig:
    def test_defaults(self):
        c = Config(n=4, crypto_backend="cpu")
        assert c.f == 1
        assert c.data_shards == 2
        assert c.parity_shards == 2
        assert c.decryption_threshold == 2

    def test_n128(self):
        c = Config(n=128, f=42, batch_size=10_000, crypto_backend="cpu")
        assert c.data_shards == 44
        assert c.parity_shards == 84

    def test_invalid_f(self):
        with pytest.raises(ValueError):
            Config(n=4, f=2, crypto_backend="cpu")

    def test_invalid_backend(self):
        with pytest.raises(ValueError):
            Config(n=4, crypto_backend="gpu", device="cpu")


class TestBatch:
    def test_tx_list_deterministic_order(self):
        b = Batch({"v1": ["b", "c"], "v0": ["a"]})
        assert b.tx_list() == ["a", "b", "c"]
        assert len(b) == 3


class TestRequestRepository:
    def test_first_write_wins(self):
        r = RequestRepository()
        r.save("c1", "req1")
        with pytest.raises(DuplicateRequestError):
            r.save("c1", "req2")
        assert r.find("c1") == "req1"
        assert len(r) == 1

    def test_find_all(self):
        r = RequestRepository()
        r.save("c1", 1)
        r.save("c2", 2)
        assert sorted(r.find_all()) == [("c1", 1), ("c2", 2)]


class TestIncomingRequestRepository:
    def test_epoch_buffer_replay(self):
        """Future-epoch messages are parked and replayed
        (reference bba/request.go:28-32)."""
        r = IncomingRequestRepository()
        r.save(epoch=2, conn_id="c1", req="late1", current_epoch=1)
        r.save(epoch=2, conn_id="c1", req="late2", current_epoch=1)
        r.save(epoch=3, conn_id="c2", req="later", current_epoch=1)
        assert r.find_all(2) == [("c1", "late1"), ("c1", "late2")]
        drained = r.pop_epoch(2)
        assert drained == [("c1", "late1"), ("c1", "late2")]
        assert r.find_all(2) == []
        assert r.find_all(3) == [("c2", "later")]
