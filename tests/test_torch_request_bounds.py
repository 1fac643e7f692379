# The reference's tests/test_request_bounds.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""DoS bounds on the epoch catch-up buffer and config validation."""

import pytest

from cleisthenes_tpu_torch import Config
from cleisthenes_tpu_torch.core.request import IncomingRequestRepository


def test_far_future_epoch_dropped():
    r = IncomingRequestRepository(max_epoch_horizon=4)
    assert r.save(epoch=100, conn_id="byz", req="x", current_epoch=1) is False
    assert r.save(epoch=5, conn_id="byz", req="x", current_epoch=1) is True
    assert r.dropped == 1


def test_per_sender_cap():
    r = IncomingRequestRepository(max_per_sender=3)
    for i in range(5):
        r.save(epoch=2, conn_id="byz", req=i, current_epoch=1)
    assert len(r.find_all(2)) == 3
    assert r.dropped == 2


def test_config_rejects_nonpositive_n_and_negative_f():
    with pytest.raises(ValueError):
        Config(n=0, crypto_backend="cpu")
    with pytest.raises(ValueError):
        Config(n=4, f=-1, crypto_backend="cpu")


def test_past_and_current_epoch_dropped():
    r = IncomingRequestRepository()
    assert r.save(epoch=1, conn_id="c", req="x", current_epoch=1) is False
    assert r.save(epoch=0, conn_id="c", req="x", current_epoch=1) is False
    assert r.dropped == 2


def test_pop_epoch_gcs_stale():
    r = IncomingRequestRepository()
    r.save(epoch=2, conn_id="c", req="a", current_epoch=1)
    r.save(epoch=3, conn_id="c", req="b", current_epoch=1)
    r.pop_epoch(3)  # skipped past epoch 2
    assert r.find_all(2) == []
