"""The port's ``SimulatedCluster`` on its ``'cuda'`` backend (the kernels'
plain versions, ``device='cpu'``) against the reference's on ``'tpu'``
(JAX on the CPU) at N=4 and N=7, on the default and the scalar arms:
byte-identical ledgers on every node, and the hub's ``stats()`` and
wave widths equal (tests/test_torch_async_parity.py, ``check_pair``)."""

import pytest

from tests.test_torch_async_parity import ARMS, check_pair


@pytest.mark.parametrize("arms", sorted(ARMS))
@pytest.mark.parametrize("n", [4, 7])
def test_cluster_ledgers_and_hub_stats_match_reference_cuda(n, arms, monkeypatch):
    check_pair(n, arms, "cuda", monkeypatch)
