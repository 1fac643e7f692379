"""The port's asynchronous protocol plane against the reference's.

``SimulatedCluster`` of both packages at N=4 and N=7, with the same
``seed``, ``key_seed``, scheduler seed and transactions, on the default
arms (hub waves, columnar delivery, wave routing, columnar egress) and
on the scalar arms, on two backend pairs:

- the reference's ``'cpu'`` against the port's ``'cpu'``;
- the reference's ``'tpu'`` (JAX on the CPU) against the port's
  ``'cuda'`` on ``device='cpu'`` (the kernels' plain versions), where
  the hub's ``stats()`` and wave widths must match as well.  The port
  has no host floors (ROADMAP.md, "Host floors dropped"), so the
  reference's RS floor is set to 0 for these runs: both then send every
  wave's decode through their fused decode-recheck, one dispatch each.

Every node's committed batches must be byte-identical (their WAL record
bodies).  The wire test captures every frame both N=4 clusters enqueue
(``ChannelNetwork.frame_tap``), with the envelope clock and the CP-proof
nonces pinned, and holds the two streams, each frame's re-encoding and
its signing bytes to each other, for every message kind sent.
"""

import secrets
import time

import numpy as np
import pytest

from cleisthenes_tpu.config import Config as RefConfig
from cleisthenes_tpu.core.ledger import encode_batch_body as ref_body
from cleisthenes_tpu.ops import rs_xla
from cleisthenes_tpu.protocol.cluster import SimulatedCluster as RefCluster
from cleisthenes_tpu.transport import message as ref_message
from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core.ledger import encode_batch_body
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster
from cleisthenes_tpu_torch.transport import message as port_message

SCALAR_ARMS = dict(
    hub_wave_flush=False,
    delivery_columnar=False,
    wave_routing=False,
    egress_columnar=False,
)
ARMS = {"waves": {}, "scalar": SCALAR_ARMS}
# (reference backend, port backend, port device)
PAIRS = {"cpu": ("cpu", "cpu", "cpu"), "cuda": ("tpu", "cuda", "cpu")}


def _run(config_cls, cluster_cls, n, backend, arms, frames=None, **kw):
    cfg = config_cls(
        n=n, batch_size=8 * n, crypto_backend=backend, seed=5, **arms, **kw
    )
    cluster = cluster_cls(config=cfg, key_seed=3, seed=11)
    if frames is not None:
        cluster.net.frame_tap = lambda s, r, w: frames.append((s, r, w))
    rng = np.random.default_rng(1)
    for _ in range(24 * n):
        cluster.submit(rng.integers(0, 256, size=32, dtype=np.uint8).tobytes())
    cluster.run_until_drained()
    depth = cluster.assert_agreement()
    assert depth >= 2, f"want >= 2 committed epochs, got {depth}"
    return cluster


def _ledgers(cluster, body):
    return {
        nid: [body(e, b) for e, b in enumerate(hb.committed_batches)]
        for nid, hb in cluster.nodes.items()
    }


def check_pair(n, arms, pair, monkeypatch):
    """Run both packages' clusters on one backend pair and hold them to
    each other (the ``'cuda'`` pair's cases are in
    tests/test_torch_async_parity_cuda.py)."""
    ref_backend, backend, device = PAIRS[pair]
    if ref_backend == "tpu":
        monkeypatch.setattr(rs_xla.XlaErasureCoder, "HOST_FLOOR_BYTES", 0)
    ref = _run(RefConfig, RefCluster, n, ref_backend, ARMS[arms])
    port = _run(Config, SimulatedCluster, n, backend, ARMS[arms], device=device)
    assert _ledgers(port, encode_batch_body) == _ledgers(ref, ref_body)
    if ref_backend == "tpu":
        assert port._hub.stats() == ref._hub.stats()
        assert port._hub.wave_widths == ref._hub.wave_widths


@pytest.mark.parametrize("arms", sorted(ARMS))
@pytest.mark.parametrize("n", [4, 7])
def test_cluster_ledgers_match_reference_cpu(n, arms, monkeypatch):
    check_pair(n, arms, "cpu", monkeypatch)


def _kinds(payload, into):
    into.add(type(payload).__name__)
    for item in getattr(payload, "items", ()) or ():
        _kinds(item, into)
    inner = getattr(payload, "inner", None)
    if inner is not None:
        _kinds(inner, into)


@pytest.mark.parametrize("arms", sorted(ARMS))
def test_wire_bytes_match_reference(arms, monkeypatch):
    """Frame streams, re-encodings and signing bytes of an N=4 run."""
    monkeypatch.setattr(secrets, "token_bytes", lambda k: b"\x07" * k)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    ref_frames, port_frames = [], []
    _run(RefConfig, RefCluster, 4, "cpu", ARMS[arms], frames=ref_frames)
    _run(Config, SimulatedCluster, 4, "cpu", ARMS[arms], frames=port_frames)
    assert len(port_frames) == len(ref_frames) > 0
    kinds = set()
    for (s, r, wire), ref_frame in zip(port_frames, ref_frames):
        assert (s, r, wire) == ref_frame
        pm = port_message.decode_message(wire)
        rm = ref_message.decode_message(wire)
        assert port_message.encode_message(pm) == wire
        assert ref_message.encode_message(rm) == wire
        assert port_message.signing_bytes(pm) == ref_message.signing_bytes(rm)
        port_kinds, ref_kinds = set(), set()
        _kinds(pm.payload, port_kinds)
        _kinds(rm.payload, ref_kinds)
        assert port_kinds == ref_kinds
        kinds |= port_kinds
    # what an epoch sends on each arm: RBC and BBA traffic, coin and
    # decryption shares
    want = {"BundlePayload", "RbcPayload", "DecShareBatchPayload"}
    if arms == "scalar":
        want |= {"BbaPayload", "CoinPayload"}
    else:
        want |= {"BbaBatchPayload", "CoinBatchPayload"}
    assert want <= kinds, kinds


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_per_geometry_sibling_runs_on_the_hubs_device(backend):
    """A decode group of another roster's (n, k) (after a reconfiguration)
    runs on a sibling ``BatchCrypto`` of the hub's backend and device; on
    ``'cuda'`` with ``device='cpu'`` that is the kernels' plain versions,
    never the default card."""
    from cleisthenes_tpu_torch.ops.backend import get_backend
    from cleisthenes_tpu_torch.ops.merkle import CpuMerkle
    from cleisthenes_tpu_torch.ops.rs_cpu import CpuErasureCoder
    from cleisthenes_tpu_torch.protocol.hub import CryptoHub

    hub = CryptoHub(get_backend(Config(n=7, crypto_backend=backend, device="cpu")))
    assert hub._crypto_for(7, 3) is hub.crypto
    sib = hub._crypto_for(4, 2)
    assert hub._crypto_for(4, 2) is sib  # cached
    assert (sib.backend, sib.n, sib.f, sib.k) == (backend, 4, 1, 2)
    assert sib.device == hub.crypto.device
    if backend == "cuda":
        assert str(sib.erasure.device) == "cpu"
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (3, 2, 40), dtype=np.uint8)
    host = CpuErasureCoder(4, 2)
    full = np.stack([host.encode(d) for d in data])
    idx = np.array([[1, 3]] * 3)
    got, roots, _dispatches = sib.decode_recheck_batch(idx, full[:, [1, 3]])
    assert np.array_equal(got, data)
    want = [CpuMerkle().build(f).root for f in full]
    assert [r.tobytes() for r in roots] == want
