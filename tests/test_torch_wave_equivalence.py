# The reference's tests/test_wave_equivalence.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Scalar-flush vs columnar-wave-flush equivalence.

The wave refactor moved batched crypto to the transport's quiescence
points: one columnar flush per message wave instead of one scalar
flush per quorum event.  That reshuffles WHEN verdicts apply and what
each outbound bundle carries — but it must never reshuffle WHAT the
roster commits.  ``Config.hub_wave_flush=False`` keeps the pre-wave
scalar discipline as a live comparison arm; these tests run the same
seeded schedule under both disciplines and require byte-identical
committed ledgers on both transports, plus a cross-PYTHONHASHSEED
subprocess check that the new wave ordering itself (drain order, wave
widths, dispatch counts) is hash-seed independent.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys
import threading

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from cleisthenes_tpu_torch.config import Config  # noqa: E402
from cleisthenes_tpu_torch.core.ledger import encode_batch_body  # noqa: E402
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster  # noqa: E402


def _channel_ledger_digest(wave_flush: bool) -> tuple:
    """(ledger digest, committed depth, hub dispatch count) for one
    seeded 4-node channel-transport run under the given discipline."""
    cluster = SimulatedCluster(
        config=Config(
            n=4, batch_size=8, seed=4321, hub_wave_flush=wave_flush, crypto_backend="cpu"
        ),
        seed=4321,
        key_seed=9,
    )
    for i in range(24):
        cluster.submit(b"wave-tx-%04d" % i)
    cluster.run_epochs()
    depth = cluster.assert_agreement()
    h = hashlib.sha256()
    for nid in cluster.ids:
        for epoch, batch in enumerate(
            cluster.nodes[nid].committed_batches
        ):
            h.update(encode_batch_body(epoch, batch))
    hub = cluster.nodes[cluster.ids[0]].hub
    return h.hexdigest(), depth, hub.stats()["dispatches"]


def test_scalar_vs_wave_identical_ledgers_channel():
    wave = _channel_ledger_digest(wave_flush=True)
    scalar = _channel_ledger_digest(wave_flush=False)
    assert wave[1] >= 2 and scalar[1] >= 2  # both actually committed
    assert wave[0] == scalar[0], (
        "columnar wave flush committed different ledger bytes than "
        f"the scalar discipline:\n  wave:   {wave}\n  scalar: {scalar}"
    )
    # and the refactor's entire point: the wave discipline needs FEWER
    # dispatches for the same schedule, never more
    assert wave[2] <= scalar[2], (wave[2], scalar[2])






# Prints one line digesting the ledger bytes AND the wave structure
# itself: per-run hub wave widths, dispatch count, and column item
# totals.  Two PYTHONHASHSEED values must produce identical lines —
# hash-order iteration anywhere in the drain/dispatch path would show
# up as different wave compositions even when ledgers converge.
_WAVE_DRIVER = r"""
import hashlib
from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core.ledger import encode_batch_body
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster

cluster = SimulatedCluster(
    config=Config(n=4, batch_size=8, seed=2026, hub_wave_flush=True, crypto_backend="cpu"),
    seed=2026,
    key_seed=3,
)
for i in range(24):
    cluster.submit(b"wave-hs-%04d" % i)
cluster.run_epochs()
depth = cluster.assert_agreement()
assert depth >= 2, f"want >=2 committed epochs, got {depth}"
h = hashlib.sha256()
for nid in cluster.ids:
    for epoch, batch in enumerate(cluster.nodes[nid].committed_batches):
        h.update(encode_batch_body(epoch, batch))
hub = cluster.nodes[cluster.ids[0]].hub
st = hub.stats()
print(
    "WAVE_DIGEST=%s widths=%s dispatches=%d items=%d/%d/%d"
    % (
        h.hexdigest(),
        ",".join(str(w) for w in hub.wave_widths),
        st["dispatches"],
        st["branch_items"],
        st["decode_items"],
        st["share_items"],
    )
)
"""


def _run_wave_driver(hashseed: str) -> str:
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = hashseed
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _WAVE_DRIVER],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, (
        f"PYTHONHASHSEED={hashseed} wave run failed:\n"
        f"{proc.stdout}\n{proc.stderr}"
    )
    for line in proc.stdout.splitlines():
        if line.startswith("WAVE_DIGEST="):
            return line
    raise AssertionError(f"no wave digest line:\n{proc.stdout}")


def test_wave_ordering_identical_across_hash_seeds():
    a = _run_wave_driver("1")
    b = _run_wave_driver("2")
    assert a == b, (
        "wave composition diverged across PYTHONHASHSEED values:\n"
        f"  {a}\n  {b}\n-> hash-order iteration is leaking into the "
        "hub's drain/dispatch path (see staticcheck DET002/DET003)"
    )


def _grpc_epoch0_bodies(wave_flush: bool) -> list:
    """Every node's encoded epoch-0 batch body from one 4-node run
    over real localhost gRPC under the given flush discipline."""
    from cleisthenes_tpu_torch.protocol.honeybadger import setup_keys
    from cleisthenes_tpu_torch.transport.host import ValidatorHost

    n = 4
    cfg = Config(crypto_backend="cpu", n=n, batch_size=8, seed=77, hub_wave_flush=wave_flush)
    ids = [f"node{i}" for i in range(n)]
    keys = setup_keys(cfg, ids, seed=55)
    hosts = {i: ValidatorHost(cfg, i, ids, keys[i]) for i in ids}
    try:
        addrs = {i: h.listen() for i, h in hosts.items()}
        threads = [
            threading.Thread(target=h.connect, args=(addrs,))
            for h in hosts.values()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        for i in range(8):
            hosts[ids[i % n]].submit(b"grpc-wave-%02d" % i)
        for h in hosts.values():
            h.propose()
        first = {i: h.wait_commit(timeout=60) for i, h in hosts.items()}
        assert {e for e, _ in first.values()} == {0}
        return [encode_batch_body(0, b) for _, b in first.values()]
    finally:
        for h in hosts.values():
            h.stop()


def test_scalar_vs_wave_identical_ledgers_grpc():
    """Same roster, same submissions, real sockets: the wave and
    scalar disciplines must commit byte-identical epoch-0 batches
    (deterministic proposal sampling + full proposal inclusion on a
    quiet loopback make the committed bytes a pure function of the
    inputs, not of the flush discipline)."""
    wave = _grpc_epoch0_bodies(wave_flush=True)
    scalar = _grpc_epoch0_bodies(wave_flush=False)
    # within-run agreement is byte-exact on both arms...
    assert all(b == wave[0] for b in wave)
    assert all(b == scalar[0] for b in scalar)
    # ...and across the discipline boundary too
    assert wave[0] == scalar[0], (
        "wave vs scalar gRPC runs committed different epoch-0 bytes"
    )
