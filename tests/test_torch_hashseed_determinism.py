# The reference's tests/test_hashseed_determinism.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Cross-PYTHONHASHSEED ledger determinism (the DET002 invariant,
end to end).

CPython randomizes str/bytes hashing per process unless PYTHONHASHSEED
pins it, so any set-iteration order that leaks into message bodies,
batch contents or ledger bytes shows up as two processes committing
DIFFERENT bytes for the SAME seeded schedule.  The hash seed is fixed
at interpreter start, so the only honest test is subprocesses: run the
identical seeded 4-node cluster under two different PYTHONHASHSEED
values and require byte-identical ledgers (the full CLOG record bodies
of every node, hashed).
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

# Runs a seeded 4-node simulated cluster to quiescence and prints one
# digest over every node's full committed-ledger record bytes — the
# exact bytes a BatchLog would persist and CATCHUP would serve.
_DRIVER = r"""
import hashlib
from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core.ledger import encode_batch_body
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster

# Config.seed seeds batch sampling (proposal_rng); the cluster seed
# seeds the network scheduler — both must be pinned for a replay
cluster = SimulatedCluster(
    config=Config(n=4, batch_size=8, seed=1234, crypto_backend="cpu"),
    seed=1234,
    key_seed=1,
)
for i in range(24):
    cluster.submit(b"tx-%04d" % i)
cluster.run_epochs()
depth = cluster.assert_agreement()
assert depth >= 2, f"want >=2 committed epochs, got {depth}"
h = hashlib.sha256()
for nid in cluster.ids:
    for epoch, batch in enumerate(cluster.nodes[nid].committed_batches):
        h.update(encode_batch_body(epoch, batch))
print("LEDGER_DIGEST=%s depth=%d" % (h.hexdigest(), depth))
"""


def _run_with_hashseed(hashseed: str) -> str:
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = hashseed
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, (
        f"PYTHONHASHSEED={hashseed} run failed:\n"
        f"{proc.stdout}\n{proc.stderr}"
    )
    for line in proc.stdout.splitlines():
        if line.startswith("LEDGER_DIGEST="):
            return line
    raise AssertionError(f"no digest line in output:\n{proc.stdout}")


def test_ledgers_identical_across_hash_seeds():
    a = _run_with_hashseed("1")
    b = _run_with_hashseed("2")
    assert a == b, (
        "seeded 4-node runs under different PYTHONHASHSEED values "
        f"committed different ledger bytes:\n  {a}\n  {b}\n"
        "-> set-iteration order is leaking into wire/ledger bytes "
        "(see staticcheck DET002)"
    )
