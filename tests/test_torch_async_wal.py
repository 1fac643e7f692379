"""State carried across the two packages: the write-ahead log and the
dealer's keys.

- A WAL that either package's ``SimulatedCluster`` writes (``wal_dir=``)
  reads in the other's ``core/ledger.py`` record for record: the same
  framed records, the same replayed batches, ordered records, last
  epochs and checkpoint.
- A port cluster built from the reference's keys (carried through
  ``cleisthenes_tpu_torch/interop.py``) on a copy of the reference's
  WAL resumes at the reference's epoch, and its next epochs commit the
  batches the reference's cluster commits continuing from its own copy.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from cleisthenes_tpu.config import Config as RefConfig
from cleisthenes_tpu.core import ledger as ref_ledger
from cleisthenes_tpu.protocol.cluster import SimulatedCluster as RefCluster
from cleisthenes_tpu_torch import interop
from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core import ledger as port_ledger
from cleisthenes_tpu_torch.protocol import cluster as port_cluster_mod
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster

PACKAGES = {
    "reference": (RefConfig, RefCluster, ref_ledger),
    "port": (Config, SimulatedCluster, port_ledger),
}


def _cluster(package, wal_dir):
    config_cls, cluster_cls, _ledger = PACKAGES[package]
    cfg = config_cls(
        n=4, batch_size=16, crypto_backend="cpu", seed=21,
        ledger_checkpoint_every=2,
    )
    return cluster_cls(config=cfg, key_seed=9, seed=13, wal_dir=str(wal_dir))


def _drive(cluster, tag: bytes, count: int) -> int:
    rng = np.random.default_rng(len(tag) + count)
    for i in range(count):
        cluster.submit(tag + b"-%04d-" % i + rng.bytes(24))
    cluster.run_until_drained()
    return cluster.assert_agreement()


def _log_view(ledger_mod, path):
    """Everything one package reads from one node's log."""
    with open(path, "rb") as fh:
        data = fh.read()
    records = [(magic, body) for _end, magic, body in ledger_mod.BatchLog._scan(data)]
    log = ledger_mod.BatchLog(path)
    try:
        batches = [
            (e, ledger_mod.encode_batch_body(e, b)) for e, b in log.replay()
        ]
        ordered = list(log.replay_ordered())
        ckpt = log.last_checkpoint
        ckpt = None if ckpt is None else (ckpt[0], [sorted(s) for s in ckpt[1]])
        view = (records, batches, ordered, log.last_epoch,
                log.last_ordered_epoch, ckpt)
    finally:
        log.close()
    return view


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_wal_written_by_one_package_reads_in_the_other(writer, tmp_path):
    cluster = _cluster(writer, tmp_path)
    depth = _drive(cluster, b"wal-" + writer.encode(), 64)
    assert depth >= 3
    cluster.stop()
    for nid in cluster.ids:
        path = os.path.join(tmp_path, f"{nid}.log")
        ref_view = _log_view(ref_ledger, path)
        port_view = _log_view(port_ledger, path)
        assert port_view == ref_view
        records, batches = ref_view[0], ref_view[1]
        magics = {magic for magic, _body in records}
        # plaintext batches, ordered ciphertext records and a checkpoint
        assert {b"CLOG", b"COrd", b"CCKP"} <= magics, magics
        assert len(batches) == depth


def test_port_resumes_reference_wal_on_carried_keys(tmp_path, monkeypatch):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    ref = _cluster("reference", ref_dir)
    depth = _drive(ref, b"before", 48)
    ref.stop()
    shutil.copytree(ref_dir, port_dir)
    carried = interop.keys_from_plain(
        {m: dataclasses.asdict(k) for m, k in ref.keys.items()}
    )
    # the port cluster deals no keys of its own: it runs on the carried set
    monkeypatch.setattr(
        port_cluster_mod, "setup_keys", lambda *args, **kwargs: carried
    )
    port = _cluster("port", port_dir)
    ref2 = _cluster("reference", ref_dir)
    for nid in ref.ids:
        a, b = ref2.nodes[nid], port.nodes[nid]
        assert (b.epoch, b.settled_epoch) == (a.epoch, a.settled_epoch)
        assert len(b.committed_batches) == len(a.committed_batches) == depth
    # the next epochs: the same transactions on both
    assert _drive(ref2, b"after", 48) == _drive(port, b"after", 48) > depth
    for nid in ref.ids:
        want = [
            ref_ledger.encode_batch_body(e, bt)
            for e, bt in enumerate(ref2.nodes[nid].committed_batches)
        ]
        got = [
            port_ledger.encode_batch_body(e, bt)
            for e, bt in enumerate(port.nodes[nid].committed_batches)
        ]
        assert got == want
    ref2.stop()
    port.stop()
