"""One epoch of the asynchronous plane at BASELINE config 3's roster
(N=64, f=21: threshold-22 coin and TPKE, 43-ECHO quorums, depth-6
branches) on the code of the card's path: ``crypto_backend='cuda'`` on
``device='cpu'``, the kernels' plain versions, with the batch of the
reference's ``test_full_epoch_n64_agreement_and_validity``
(tests/test_honeybadger.py).  ``chip_smoke.py``'s ``async_phase`` runs
the same cluster on the card at 10,000-tx batches."""

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster


def test_n64_epoch_on_the_cuda_path_agrees_and_commits_every_tx():
    n = 64
    cluster = SimulatedCluster(
        config=Config(
            n=n, batch_size=64, crypto_backend="cuda", device="cpu", seed=5
        ),
        key_seed=41,
    )
    cfg = cluster.config
    assert cfg.f == 21 and cfg.data_shards == 22
    txs = [b"n64-%04d" % i for i in range(64)]
    for tx in txs:
        cluster.submit(tx)
    for hb in cluster.nodes.values():
        hb.start_epoch()
    cluster.net.run()
    depth = cluster.assert_agreement()
    assert depth >= 1
    committed = [
        tx for b in cluster.committed(cluster.ids[0]) for tx in b.tx_list()
    ]
    assert sorted(committed) == sorted(txs)  # every tx, exactly once
    assert cluster.pending() == 0
    st = cluster._hub.stats()
    # every node checks every instance's N branches once (the shared
    # hub), and decodes every instance once
    assert st["branch_items"] == n ** 3
    assert st["decode_items"] == n ** 2
