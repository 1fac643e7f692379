"""Local-cluster demo: ``python -m cleisthenes_tpu_torch.demo``.

Boots N HBBFT validators over localhost gRPC (the reference is a
library with no runnable main; this is the 5-minute proof the
framework works end to end), feeds transactions, and prints each
committed epoch plus the node-0 metrics snapshot.

    python -m cleisthenes_tpu_torch.demo --n 4 --txs 64 --batch-size 16 \
        [--crypto cuda|cpu|cpp] [--device cuda|cpu] [--log-dir DIR]

The crypto runs on the card by default (``Config``'s
``crypto_backend='cuda'`` on ``device='cuda'``), and the demo raises on
a machine without one; ``--crypto cpu`` runs it on the host.  Under
``'cuda'`` every kernel library is built and loaded before the first
gRPC server starts, so no compiler process is forked beside live gRPC
threads and no validator thread builds.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import queue
import threading
import time

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.protocol.honeybadger import setup_keys
from cleisthenes_tpu_torch.transport.host import ValidatorHost
from cleisthenes_tpu_torch.utils.log import configure as configure_logging


def prepare_crypto(cfg: Config) -> None:
    """Build and load, before any server thread exists, what the
    roster's crypto will load on first use: the host's native
    libraries (g++) and, under ``'cuda'`` on a card, every CUDA kernel
    library (nvcc).  Raises under ``'cuda'`` on a CUDA device when no
    card is present: nothing falls back to the host."""
    from cleisthenes_tpu_torch.native import build as native_build

    native_build.load_modpow()
    native_build.load_sha256()
    if cfg.crypto_backend == "cpp":
        native_build.load_gf256()
    if cfg.crypto_backend == "cuda" and cfg.device != "cpu":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                f"crypto_backend='cuda' on device={cfg.device!r} needs a "
                "GPU; pass --crypto cpu to run on the host"
            )
        from cleisthenes_tpu_torch.csrc import build

        build.load_all()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=4, help="validator count")
    ap.add_argument("--txs", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument(
        "--crypto",
        default=Config.crypto_backend,
        choices=["cuda", "cpu", "cpp"],
    )
    ap.add_argument(
        "--device",
        default=Config.device,
        help="torch device of the 'cuda' crypto backend ('cuda[:N]', "
        "or 'cpu' for the kernels' plain PyTorch versions)",
    )
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument(
        "--log-dir",
        default=None,
        help="directory for durable committed-batch logs (restart demo)",
    )
    ap.add_argument(
        "--verbose", action="store_true", help="debug-level node logs"
    )
    ap.add_argument(
        "--mode",
        default="grpc",
        choices=["grpc", "lockstep"],
        help="grpc: N real validator processes-in-threads over "
        "localhost sockets; lockstep: the batched SPMD executor "
        "(protocol.spmd) — the mode for big-N capacity runs",
    )
    ap.add_argument(
        "--dkg",
        action="store_true",
        help="generate threshold keys by distributed key generation "
        "(ops.dkg) instead of the trusted dealer",
    )
    ap.add_argument(
        "--trace",
        metavar="OUT_JSON",
        default=None,
        help="run under the flight recorder (utils/trace.py) and "
        "write the merged Chrome-trace artifact here on exit — open "
        "it at ui.perfetto.dev (grpc mode only; see docs/TRACING.md)",
    )
    ap.add_argument(
        "--obs-port",
        type=int,
        default=None,
        metavar="BASE",
        help="serve live telemetry (/metrics /healthz /vars, "
        "transport/obs_http.py) on 127.0.0.1: node i listens on "
        "BASE+i; 0 picks ephemeral ports (printed at boot; grpc "
        "mode only — see docs/OBSERVABILITY.md)",
    )
    ap.add_argument(
        "--ingress-port",
        type=int,
        default=None,
        metavar="BASE",
        help="serve the client submit/subscribe API "
        "(transport/ingress.py) on 127.0.0.1: node i listens on "
        "BASE+i; 0 picks ephemeral ports (printed at boot).  The "
        "demo then submits its transactions as a real gRPC client "
        "through the fee-priority mempool instead of in-process "
        "(grpc mode only — see docs/ARCHITECTURE.md 'Ingress plane')",
    )
    args = ap.parse_args(argv)
    if args.obs_port is not None and (
        args.obs_port < 0 or args.obs_port + args.n - 1 > 65535
    ):
        ap.error(
            f"--obs-port {args.obs_port}: need 0 (ephemeral) or a base "
            f"with BASE+{args.n - 1} <= 65535 (one port per node)"
        )
    if args.ingress_port is not None and (
        args.ingress_port < 0 or args.ingress_port + args.n - 1 > 65535
    ):
        ap.error(
            f"--ingress-port {args.ingress_port}: need 0 (ephemeral) "
            f"or a base with BASE+{args.n - 1} <= 65535 (one per node)"
        )
    configure_logging(logging.DEBUG if args.verbose else logging.INFO)

    cfg = Config(
        n=args.n,
        batch_size=args.batch_size,
        crypto_backend=args.crypto,
        device=args.device,
        # tracing instruments the message-passing path only: lockstep
        # mode must not pay for recorders nobody ever reads
        trace=args.trace is not None and args.mode == "grpc",
    )
    ids = [f"node{i}" for i in range(args.n)]
    print(
        f"== cleisthenes-tpu demo: n={args.n} f={cfg.f} "
        f"batch={args.batch_size} crypto={args.crypto} "
        f"device={args.device} mode={args.mode}"
        + (" keys=dkg" if args.dkg else " keys=dealer")
    )
    if args.mode == "lockstep":
        if args.trace:
            print(
                "== note: --trace instruments the message-passing "
                "path; lockstep mode has no per-node timelines "
                "(flag ignored)"
            )
        if args.obs_port is not None:
            print(
                "== note: --obs-port serves per-validator telemetry; "
                "lockstep mode has no per-node metrics (flag ignored)"
            )
        if args.ingress_port is not None:
            print(
                "== note: --ingress-port serves the per-validator "
                "client API; lockstep mode has no per-node transport "
                "(flag ignored)"
            )
        prepare_crypto(cfg)
        return _lockstep_main(args, cfg)
    prepare_crypto(cfg)
    keys = setup_keys(cfg, ids)
    if args.dkg:
        keys = _dkg_rekey(cfg, ids, keys)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    def node_cfg(rank: int) -> Config:
        """Per-node config: telemetry and ingress ports fan out from
        their bases (--obs-port 9100 -> node i scrapes at 9100+i;
        0 = ephemeral).  --ingress-port also mounts the fee-priority
        mempool the client API admits into."""
        if args.obs_port is None and args.ingress_port is None:
            return cfg
        fields = {}
        if args.obs_port is not None:
            fields["obs_port"] = (
                args.obs_port + rank if args.obs_port > 0 else 0
            )
        if args.ingress_port is not None:
            fields["ingress_port"] = (
                args.ingress_port + rank if args.ingress_port > 0 else 0
            )
            fields["mempool_capacity"] = max(1024, 4 * args.batch_size)
        return dataclasses.replace(cfg, **fields)

    hosts = {
        i: ValidatorHost(
            node_cfg(rank),
            i,
            ids,
            keys[i],
            batch_log_path=(
                os.path.join(args.log_dir, f"{i}.log")
                if args.log_dir
                else None
            ),
        )
        for rank, i in enumerate(ids)
    }
    addrs = {i: h.listen() for i, h in hosts.items()}
    print(f"== listening: {addrs}")
    if args.obs_port is not None:
        obs_addrs = {
            i: f"127.0.0.1:{h.obs.port}" for i, h in hosts.items()
        }
        print(f"== telemetry (/metrics /healthz /vars): {obs_addrs}")
    if args.ingress_port is not None:
        ingress_addrs = {
            i: f"127.0.0.1:{h.ingress_server.port}"
            for i, h in hosts.items()
        }
        print(f"== client ingress (submit/subscribe): {ingress_addrs}")
    threads = [
        threading.Thread(target=h.connect, args=(addrs,))
        for h in hosts.values()
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print("== all peers connected")

    # run-unique prefix: with --log-dir, a restarted demo's txs must
    # not collide with the previous run's (already-committed names are
    # dup-filtered by design)
    prefix = b"demo-%d" % time.time_ns()
    txs = [b"%s-tx-%05d" % (prefix, i) for i in range(args.txs)]
    if args.ingress_port is not None:
        # real client path: submit over the ingress gRPC API through
        # the fee-priority mempool, one pipelined stream per node
        from cleisthenes_tpu_torch.transport.ingress import IngressGrpcClient

        ok = 0
        for rank, nid in enumerate(ids):
            client = IngressGrpcClient(
                f"127.0.0.1:{hosts[nid].ingress_server.port}"
            )
            batch = [
                (f"demo-client-{i % 8}", i, 1 + i % 5, tx)
                for i, tx in enumerate(txs)
                if i % args.n == rank
            ]
            acks = client.submit_many(batch)
            ok += sum(1 for a in acks if int(a.status) == 0)
            client.close()
        print(f"== ingress: {ok}/{len(txs)} submits acked OK")
    else:
        for i, tx in enumerate(txs):
            hosts[ids[i % args.n]].submit(tx)

    committed = set()
    t0 = time.monotonic()
    watcher = hosts[ids[0]]
    while committed != set(txs) and time.monotonic() - t0 < args.timeout:
        for h in hosts.values():
            h.propose()
        try:
            epoch, batch = watcher.wait_commit(timeout=2.0)
        except queue.Empty:
            continue
        batch_txs = batch.tx_list()
        committed |= set(batch_txs) & set(txs)
        print(
            f"== epoch {epoch}: committed {len(batch_txs)} txs "
            f"({len(committed)}/{len(txs)} total)"
        )

    snap = watcher.node.metrics.snapshot()
    print(f"== node0 metrics: {snap}")
    if args.trace:
        from cleisthenes_tpu_torch.utils.trace import write_chrome

        events = {
            i: h.node.trace.events()
            for i, h in hosts.items()
            if h.node.trace is not None
        }
        write_chrome(args.trace, events)
        n_events = sum(len(e) for e in events.values())
        print(
            f"== trace: {n_events} events -> {args.trace} "
            "(open at ui.perfetto.dev; validate/report with "
            "python -m tools.tracetool)"
        )
    for h in hosts.values():
        h.stop()
    ok = committed == set(txs)
    print(f"== {'SUCCESS' if ok else 'TIMEOUT'}: {len(committed)}/{len(txs)} txs committed")
    return 0 if ok else 1


def _dkg_rekey(cfg: Config, ids, dealer_keys):
    """Replace the dealer's threshold keys with DKG-generated ones
    (pairwise MAC keys keep the dealer — they are symmetric transport
    secrets, not threshold material; see ops/dkg.py on carriage).  Its
    batched checks run where the roster's crypto runs: on the card
    under ``'cuda'``, on the host otherwise."""
    from cleisthenes_tpu_torch.ops import dkg
    from cleisthenes_tpu_torch.protocol.honeybadger import NodeKeys

    on_card = cfg.crypto_backend == "cuda"
    where = {
        "backend": "cuda" if on_card else "cpu",
        "device": cfg.device if on_card else "cpu",
    }
    tpke_pub, tpke_shares, q1 = dkg.run_dkg(
        n=cfg.n, threshold=cfg.decryption_threshold, **where
    )
    coin_pub, coin_shares, q2 = dkg.run_dkg(
        n=cfg.n, threshold=cfg.f + 1, **where
    )
    print(
        f"== DKG complete: {len(q1)}/{cfg.n} qualified dealers (tpke), "
        f"{len(q2)}/{cfg.n} (coin); no trusted dealer"
    )
    return {
        nid: NodeKeys(
            tpke_pub=tpke_pub,
            tpke_share=tpke_shares[i],
            coin_pub=coin_pub,
            coin_share=coin_shares[i],
            mac_keys=dealer_keys[nid].mac_keys,
        )
        for i, nid in enumerate(sorted(ids))
    }


def _lockstep_main(args, cfg: Config) -> int:
    """--mode lockstep: the SPMD executor end to end."""
    from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster

    cluster = LockstepCluster(config=cfg)
    if args.dkg:
        # swap the dealer's threshold keys for DKG-generated ones
        # before any traffic (lockstep mode honours --dkg too)
        cluster.keys = _dkg_rekey(cfg, cluster.ids, cluster.keys)
        k0 = cluster.keys[cluster.ids[0]]
        cluster.tpke = cluster.crypto.tpke(k0.tpke_pub)
        cluster.coin = cluster.crypto.coin(k0.coin_pub)
    prefix = b"demo-%d" % time.time_ns()
    txs = [b"%s-tx-%05d" % (prefix, i) for i in range(args.txs)]
    for tx in txs:
        cluster.submit(tx)
    t0 = time.monotonic()
    epochs = cluster.run_epochs()
    wall = time.monotonic() - t0
    committed = set()
    for batch in cluster.committed():
        committed |= set(batch.tx_list()) & set(txs)
    s = cluster.last_stats
    print(
        f"== {epochs} lockstep epoch(s) in {wall:.2f}s; last epoch: "
        + " ".join(
            f"{k}={v:.3f}s" for k, v in s.items() if k.endswith("_s")
        )
    )
    ok = committed == set(txs)
    print(
        f"== {'SUCCESS' if ok else 'INCOMPLETE'}: "
        f"{len(committed)}/{len(txs)} txs committed"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
