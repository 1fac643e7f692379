"""loadgen: the million-client ingress load harness.

Every number this repo publishes so far starts at the validator
(epoch open -> commit); none starts where a user does.  This tool
closes that gap: a seeded **open-loop** generator drives a simulated
client population (10^5-10^6 distinct client ids, Pareto-bursty
arrivals, Pareto-skewed fees) through the production ingress path —
the in-proc twin of the client gRPC surface (transport/ingress.py:
identical encoded frames, identical IngressPlane/mempool admission
code) over the deterministic channel cluster — and reports the two
client-visible latencies the two-frontier commit split creates:

    submit -> ordered   (the tx's epoch crossed the ORDERED frontier)
    submit -> settled   (the epoch settled: plaintext durable, acked
                         to subscribers)

measured per tx under K-deep pipelined windows (``--depths 1,4``
runs one arm per depth over the IDENTICAL arrival schedule).

Open-loop means arrivals never wait for the service: each tick
submits whatever the schedule says arrived, whether or not the
cluster kept up — so backpressure (RETRY_AFTER) and priority
eviction are reachable outcomes, not scheduling artifacts.

Every arm is audited before any latency is reported:

- **zero lost acks**: every submission produced exactly one ack, and
  every OK-acked tx either settled exactly ONCE or is accounted by
  the eviction counter — nothing vanished in between (the mempool's
  no-silent-drops promise, end to end).
- **settled superset of ordered**: the settled frontier caught the
  ordered frontier at drain, so no ordered epoch was left undecrypted.
- **cross-node agreement**: every node settled the byte-identical
  batch sequence (SimulatedCluster.assert_agreement).
- **cross-arm determinism**: the settled tx content digests at every
  depth are identical — pipelining moves WHEN work settles, never
  WHAT settles.

CI rides the same path: ``--smoke`` shrinks the population to a
seconds-scale run with the same invariants (the ci.sh ingress stage).

The port's copy of the reference's ``tools/loadgen.py``.  Where the
reference pins the host backend, the port's clusters take ``Config``'s
defaults, the crypto on the card (``crypto_backend='cuda'`` on
``device='cuda'``, raising on a machine without one); ``--crypto
cpu|cpp|cuda`` and ``--device`` choose another.

    python -m cleisthenes_tpu_torch.tools.loadgen --clients 100000 --txs 100000 --depths 1,4
    python -m cleisthenes_tpu_torch.tools.loadgen --smoke [--crypto cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import random
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

from cleisthenes_tpu_torch.config import Config

# full-run defaults: the acceptance shape (1e5 distinct clients).
# Smoke shrinks everything by ~100x but keeps every invariant.
DEFAULT_CLIENTS = 100_000
DEFAULT_TXS = 100_000
DEFAULT_N = 4
DEFAULT_BATCH = 1024
DEFAULT_SEED = 7
DEFAULT_DEPTHS = (1, 4)
DEFAULT_TICKS = 64
# Pareto shape for inter-arrival gaps (alpha <= 2 means bursty: heavy
# tail of long gaps between arrival clumps) and for the fee skew (a
# few clients pay a lot, most pay little — the shape that makes
# fee-priority draining mean something)
ARRIVAL_ALPHA = 1.5
FEE_ALPHA = 1.2

SMOKE_CLIENTS = 2_000
SMOKE_TXS = 1_200
SMOKE_BATCH = 64
SMOKE_TICKS = 12


def build_schedule(
    *, clients: int, txs: int, ticks: int, seed: int
) -> List[List[Tuple[str, int, int, bytes]]]:
    """The arrival schedule all arms share: per tick, a list of
    (client_id, nonce, fee, tx).  Seeded and arm-independent — depth
    must never change what arrives, only how it drains.

    Client ids cycle through the whole population (txs >= clients
    means every simulated client really submits); arrival times are
    cumulative Pareto gaps normalized onto [0, ticks); fees are
    Pareto-skewed ints in [1, 10^6]."""
    rng = random.Random(seed)
    gaps = [rng.paretovariate(ARRIVAL_ALPHA) for _ in range(txs)]
    t, arrivals = 0.0, []
    for g in gaps:
        t += g
        arrivals.append(t)
    scale = ticks / arrivals[-1] if arrivals else 1.0
    schedule: List[List[Tuple[str, int, int, bytes]]] = [
        [] for _ in range(ticks)
    ]
    for i, at in enumerate(arrivals):
        tick = min(ticks - 1, int(at * scale))
        client = f"c{i % clients:07d}"
        fee = min(1_000_000, int(rng.paretovariate(FEE_ALPHA)))
        tx = b"load|%07d|%s" % (i, client.encode())
        schedule[tick].append((client, i, fee, tx))
    return schedule


def _pctl(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[
        max(0, min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1)))))
    ]


def run_arm(
    schedule,
    *,
    depth: int,
    n: int = DEFAULT_N,
    batch: int = DEFAULT_BATCH,
    seed: int = DEFAULT_SEED,
    lanes: int = 1,
    max_drain_rounds: int = 400,
    wan_profile: Optional[str] = None,
    progress=None,
    crypto: str = Config.crypto_backend,
    device: str = Config.device,
) -> Dict:
    """One measured arm: drive the shared schedule through per-node
    ingress twins at pipeline depth ``depth``, drain to quiescence,
    audit the invariants, and report both latency distributions.

    Raises AssertionError on any invariant breach — a loadgen number
    from a run that lost a tx is not a number.  The roster's crypto
    runs on ``crypto``/``device``."""
    from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster

    txs_total = sum(len(tick) for tick in schedule)
    cfg = Config(
        n=n,
        batch_size=batch,
        seed=seed,
        crypto_backend=crypto,
        device=device,
        # lanes > 1 shards the schedule across S consensus lanes: the
        # mempool's admit() routes each tx by seeded digest hash, so
        # loadgen exercises the production partitioner, not its own
        lanes=lanes,
        epoch_pipelining=depth > 1,
        pipeline_depth=depth,
        # keep validation headroom: reconfig_lead must exceed
        # depth + decrypt_lag_max, and loadgen never reconfigures
        reconfig_lead=16,
        # capacity sized to the whole backlog: this harness measures
        # latency under load, not admission-control behavior (the
        # backpressure tests own that) — every arrival must admit so
        # the arms settle identical content
        mempool_capacity=max(4 * batch, txs_total),
        mempool_client_cap=64,
        mempool_seen_cap=max(1 << 16, 2 * txs_total),
    )
    # wan_profile composes the link-delay plane (transport/wan.py) under the load:
    # client-visible latency with geo-realistic delivery schedules
    cluster = SimulatedCluster(
        config=cfg, seed=seed, auto_propose=False, wan_profile=wan_profile
    )
    ids = cluster.ids
    ingress = {nid: cluster.ingress(nid) for nid in ids}
    node0 = cluster.nodes[ids[0]]

    submit_ts: Dict[bytes, float] = {}
    status_counts: Dict[str, int] = {}
    acks = 0
    ok_txs: List[bytes] = []
    t_ordered: Dict[int, float] = {}
    t_settled: Dict[int, float] = {}
    seen_ordered = seen_settled = 0

    def record_frontiers() -> None:
        # MERGED frontiers (== epoch/settled_epoch at lanes=1): slot
        # timestamps and the exactly-once audit span every lane
        nonlocal seen_ordered, seen_settled
        now = time.perf_counter()
        while seen_ordered < node0.merged_ordered_frontier:
            t_ordered[seen_ordered] = now
            seen_ordered += 1
        while seen_settled < node0.merged_settled_frontier:
            t_settled[seen_settled] = now
            seen_settled += 1

    def one_round() -> None:
        # step (one delivery wave at a time) instead of run-to-
        # quiescence, observing the frontiers between waves: the
        # ordered frontier visibly leads the settled frontier inside
        # a round, which is exactly the two-latency split this
        # harness exists to measure
        for hb in cluster.nodes.values():
            hb.start_epoch()
        net = cluster.net
        while True:
            if net.step():
                record_frontiers()
                continue
            # the manual-driving contract (ChannelNetwork.step): a
            # drained queue needs the idle phase (deferred crypto +
            # bundle flushes) and another pass if it produced traffic
            net.idle_phase()
            record_frontiers()
            if not net._pending and not net._wan_holding:
                break

    t_start = time.perf_counter()
    for tick, batch_arrivals in enumerate(schedule):
        for client, nonce, fee, tx in batch_arrivals:
            # deterministic client -> admitting-node placement
            ack = ingress[ids[nonce % n]].submit(client, nonce, fee, tx)
            acks += 1
            name = ack.status.name if hasattr(ack.status, "name") else str(
                ack.status
            )
            status_counts[name] = status_counts.get(name, 0) + 1
            if name == "OK":
                submit_ts[tx] = time.perf_counter()
                ok_txs.append(tx)
        one_round()
        if progress is not None:
            progress(tick + 1, len(schedule))
    # drain: open-loop arrivals are done; run until every frontier
    # catches up and nothing is pending anywhere
    rounds = 0
    while rounds < max_drain_rounds and (
        cluster.pending() > 0
        or node0.merged_settled_frontier < node0.merged_ordered_frontier
    ):
        one_round()
        rounds += 1
    t_end = time.perf_counter()

    # -- audits (the numbers are only as good as these) ----------------
    assert acks == txs_total, f"lost acks: {acks} != {txs_total}"
    settle_epoch: Dict[bytes, int] = {}
    dup_settles = 0
    # merged total order: a tx that settled in two different lanes
    # would surface as a duplicate here — the cross-lane
    # exactly-once audit (== the single-lane one at lanes=1)
    for e, b in enumerate(node0.merged_batches):
        for tx in b.tx_list():
            if tx in settle_epoch:
                dup_settles += 1
            settle_epoch[tx] = e
    assert dup_settles == 0, f"{dup_settles} txs settled more than once"
    evicted = sum(
        hb.mempool.evicted for hb in cluster.nodes.values()
    )
    lost = [tx for tx in ok_txs if tx not in settle_epoch]
    assert len(lost) == evicted, (
        f"{len(lost)} OK-acked txs unsettled but only {evicted} evictions"
    )
    assert node0.merged_settled_frontier == node0.merged_ordered_frontier, (
        f"merged settled frontier {node0.merged_settled_frontier} trails "
        f"ordered {node0.merged_ordered_frontier} after drain"
    )
    cluster.assert_agreement()
    lane_fill = node0.mempool.lane_fill()
    ledger = hashlib.sha256()
    for tx in sorted(settle_epoch):
        ledger.update(tx)
    ingress_block = node0.metrics.snapshot()["ingress"]
    cluster.stop()

    lat_ordered = sorted(
        t_ordered[settle_epoch[tx]] - ts
        for tx, ts in submit_ts.items()
        if tx in settle_epoch
    )
    lat_settled = sorted(
        t_settled[settle_epoch[tx]] - ts
        for tx, ts in submit_ts.items()
        if tx in settle_epoch
    )
    wall = t_end - t_start
    return {
        "depth": depth,
        "lanes": lanes,
        "lane_fill": lane_fill,
        "lane_skew": max(lane_fill) - min(lane_fill),
        "wan_profile": wan_profile,
        "clients": len({c for tick in schedule for (c, _, _, _) in tick}),
        "txs": txs_total,
        "settled": len(settle_epoch),
        "evicted": evicted,
        "statuses": dict(sorted(status_counts.items())),
        "epochs": node0.merged_settled_frontier,
        "drain_rounds": rounds,
        "wall_s": round(wall, 3),
        "tx_per_s": round(len(settle_epoch) / wall, 1) if wall else 0.0,
        "submit_to_ordered_ms": {
            "p50": round(_pctl(lat_ordered, 0.50) * 1e3, 3),
            "p99": round(_pctl(lat_ordered, 0.99) * 1e3, 3),
        },
        "submit_to_settled_ms": {
            "p50": round(_pctl(lat_settled, 0.50) * 1e3, 3),
            "p99": round(_pctl(lat_settled, 0.99) * 1e3, 3),
        },
        "ledger_digest": ledger.hexdigest(),
        "node_metrics_ingress": ingress_block,
    }


def run(
    *,
    clients: int,
    txs: int,
    depths,
    n: int = DEFAULT_N,
    batch: int = DEFAULT_BATCH,
    ticks: int = DEFAULT_TICKS,
    seed: int = DEFAULT_SEED,
    lanes: int = 1,
    quiet: bool = False,
    crypto: str = Config.crypto_backend,
    device: str = Config.device,
) -> Dict:
    """All arms over one shared schedule + the cross-arm audit."""
    schedule = build_schedule(
        clients=clients, txs=txs, ticks=ticks, seed=seed
    )
    arms = []
    for depth in depths:
        if not quiet:
            print(f"[loadgen] arm depth={depth}: {txs} txs, "
                  f"{clients} clients, {ticks} ticks, "
                  f"{lanes} lane(s)", flush=True)
        arms.append(
            run_arm(
                schedule, depth=depth, n=n, batch=batch, seed=seed,
                lanes=lanes, crypto=crypto, device=device,
            )
        )
        if not quiet:
            a = arms[-1]
            print(
                f"[loadgen]   settled {a['settled']}/{a['txs']} in "
                f"{a['wall_s']}s ({a['tx_per_s']} tx/s), "
                f"ordered p50 {a['submit_to_ordered_ms']['p50']}ms "
                f"p99 {a['submit_to_ordered_ms']['p99']}ms, "
                f"settled p50 {a['submit_to_settled_ms']['p50']}ms "
                f"p99 {a['submit_to_settled_ms']['p99']}ms"
                + (f", lane skew {a['lane_skew']}" if lanes > 1 else ""),
                flush=True,
            )
    digests = {a["ledger_digest"] for a in arms}
    assert len(digests) == 1, (
        f"settled ledgers diverge across depth arms: "
        f"{[(a['depth'], a['ledger_digest'][:16]) for a in arms]}"
    )
    return {
        "kind": "ingress_load",
        "seed": seed,
        "clients": clients,
        "txs": txs,
        "ticks": ticks,
        "n": n,
        "batch": batch,
        "arms": arms,
        "ledger_digest": arms[0]["ledger_digest"],
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="cleisthenes_tpu_torch.tools.loadgen",
        description=__doc__.split("\n")[0],
    )
    ap.add_argument("--clients", type=int, default=DEFAULT_CLIENTS)
    ap.add_argument("--txs", type=int, default=DEFAULT_TXS)
    ap.add_argument("--n", type=int, default=DEFAULT_N)
    ap.add_argument("--batch", type=int, default=DEFAULT_BATCH)
    ap.add_argument("--ticks", type=int, default=DEFAULT_TICKS)
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    ap.add_argument(
        "--lanes", type=int, default=1,
        help="consensus lanes (Config.lanes); submits shard across "
        "lanes through the production hash partitioner",
    )
    ap.add_argument(
        "--depths", default=",".join(str(d) for d in DEFAULT_DEPTHS),
        help="comma-separated pipeline depths, one arm each",
    )
    ap.add_argument(
        "--smoke", action="store_true",
        help="seconds-scale run with the full invariant audit "
        "(the ci.sh ingress stage)",
    )
    ap.add_argument(
        "--crypto", default=Config.crypto_backend,
        choices=("cuda", "cpu", "cpp"),
        help="crypto backend of every arm (default: the card's)",
    )
    ap.add_argument(
        "--device", default=Config.device,
        help="torch device of the 'cuda' backend ('cuda[:N]', or 'cpu' "
        "for the kernels' plain versions)",
    )
    ap.add_argument("--json", help="write the result document here")
    args = ap.parse_args(argv)

    if args.smoke:
        args.clients = min(args.clients, SMOKE_CLIENTS)
        args.txs = min(args.txs, SMOKE_TXS)
        args.batch = min(args.batch, SMOKE_BATCH)
        args.ticks = min(args.ticks, SMOKE_TICKS)
    depths = [int(d) for d in str(args.depths).split(",") if d]

    result = run(
        clients=args.clients,
        txs=args.txs,
        depths=depths,
        n=args.n,
        batch=args.batch,
        ticks=args.ticks,
        seed=args.seed,
        lanes=args.lanes,
        crypto=args.crypto,
        device=args.device,
    )
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(result, fh, indent=2, sort_keys=True)
        print(f"[loadgen] wrote {args.json}")
    print(
        f"[loadgen] PASS: {len(result['arms'])} arms, "
        f"ledger {result['ledger_digest'][:16]}..., zero lost acks"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
