"""Deterministic schedule fuzzer for the semantic Byzantine plane.

Samples composite fault schedules — semantic node behaviors
(protocol.byzantine) x wire-level faults (utils.adversary.Coalition) x
crash/partition/heal timelines — runs them over a seeded
``SimulatedCluster``, and checks SAFETY INVARIANTS at every quiescence
point:

  agreement      every honest node's committed-batch prefix is
                 byte-identical (ledger-body bytes, the exact bytes a
                 WAL persists and CATCHUP serves)
  no_foreign_tx  no honest node ever commits a transaction nobody
                 submitted (sound here because the sampled adversaries
                 never inject well-formed ciphertexts of new txs —
                 a planted foreign tx is exactly how the self-test
                 plants a violation)
  liveness       every honest-submitted tx commits on every honest
                 node within the schedule's round budget

On a violation the fuzzer GREEDILY SHRINKS the schedule — dropping
timeline events, wire stages and behaviors, then halving txs/rounds —
re-running after each candidate edit and keeping it only if the
violation survives.  The minimal schedule is written as a replayable
repro file (seed + schedule JSON + violation) plus, when tracing is
requested, a flight-recorder artifact of the failing run.

Everything is a pure function of the schedule dict: same schedule,
same run, same verdict — which is what makes the repro files useful.

The port's copy of the reference's ``tools/fuzz.py``: the same
sampler, invariants and shrinker.  The clusters it builds take the
port's ``Config`` defaults, the crypto on the card
(``crypto_backend='cuda'`` on ``device='cuda'``, raising on a machine
without one); ``crypto``/``device`` (``--crypto cpu|cpp|cuda``,
``--device``) choose another backend.  Neither enters a schedule, so a
repro file replays on any backend.

Usage:
  python -m cleisthenes_tpu_torch.tools.fuzz --seeds 0:20       # CI smoke sweep
  python -m cleisthenes_tpu_torch.tools.fuzz --seed 7 --show    # print one schedule
  python -m cleisthenes_tpu_torch.tools.fuzz --repro r.json     # replay a repro file
  python -m cleisthenes_tpu_torch.tools.fuzz --seeds 0:20 --crypto cpu   # on the host
"""

from __future__ import annotations

import argparse
import copy
import json
import random
import sys
from typing import Dict, List, Optional, Sequence

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core.ledger import encode_batch_body
from cleisthenes_tpu_torch.protocol.byzantine import (
    BEHAVIOR_KINDS,
    CompositeBehavior,
    make_behavior,
)
from cleisthenes_tpu_torch.protocol.cluster import (
    SimulatedCluster,
    run_until_drained,
)
from cleisthenes_tpu_torch.utils.adversary import Coalition

SCHEDULE_VERSION = 1

# wire stages the sampler may enable, with their sampled-argument
# ranges (kept mild: the budget is f Byzantine nodes, not a dead net)
_WIRE_STAGES = (
    ("drop", {"fraction": (0.05, 0.4)}),
    ("tamper", {"fraction": (0.1, 0.7)}),
    ("duplicate", {"fraction": (0.1, 0.5)}),
    ("replay", {"fraction": (0.1, 0.5)}),
    ("delay", {"fraction": (0.05, 0.3)}),
    ("reorder", {"fraction": (0.1, 0.5)}),
)

# kinds the sampler may mount: every library behavior EXCEPT the tx
# injector — injecting txs is legal HBBFT behavior that deliberately
# trips no_foreign_tx, so it exists only for planted-violation
# schedules (shrinker self-tests), never sampled sweeps
_SEMANTIC_KINDS = tuple(
    sorted(k for k in BEHAVIOR_KINDS if k != "tx_injector")
)


class Violation(Exception):
    """A safety/liveness invariant failed; carries the report dict."""

    def __init__(self, invariant: str, detail: str, rnd: int) -> None:
        super().__init__(f"{invariant}: {detail} (round {rnd})")
        self.report = {
            "invariant": invariant,
            "detail": detail,
            "round": rnd,
        }


# ---------------------------------------------------------------------------
# schedule sampling
# ---------------------------------------------------------------------------


def sample_schedule(
    seed: int,
    n: int = 4,
    rounds: int = 12,
    reconfig: bool = False,
    pipeline_depth: Optional[int] = None,
    wan: bool = False,
    wan_profile: Optional[str] = None,
    ingress: bool = False,
    reduced: bool = False,
    lanes: bool = False,
) -> dict:
    """One composite fault schedule, a pure function of ``seed``.

    All faults — semantic behaviors, wire stages, crash/partition
    timeline — are confined to ONE f-sized coalition, so the honest
    majority keeps its HBBFT guarantees and the liveness invariant is
    legitimately enforceable.

    ``reconfig=True`` (the dynamic-membership band) additionally
    schedules one roster-change event — a joiner, sometimes composed
    with the retirement of a COALITION member — so crash/partition/
    semantic schedules run ACROSS a reshare ceremony and an
    activation boundary, and the safety invariants span the roster
    change.

    ``pipeline_depth`` pins the K-deep protocol-plane window (the
    ci.sh depth band); None draws it from the seed (LAST, so the
    depth key extends the historical schedule stream instead of
    reshuffling it), spanning lockstep and pipelined windows.

    ``wan=True`` (the WAN band) mounts a seeded link-delay
    profile on the channel scheduler — drawn from the seed AFTER
    every other key (the same append-LAST rule as depth, so the WAN
    band's schedules extend the historical stream), or pinned with
    ``wan_profile``.

    ``ingress=True`` (the client-ingress band) routes every
    submitted tx through the in-proc twin of the client gRPC surface
    (SimulatedCluster.ingress -> IngressPlane -> fee-priority
    mempool) instead of add_transaction, with the admission schedule
    — pool capacity, per-client cap, client population, duplicate
    resubmit mix — drawn from the seed LAST of all (after the WAN
    key, the same append-LAST rule), so every older band's seed
    stream stays bit-identical.

    ``reduced=True`` (the reduced-quorum band) samples the
    attested 2f+1 trust model instead: the roster is drawn from the
    n >= 2f+1 shapes {3, 5, 7} at FULL fault budget f = (n-1)//2 —
    rosters the baseline 3f+1 arithmetic cannot carry — with
    ``Config.attested_log`` + ``Config.reduced_quorum`` mounted.  The
    coalition is restricted to wire-level + crash/partition faults
    plus the Equivocator, because that is the model's contract: the
    reduced quorum's intersection argument assumes equivocation is
    EXCLUDED (the attested log converts it to detectable omission),
    not that arbitrary semantic lies are tolerated past n/3.  This
    band is a NEW seed stream (n and f are drawn differently by
    construction); every reduced=False band's stream is untouched.

    ``lanes=True`` (the lane shard-out band) draws a lane
    count S from {2, 3, 4} — LAST of all keys, after the ingress
    draw, so every older band's seed stream stays bit-identical —
    and mounts Config.lanes=S: S independent HBBFT lanes over the
    one roster, tx-hash-partitioned admission, and the deterministic
    cross-lane total-order merge.  Gates the merge-determinism and
    cross-lane settle-exactly-once invariants.  Incompatible with
    ``reconfig`` (dynamic membership is a lanes=1 feature; Config
    enforcement aside, the WAL lane framing has no reconfig
    records)."""
    rng = random.Random(seed)
    if reduced:
        n = rng.choice((3, 5, 7))
        f = (n - 1) // 2
    else:
        f = (n - 1) // 3
    ids = [f"node{i:03d}" for i in range(n)]
    bad = sorted(rng.sample(ids, f)) if f else []

    behaviors: List[dict] = []
    if reduced:
        # the only semantic behavior the band mounts is the attack
        # the attested log exists to kill; its lies must degrade to
        # omission (detected + excluded), never fork honest ledgers
        for node in bad:
            if rng.random() < 0.5:
                behaviors.append(
                    {
                        "kind": "equivocator",
                        "node": node,
                        "seed": rng.randrange(1 << 16),
                    }
                )
    else:
        for node in bad:
            for kind in rng.sample(_SEMANTIC_KINDS, rng.randrange(0, 3)):
                behaviors.append(
                    {
                        "kind": kind,
                        "node": node,
                        "seed": rng.randrange(1 << 16),
                    }
                )

    wire: List[dict] = []
    for stage, argspec in _WIRE_STAGES:
        if rng.random() < 0.35:
            args = {
                name: round(rng.uniform(lo, hi), 3)
                for name, (lo, hi) in argspec.items()
            }
            wire.append({"stage": stage, "args": args})

    timeline: List[dict] = []
    if bad and rng.random() < 0.5:
        victim = rng.choice(bad)
        at = rng.randrange(1, max(2, rounds // 2))
        timeline.append({"round": at, "op": "crash", "node": victim})
        if rng.random() < 0.6:
            timeline.append(
                {
                    "round": rng.randrange(at + 1, at + 4),
                    "op": "recover",
                    "node": victim,
                }
            )
    if bad and rng.random() < 0.4:
        b = rng.choice(bad)
        peer = rng.choice([i for i in ids if i != b])
        at = rng.randrange(0, max(1, rounds // 2))
        timeline.append(
            {"round": at, "op": "partition", "node": b, "peer": peer}
        )
        timeline.append(
            {
                "round": rng.randrange(at + 1, at + 4),
                "op": "heal",
                "node": b,
                "peer": peer,
            }
        )
    if reconfig:
        honest_now = [i for i in ids if i not in bad]
        ev = {
            "round": rng.randrange(1, 4),
            "op": "reconfig",
            "node": honest_now[0],  # submit via a surviving honest node
            "join": [f"nodeJ{seed % 100:02d}"],
            "retire": (
                [rng.choice(bad)] if bad and rng.random() < 0.5 else []
            ),
        }
        timeline.append(ev)
    timeline.sort(key=lambda ev: (ev["round"], ev["op"], ev["node"]))
    if pipeline_depth is None:
        # K-deep pipelined frontiers: the cross-frontier
        # invariants must hold over every window width, so depth is
        # part of the sampled schedule space
        pipeline_depth = rng.choice((1, 2, 4))
    if wan and wan_profile is None:
        # WAN link-delay plane: drawn LAST — the newest
        # appended key, after depth — so non-WAN replays of historical
        # seeds are untouched and WAN-band schedules share every other
        # draw with their non-WAN twins
        from cleisthenes_tpu_torch.transport.wan import wan_profile_names

        wan_profile = rng.choice(wan_profile_names())
    ingress_cfg: Optional[dict] = None
    if ingress:
        # client-ingress admission schedule: drawn LAST —
        # the newest appended key, after the WAN draw — so non-ingress
        # replays of historical seeds are untouched and an ingress
        # schedule shares every other draw with its non-ingress twin.
        # capacity below the per-admitter share of txs (txs spread
        # round-robin over the honest nodes) forces priority eviction
        # / RETRY_AFTER on some seeds; client_cap 2 trips per-client
        # backpressure; the dup fraction exercises the ingress-side
        # seen-ring dedup
        ingress_cfg = {
            "capacity": rng.choice((2, 3, 6, 16)),
            "client_cap": rng.choice((2, 4, 64)),
            "clients": rng.choice((3, 5, 8)),
            "dup_fraction": round(rng.uniform(0.0, 0.4), 3),
            "client_seed": rng.randrange(1 << 16),
        }
    lanes_n: Optional[int] = None
    if lanes:
        if reconfig:
            raise ValueError(
                "the lane band cannot compose with reconfig "
                "(Config.lanes > 1 rejects dynamic membership)"
            )
        # lane shard-out: drawn LAST — the newest appended
        # key, after the ingress draw — so non-lane replays of
        # historical seeds are untouched and a lane schedule shares
        # every other draw with its single-lane twin
        lanes_n = rng.choice((2, 3, 4))

    out = {
        "version": SCHEDULE_VERSION,
        "seed": seed,
        "pipeline_depth": pipeline_depth,
        "n": n,
        "f": f,
        "batch_size": 8,
        "key_seed": 33,
        "rounds": rounds,
        "txs": 3 * n,
        "bad": bad,
        "behaviors": behaviors,
        "wire": wire,
        "timeline": timeline,
        "check_liveness": True,
    }
    if wan_profile is not None:
        out["wan_profile"] = wan_profile
    if ingress_cfg is not None:
        out["ingress"] = ingress_cfg
    if lanes_n is not None:
        out["lanes"] = lanes_n
    if reduced:
        # one key implies both flags: Config enforces that the
        # reduced quorum never mounts without the attested log
        out["reduced"] = True
    return out


# ---------------------------------------------------------------------------
# schedule execution
# ---------------------------------------------------------------------------


def _build_cluster(
    schedule: dict,
    trace: bool,
    crypto: str = Config.crypto_backend,
    device: str = Config.device,
) -> SimulatedCluster:
    by_node: Dict[str, list] = {}
    for spec in schedule["behaviors"]:
        b = make_behavior(
            spec["kind"], seed=spec.get("seed", 0), **spec.get("args", {})
        )
        by_node.setdefault(spec["node"], []).append(b)
    behaviors = {
        nid: (bs[0] if len(bs) == 1 else CompositeBehavior(bs))
        for nid, bs in by_node.items()
    }
    depth = int(schedule.get("pipeline_depth", 1))
    # the lead must clear depth + the DEFAULT lag the cluster runs
    # under (read off the dataclass, never a re-stated literal)
    lag = Config.__dataclass_fields__["decrypt_lag_max"].default
    # client-ingress band: the schedule mounts the
    # fee-priority mempool at its sampled capacity; absent on
    # historical schedules (capacity 0 keeps the direct
    # add_transaction path)
    ing = schedule.get("ingress")
    # reduced-quorum band: the schedule key mounts the
    # attested sender log AND the n-f quorum arithmetic together
    # (Config rejects the latter without the former); Config
    # re-derives f = (n-1)//2 to match the schedule's coalition size
    red = bool(schedule.get("reduced"))
    cfg = Config(
        n=schedule["n"],
        batch_size=schedule["batch_size"],
        seed=schedule["seed"],
        trace=trace,
        attested_log=red,
        reduced_quorum=red,
        # schedules may pin the routing arm: wave_routing drains a
        # whole wave before any handler runs, so the scalar arm's
        # finer per-message interleavings are a schedule space of
        # their own — a band stays pinned to it (the key round-trips
        # through repro files like every other schedule field)
        wave_routing=schedule.get("wave_routing", True),
        # K-deep window: depth rides the schedule; the
        # reconfig lead stretches with it where the default would
        # violate Config's lead > depth + decrypt_lag_max bound
        pipeline_depth=depth,
        reconfig_lead=max(8, depth + lag + 1),
        mempool_capacity=(0 if ing is None else int(ing["capacity"])),
        mempool_client_cap=(
            64 if ing is None else int(ing["client_cap"])
        ),
        # lane shard-out band: absent on historical
        # schedules (lanes=1 keeps the single-lane build bit-for-bit)
        lanes=int(schedule.get("lanes", 1)),
        crypto_backend=crypto,
        device=device,
    )
    cluster = SimulatedCluster(
        n=schedule["n"],
        config=cfg,
        seed=schedule["seed"],
        key_seed=schedule["key_seed"],
        behaviors=behaviors,
        # WAN band: the schedule key mounts the seeded
        # link-delay profile; absent on historical schedules
        wan_profile=schedule.get("wan_profile"),
    )
    if schedule["wire"]:
        coal = Coalition(schedule["bad"], seed=schedule["seed"])
        for spec in schedule["wire"]:
            getattr(coal, spec["stage"])(**spec["args"])
        cluster.fault_filter = coal.filter
    return cluster


def _apply_event(cluster, ev: dict) -> None:
    op = ev["op"]
    net = cluster.net
    if op == "crash":
        net.crash(ev["node"])
    elif op == "recover":
        net.recover(ev["node"])
    elif op == "partition":
        net.partition(ev["node"], ev["peer"])
    elif op == "heal":
        net.heal(ev["node"], ev["peer"])
    elif op == "reconfig":
        # dynamic membership: joiners wire in, the RECONFIG tx is
        # submitted via the named (honest, surviving) node, and the
        # in-band reshare ceremony runs composed with whatever other
        # faults the schedule mounts
        cluster.begin_reconfig(
            join=ev.get("join", ()),
            retire=ev.get("retire", ()),
            submit_via=ev["node"],
        )
    else:
        raise ValueError(f"unknown timeline op {op!r}")


def _check_safety(cluster, honest: List[str], submitted: set, rnd: int):
    """Raise Violation on any safety breach at this quiescence point.

    ``honest`` is the STATIC honest list; joiners added mid-run by a
    reconfig event are honest by construction and fold in here, so
    the agreement/no-foreign-tx/roster invariants span the roster
    change (a joiner still bootstrapping contributes depth 0 and
    tightens nothing until it adopts)."""
    from cleisthenes_tpu_torch.core.ledger import decode_ordered_body
    from cleisthenes_tpu_torch.protocol.reconfig import is_protocol_tx

    nodes = cluster.nodes
    depth = min(len(nodes[h].committed_batches) for h in honest)
    for e in range(depth):
        bodies = {
            encode_batch_body(e, nodes[h].committed_batches[e])
            for h in honest
        }
        if len(bodies) != 1:
            raise Violation(
                "agreement",
                f"honest ledgers fork at epoch {e}",
                rnd,
            )
    for h in honest:
        # merged total order (== committed_batches at lanes=1): the
        # foreign-tx sweep must cover EVERY lane's settled work, and
        # a tx that settled in two lanes is a cross-lane
        # exactly-once breach
        seen_txs: set = set()
        for e, batch in enumerate(nodes[h].merged_batches):
            for tx in batch.tx_list():
                if tx not in submitted and not is_protocol_tx(tx):
                    # reconfig-machinery txs (RECONFIG + dealings)
                    # are node-originated, never client-submitted
                    raise Violation(
                        "no_foreign_tx",
                        f"{h} committed unsubmitted tx {tx!r} "
                        f"in epoch {e}",
                        rnd,
                    )
                if tx in seen_txs:
                    raise Violation(
                        "lane_exactly_once",
                        f"{h} settled tx {tx!r} in two merged "
                        f"slots (second at {e})",
                        rnd,
                    )
                seen_txs.add(tx)
    # -- merge determinism (Config.lanes > 1) ---------------
    # every honest node's merged total order is byte-identical at the
    # common merged frontier: the merge is a pure function of the
    # committed lane streams, so a divergence here is a fork even
    # when each per-lane ledger agrees
    mdepth = min(nodes[h].merged_settled_frontier for h in honest)
    for e in range(mdepth):
        bodies = {
            encode_batch_body(e, nodes[h].merged_batches[e])
            for h in honest
        }
        if len(bodies) != 1:
            raise Violation(
                "merge_determinism",
                f"honest MERGED orders fork at slot {e}",
                rnd,
            )
    # -- roster agreement (dynamic membership) ------------------------
    # every honest node that installed a roster version agrees on its
    # activation epoch and key-material digest (the committed ceremony
    # is one log; divergent keys would be a consensus fork in disguise)
    versions: Dict[int, tuple] = {}
    for h in honest:
        for rv in nodes[h].rosters:
            if not rv.key_material_digest:
                # synthetic genesis record (a joiner's base version
                # carries no ceremony material), never comparable to
                # the real installed version of the same number
                continue
            got = (rv.activation_epoch, rv.member_ids,
                   rv.key_material_digest)
            want = versions.setdefault(rv.version, got)
            if got != want:
                raise Violation(
                    "roster_agreement",
                    f"{h} roster v{rv.version} diverges "
                    f"(activation/members/keys)",
                    rnd,
                )
    # -- two-frontier invariants (Config.order_then_settle) --
    # checked PER LANE (nodes[h].lanes is [self] at lanes=1): each
    # lane runs its own ordered/settled frontier pair
    lag_max = cluster.config.decrypt_lag_max
    for h, hb in (
        (h, lane_hb) for h in honest for lane_hb in nodes[h].lanes
    ):
        settled = len(hb.committed_batches)
        # backpressure bound: a coalition delaying settlement (share
        # forgery) may park ordering AT the bound, never push it past
        if hb.epoch - settled > lag_max:
            raise Violation(
                "decrypt_lag_bound",
                f"{h} ordered frontier {hb.epoch} ran "
                f"{hb.epoch - settled} epochs ahead of settlement "
                f"(bound {lag_max})",
                rnd,
            )
        # the settled prefix is a prefix OF the ordered log: every
        # settled epoch that was locally ordered commits exactly the
        # proposals its COrd record agreed on (epochs adopted via
        # plaintext catch-up alone legitimately carry no COrd)
        for e in range(settled):
            body = hb.ordered_record(e)
            if body is None:
                continue
            oepoch, output = decode_ordered_body(body)
            if oepoch != e:
                raise Violation(
                    "ordered_prefix",
                    f"{h} COrd body for epoch {e} claims epoch "
                    f"{oepoch}",
                    rnd,
                )
            extra = set(
                hb.committed_batches[e].contributions
            ) - set(output)
            if extra:
                raise Violation(
                    "ordered_prefix",
                    f"{h} settled epoch {e} with proposers "
                    f"{sorted(extra)} absent from its ordered record",
                    rnd,
                )
    # honest nodes' ordered logs are byte-identical wherever two of
    # them ordered the same epoch (the ACS output is one agreed value;
    # COrd bodies are its canonical encoding) — checked per lane
    # (every honest node runs the same Config.lanes; min() guards a
    # mid-bootstrap joiner's view)
    n_lanes = min(len(nodes[h].lanes) for h in honest)
    for k in range(n_lanes):
        ordered_depth = max(nodes[h].lanes[k].epoch for h in honest)
        for e in range(ordered_depth):
            bodies = {
                body
                for h in honest
                if (body := nodes[h].lanes[k].ordered_record(e))
                is not None
            }
            if len(bodies) > 1:
                raise Violation(
                    "ordered_agreement",
                    f"honest ORDERED logs fork at lane {k} "
                    f"epoch {e}",
                    rnd,
                )


def _ingress_submit(
    cluster,
    honest: List[str],
    schedule: dict,
    submitted: set,
    ok_acked: Dict[bytes, str],
) -> None:
    """Drive the schedule's client band through the in-proc ingress
    twins: every tx submits as an encoded client frame via
    SimulatedCluster.ingress() — the production admission path — with
    client identity, fee bid and duplicate resubmits drawn from the
    schedule's ``client_seed``.  Fills ``submitted`` (every tx, for
    no_foreign_tx) and ``ok_acked`` (tx -> admitting node, for the
    settle-exactly-once audit).  Raises Violation on an
    admission-contract breach at submit time: an unknown ack status,
    or a resubmit of an OK-acked tx that does not ack DUPLICATE."""
    from cleisthenes_tpu_torch.transport.message import IngressStatus

    ing = schedule["ingress"]
    irng = random.Random(ing["client_seed"])
    clients = [f"fzclient{c:02d}" for c in range(ing["clients"])]
    gates = {h: cluster.ingress(h) for h in honest}
    for i in range(schedule["txs"]):
        tx = b"fuzz-%06d" % i
        h = honest[i % len(honest)]
        client = irng.choice(clients)
        fee = irng.randrange(1, 1_000)
        # the dup decision draws BEFORE the ack is known, so the rng
        # stream's shape never depends on mempool admission outcomes
        want_dup = irng.random() < ing["dup_fraction"]
        ack = gates[h].submit(client, i, fee, tx)
        submitted.add(tx)
        status = IngressStatus(ack.status)
        if status is IngressStatus.OK:
            ok_acked[tx] = h
        elif status is not IngressStatus.RETRY_AFTER:
            # fresh unique well-formed txs may only ack OK (admitted)
            # or RETRY_AFTER (per-client/global pressure); DUPLICATE
            # or REJECTED here is an admission-contract breach
            raise Violation(
                "ingress_ack",
                f"fresh tx {tx!r} acked {status.name} on {h}",
                0,
            )
        if want_dup and status is IngressStatus.OK:
            dup = gates[h].submit(client, i, fee, tx)
            if IngressStatus(dup.status) is not IngressStatus.DUPLICATE:
                raise Violation(
                    "ingress_dedup",
                    f"resubmit of OK-acked tx {tx!r} acked "
                    f"{IngressStatus(dup.status).name}, want DUPLICATE",
                    0,
                )


def _ingress_audit(
    cluster,
    honest: List[str],
    ok_acked: Dict[bytes, str],
    rounds_used: int,
) -> Optional[dict]:
    """The band's terminal invariant: every acked-and-
    unevicted tx settles EXACTLY once.  Concretely, on the reference
    honest ledger (agreement already holds, so any honest node is
    every honest node): no tx settles twice (the settle-time dedup
    layer), and the OK-acked txs missing from the ledger are exactly
    accounted by the honest mempools' eviction counters — an OK ack
    is a promise: settle, or evict VISIBLY.  A tx stranded pending
    (liveness hole) is unsettled-but-unevicted and fails the same
    equation, so the standard liveness tail is subsumed.  Finally a
    subscribe(0) replay on the reference node must stream the settled
    epochs gap- and duplicate-free."""
    nodes = cluster.nodes
    ref = nodes[honest[0]]
    counts: Dict[bytes, int] = {}
    for batch in ref.committed_batches:
        for tx in batch.tx_list():
            counts[tx] = counts.get(tx, 0) + 1
    for tx, c in counts.items():
        if c > 1:
            return {
                "invariant": "ingress_exact_once",
                "detail": f"tx {tx!r} settled {c} times",
                "round": rounds_used,
            }
    lost = sorted(tx for tx in ok_acked if tx not in counts)
    evicted = sum(
        nodes[h].mempool.stats()["evicted"]
        for h in honest
        if nodes[h].mempool is not None
    )
    if len(lost) != evicted:
        return {
            "invariant": "ingress_exact_once",
            "detail": (
                f"{len(lost)} OK-acked txs unsettled vs {evicted} "
                f"visible evictions"
            ),
            "round": rounds_used,
        }
    gate = cluster.ingress(honest[0])
    feed = gate.subscribe(0)
    got: List[int] = []
    while True:
        batch = gate.next_batch(feed, timeout=0.05)
        if batch is None:
            break
        got.append(batch.epoch)
    feed.close()
    if got != list(range(len(ref.committed_batches))):
        return {
            "invariant": "ingress_replay",
            "detail": (
                f"subscribe(0) streamed epochs {got}, want "
                f"0..{len(ref.committed_batches) - 1} contiguous"
            ),
            "round": rounds_used,
        }
    return None


def _reduced_audit(
    cluster, bad: List[str], rounds_used: int
) -> Optional[dict]:
    """The reduced-quorum band's terminal invariants.

    1. No false accusations: counter-fork evidence only ever
       accumulates against coalition members — an honest sender's
       vault never refuses, so an accusation of one would mean forged
       evidence (or an honest equivocation, either being a bug).
    2. Detection: every coalition equivocator whose vault actually
       refused a forked slot is in the evidence directory — its
       self-incriminating refused=1 frames reached at least one
       honest receiver and were recorded (the coalition's wire
       faults can drop SOME frames, but a lie the protocol plane
       kept retrying cannot stay invisible for a whole run).
    3. Exactly-once settle: on the reference honest ledger no tx
       settles twice — the n-f quorum arithmetic must not weaken the
       dedup/commit rule at n = 2f+1.
    """
    dirc = cluster.attest_dir
    false_accused = sorted(dirc.accused - set(bad))
    if false_accused:
        return {
            "invariant": "attest_no_false_accusation",
            "detail": f"honest nodes accused of forks: {false_accused}",
            "round": rounds_used,
        }
    undetected = sorted(
        nid
        for nid in bad
        if getattr(cluster.auths.get(nid), "vault", None) is not None
        and cluster.auths[nid].vault.refusals > 0
        and nid not in dirc.accused
    )
    if undetected:
        return {
            "invariant": "attest_fork_detection",
            "detail": (
                f"equivocators forked attested slots undetected: "
                f"{undetected}"
            ),
            "round": rounds_used,
        }
    ref = next(
        cluster.nodes[nid]
        for nid in sorted(cluster.nodes)
        if nid not in bad
    )
    counts: Dict[bytes, int] = {}
    for batch in ref.committed_batches:
        for tx in batch.tx_list():
            counts[tx] = counts.get(tx, 0) + 1
    dups = sorted(tx for tx, c in counts.items() if c > 1)
    if dups:
        return {
            "invariant": "reduced_exact_once",
            "detail": f"txs settled more than once: {dups[:4]}",
            "round": rounds_used,
        }
    return None


def run_schedule(
    schedule: dict,
    trace_path: Optional[str] = None,
    crypto: str = Config.crypto_backend,
    device: str = Config.device,
    ledgers: Optional[Dict[str, List[bytes]]] = None,
) -> Optional[dict]:
    """Execute one schedule; returns the violation report dict, or
    None if every invariant held.  With ``trace_path`` the run records
    a flight-recorder artifact (written whether or not it fails).
    ``crypto``/``device`` pick the cluster's crypto backend; a given
    ``ledgers`` dict receives each honest node's committed ledger-body
    bytes, one entry an epoch."""
    cluster = _build_cluster(
        schedule, trace=trace_path is not None, crypto=crypto, device=device
    )
    bad = set(schedule["bad"])
    honest = [nid for nid in cluster.ids if nid not in bad]
    ing = schedule.get("ingress")
    submitted: set = set()
    ok_acked: Dict[bytes, str] = {}
    if ing is None:
        for i in range(schedule["txs"]):
            tx = b"fuzz-%06d" % i
            cluster.nodes[honest[i % len(honest)]].add_transaction(tx)
            submitted.add(tx)

    by_round: Dict[int, List[dict]] = {}
    for ev in schedule["timeline"]:
        by_round.setdefault(ev["round"], []).append(ev)

    def before_round(r: int) -> None:
        for ev in by_round.get(r, ()):
            _apply_event(cluster, ev)

    def on_quiescence(r: int) -> None:
        # recomputed per round: a reconfig event adds joiners (honest
        # by construction) to the cluster mid-run
        cur = [nid for nid in sorted(cluster.nodes) if nid not in bad]
        _check_safety(cluster, cur, submitted, r)

    violation: Optional[dict] = None
    rounds_used = schedule["rounds"]
    try:
        if ing is not None:
            # client-ingress band: submission IS part of the schedule
            # under test (ack-contract violations shrink like any
            # other), so it runs inside the violation scope
            _ingress_submit(cluster, honest, schedule, submitted,
                            ok_acked)
        rounds_used = run_until_drained(
            cluster.net,
            cluster.nodes,
            skip=bad,
            max_rounds=schedule["rounds"],
            before_round=before_round,
            on_quiescence=on_quiescence,
        )
    except Violation as v:
        violation = v.report
    if violation is None and ing is not None:
        # the band's terminal check replaces the standard liveness
        # tail: settle-exactly-once subsumes it (a stranded pending tx
        # is unsettled-but-unevicted and fails the accounting)
        final = [
            nid
            for nid in sorted(cluster.nodes)
            if nid not in bad and not cluster.nodes[nid]._retired_self
        ]
        violation = _ingress_audit(cluster, final, ok_acked,
                                   rounds_used)
    elif violation is None and schedule.get("check_liveness", True):
        # liveness spans the roster change: every honest node that is
        # (still) a member at the end — original members AND joiners —
        # must hold every submitted tx.  A retired honest node stops
        # at its activation boundary by design, so it is exempt from
        # the tail (the sampler only retires coalition members, but
        # the rule is stated generally for hand-written schedules).
        final = [
            nid
            for nid in sorted(cluster.nodes)
            if nid not in bad and not cluster.nodes[nid]._retired_self
        ]
        for h in final:
            committed = {
                tx
                for b in cluster.nodes[h].merged_batches
                for tx in b.tx_list()
            }
            missing = submitted - committed
            if missing or cluster.nodes[h].pending_tx_count():
                violation = {
                    "invariant": "liveness",
                    "detail": (
                        f"{h} missing {len(missing)} submitted txs "
                        f"after {rounds_used} rounds"
                    ),
                    "round": rounds_used,
                }
                break
    if violation is None and schedule.get("reduced"):
        # the band's extra terminal invariants: fork evidence only
        # against the coalition, every actual equivocation detected,
        # settle-exactly-once at n = 2f+1
        violation = _reduced_audit(
            cluster, schedule["bad"], rounds_used
        )
    if trace_path is not None:
        cluster.write_trace(trace_path)
    if ledgers is not None:
        for nid in sorted(cluster.nodes):
            if nid not in bad:
                ledgers[nid] = [
                    encode_batch_body(e, b)
                    for e, b in enumerate(cluster.nodes[nid].committed_batches)
                ]
    return violation


# ---------------------------------------------------------------------------
# shrinking + repro files
# ---------------------------------------------------------------------------


def shrink(
    schedule: dict,
    violation: Optional[dict] = None,
    crypto: str = Config.crypto_backend,
    device: str = Config.device,
):
    """Greedily minimize a failing schedule: drop timeline events,
    wire stages and behaviors one at a time (keeping any removal that
    still fails), then halve txs and rounds.  Returns
    ``(minimal_schedule, violation)``.

    A candidate is kept only if it violates the SAME invariant as the
    original failure — otherwise e.g. halving the round budget under a
    mounted delay fault could manufacture an unrelated 'liveness'
    artifact and the shrinker would happily minimize that instead of
    the real bug.  Deterministic — the candidate order is fixed — and
    terminates because every accepted edit strictly shrinks the
    schedule.  Pass the already-observed ``violation`` to skip the
    redundant confirming run.  Every run takes ``crypto``/``device``."""

    def run(cand: dict) -> Optional[dict]:
        return run_schedule(cand, crypto=crypto, device=device)

    base_v = violation if violation is not None else run(schedule)
    if base_v is None:
        raise ValueError("shrink() needs a failing schedule")
    want = base_v["invariant"]

    def still_fails(cand: dict) -> Optional[dict]:
        v = run(cand)
        return v if v is not None and v["invariant"] == want else None

    cur = copy.deepcopy(schedule)
    cur_v = base_v
    changed = True
    while changed:
        changed = False
        for key in ("timeline", "wire", "behaviors"):
            i = 0
            while i < len(cur[key]):
                cand = copy.deepcopy(cur)
                del cand[key][i]
                v = still_fails(cand)
                if v is not None:
                    cur, cur_v = cand, v
                    changed = True
                else:
                    i += 1
        for field, floor in (("txs", 1), ("rounds", 2)):
            while cur[field] > floor:
                cand = copy.deepcopy(cur)
                cand[field] = max(floor, cur[field] // 2)
                v = still_fails(cand)
                if v is None:
                    break
                cur, cur_v = cand, v
                changed = True
    return cur, cur_v


def write_repro(
    path: str, schedule: dict, violation: dict
) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(
            {"schedule": schedule, "violation": violation},
            fh,
            indent=2,
            sort_keys=True,
        )
        fh.write("\n")


def load_repro(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _parse_seeds(spec: str) -> List[int]:
    """"0:20" -> [0..19]; "3,7,11" -> [3, 7, 11]; "5" -> [5]."""
    if ":" in spec:
        lo, hi = spec.split(":", 1)
        return list(range(int(lo), int(hi)))
    return [int(s) for s in spec.replace(",", " ").split()]


def fuzz_seeds(
    seeds: Sequence[int],
    n: int = 4,
    rounds: int = 12,
    out_dir: Optional[str] = None,
    trace: bool = True,
    reconfig: bool = False,
    pipeline_depth: Optional[int] = None,
    wan: bool = False,
    wan_profile: Optional[str] = None,
    ingress: bool = False,
    reduced: bool = False,
    lanes: bool = False,
    crypto: str = Config.crypto_backend,
    device: str = Config.device,
) -> int:
    """Run a schedule per seed (on ``crypto``/``device``); on the first violation, shrink it and
    emit a repro file plus (by default) a flight-recorder trace
    artifact of the minimal failing run.  Returns a process exit code
    (0 = every invariant held on every seed)."""
    import pathlib

    for seed in seeds:
        schedule = sample_schedule(
            seed,
            n=n,
            rounds=rounds,
            reconfig=reconfig,
            pipeline_depth=pipeline_depth,
            wan=wan,
            wan_profile=wan_profile,
            ingress=ingress,
            reduced=reduced,
            lanes=lanes,
        )
        violation = run_schedule(schedule, crypto=crypto, device=device)
        if violation is None:
            print(f"seed {seed:6d}: ok")
            continue
        print(f"seed {seed:6d}: VIOLATION {violation['invariant']}")
        minimal, final = shrink(schedule, violation, crypto=crypto, device=device)
        out = pathlib.Path(out_dir or ".")
        out.mkdir(parents=True, exist_ok=True)
        repro_path = out / f"fuzz_repro_seed{seed}.json"
        write_repro(str(repro_path), minimal, final)
        print(f"  minimal repro -> {repro_path}")
        if trace:
            trace_path = out / f"fuzz_repro_seed{seed}.trace.json"
            run_schedule(
                minimal, trace_path=str(trace_path), crypto=crypto, device=device
            )
            print(f"  flight-recorder artifact -> {trace_path}")
        return 1
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="cleisthenes_tpu_torch.tools.fuzz",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--seeds", help="seed range lo:hi or list a,b,c")
    ap.add_argument("--seed", type=int, help="single seed")
    ap.add_argument("--n", type=int, default=4, help="cluster size")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument(
        "--reconfig",
        action="store_true",
        help="dynamic-membership band: compose a join/retire "
        "reconfig event into every sampled schedule",
    )
    ap.add_argument(
        "--pipeline-depth",
        type=int,
        default=None,
        help="pin the K-deep protocol-plane window "
        "(Config.pipeline_depth) in every sampled schedule; "
        "default draws depth from the seed",
    )
    ap.add_argument(
        "--wan",
        action="store_true",
        help="WAN band: mount a seeded link-delay profile "
        "(transport.wan.PROFILES) drawn from each seed, appended "
        "LAST so historical seed streams extend",
    )
    ap.add_argument(
        "--wan-profile",
        default=None,
        help="pin one named WAN profile instead of drawing it from "
        "the seed (implies --wan)",
    )
    ap.add_argument(
        "--ingress",
        action="store_true",
        help="client-ingress band: submit every tx "
        "through the in-proc ingress twin + fee-priority mempool "
        "with a seeded client/fee/dup schedule, appended LAST so "
        "historical seed streams extend; gates the "
        "settle-exactly-once invariant",
    )
    ap.add_argument(
        "--reduced-quorum",
        action="store_true",
        help="reduced-quorum band: attested sender log + "
        "n-f quorum arithmetic on 2f+1-shaped rosters drawn from "
        "{3,5,7} at f=(n-1)//2, coalition restricted to wire/crash "
        "faults + the Equivocator; gates the fork-evidence, "
        "no-false-accusation and settle-exactly-once invariants",
    )
    ap.add_argument(
        "--lanes",
        action="store_true",
        help="lane shard-out band: draw Config.lanes "
        "from {2,3,4} per seed, appended LAST so historical seed "
        "streams extend; gates the merge-determinism and "
        "cross-lane settle-exactly-once invariants",
    )
    ap.add_argument(
        "--crypto",
        default=Config.crypto_backend,
        choices=("cuda", "cpu", "cpp"),
        help="crypto backend of every run (default: the card's)",
    )
    ap.add_argument(
        "--device",
        default=Config.device,
        help="torch device of the 'cuda' backend ('cuda[:N]', or 'cpu' "
        "for the kernels' plain versions)",
    )
    ap.add_argument(
        "--show", action="store_true", help="print the schedule, no run"
    )
    ap.add_argument("--repro", help="replay a repro file")
    ap.add_argument("--out", help="directory for repro artifacts")
    ap.add_argument(
        "--no-trace",
        action="store_true",
        help="skip the flight-recorder artifact for failing runs",
    )
    args = ap.parse_args(argv)

    if args.repro:
        rep = load_repro(args.repro)
        violation = run_schedule(
            rep["schedule"], crypto=args.crypto, device=args.device
        )
        want = rep.get("violation")
        print(f"replayed: {violation}")
        if violation is None:
            print("repro no longer triggers a violation")
            return 1
        if want and violation["invariant"] != want["invariant"]:
            print(f"violation changed (recorded: {want})")
            return 1
        return 0

    if args.seed is not None:
        seeds: List[int] = [args.seed]
    elif args.seeds:
        seeds = _parse_seeds(args.seeds)
    else:
        ap.error("need --seed, --seeds or --repro")
        return 2

    wan = args.wan or args.wan_profile is not None
    if args.show:  # print the sampled schedule(s), run nothing
        for seed in seeds:
            schedule = sample_schedule(
                seed, n=args.n, rounds=args.rounds,
                reconfig=args.reconfig,
                pipeline_depth=args.pipeline_depth,
                wan=wan,
                wan_profile=args.wan_profile,
                ingress=args.ingress,
                reduced=args.reduced_quorum,
                lanes=args.lanes,
            )
            json.dump(schedule, sys.stdout, indent=2, sort_keys=True)
            print()
        return 0
    return fuzz_seeds(
        seeds,
        n=args.n,
        rounds=args.rounds,
        out_dir=args.out,
        trace=not args.no_trace,
        reconfig=args.reconfig,
        pipeline_depth=args.pipeline_depth,
        wan=wan,
        wan_profile=args.wan_profile,
        ingress=args.ingress,
        reduced=args.reduced_quorum,
        lanes=args.lanes,
        crypto=args.crypto,
        device=args.device,
    )


if __name__ == "__main__":
    sys.exit(main())
