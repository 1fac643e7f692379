"""SimulatedCluster: N in-proc validators in one call.

The reference tests multi-node behavior by hand-wiring mock streams
(its test/mock/stream.go pattern); this module packages the equivalent
— and everything this framework adds on top — as a first-class API:

    cluster = SimulatedCluster(n=16, batch_size=1024, seed=7)
    cluster.submit(b"tx-1"); cluster.submit(b"tx-2")
    cluster.run_epochs()                  # drive to quiescence
    batches = cluster.committed()         # identical on every node

One call builds the roster keys (trusted dealer), the deterministic
ChannelNetwork (optionally seeded = adversarial scheduler), pairwise
MAC authenticators, and — by default — a cluster-SHARED CryptoHub, so
every wave flush executes the whole roster's crypto in single batched
device dispatches (the north star's "vmaps them across all N
validators' shards at once"; essential on a device where per-dispatch
round-trips dominate).  ``shared_hub=False``
reverts to per-node hubs, the shape of a real multi-host deployment.

Fault injection passes straight through to the network: ``crash``,
``partition``, ``fault_filter`` (utils.adversary.Coalition), plus the
SEMANTIC adversary seam: ``behaviors={node_id: Behavior}`` mounts
protocol-level malicious behaviors (protocol.byzantine — equivocation,
split voting, share forgery...) on chosen nodes, composable with the
wire-level filters on the same run.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core.batch import Batch
from cleisthenes_tpu_torch.ops.backend import get_backend
from cleisthenes_tpu_torch.protocol.attest import (
    AttestationDirectory,
    AttestingAuthenticator,
)
from cleisthenes_tpu_torch.protocol.honeybadger import HoneyBadger, setup_keys
from cleisthenes_tpu_torch.protocol.hub import CryptoHub
from cleisthenes_tpu_torch.transport.base import HmacAuthenticator
from cleisthenes_tpu_torch.transport.broadcast import ChannelBroadcaster
from cleisthenes_tpu_torch.transport.channel import ChannelNetwork


def run_until_drained(
    net,
    nodes: Dict[str, HoneyBadger],
    *,
    skip: Sequence[str] = (),
    max_rounds: int = 50,
    before_round: Optional[Callable[[int], None]] = None,
    on_quiescence: Optional[Callable[[int], None]] = None,
) -> int:
    """THE propose-and-drain loop: each round starts an epoch on every
    non-skipped node, drives the network to quiescence, and stops once
    every non-skipped queue is empty (or ``max_rounds`` pass).  Returns
    the rounds used.

    This is the quiescence helper that used to be copy-pasted across
    the Byzantine test modules; ``SimulatedCluster.run_until_drained``
    and ``tools/fuzz.py`` both drive through it.  ``before_round``
    (fault-timeline injection) runs before each round's proposals;
    ``on_quiescence`` (invariant checks) runs after each round's drain
    — both may raise to abort the run.
    """
    for r in range(max_rounds):
        if before_round is not None:
            before_round(r)
        for nid, hb in nodes.items():
            if nid not in skip:
                hb.start_epoch()
        net.run()
        if on_quiescence is not None:
            on_quiescence(r)
        if all(
            hb.pending_tx_count() == 0 and _lanes_merged(hb)
            for nid, hb in nodes.items()
            if nid not in skip
        ):
            return r + 1
    return max_rounds


def _lanes_merged(hb: HoneyBadger) -> bool:
    """Quiescence extension for lane shard-out: every settled lane
    epoch has also merge-emitted (no lane is epochs ahead of a
    sibling, parking merged slots).  Always True at lanes=1; the
    lockstep drive closes any gap within a few more rounds."""
    if hb._merge is None:
        return True
    return hb.merged_settled_frontier == sum(
        len(lane.committed_batches) for lane in hb.lanes
    )


class SimulatedCluster:
    """N HoneyBadger validators over the deterministic in-proc
    transport, with cluster-batched crypto.

    Without ``config`` the roster's crypto runs on ``crypto_backend``
    ('cuda' by default, on the torch ``device`` 'cuda': the card) and
    construction raises on a machine without a GPU; pass
    ``crypto_backend='cpu'`` for the host backend or ``device='cpu'``
    for the kernels' plain PyTorch versions."""

    def __init__(
        self,
        n: int = 4,
        *,
        config: Optional[Config] = None,
        batch_size: int = 256,
        crypto_backend: str = "cuda",
        device: str = "cuda",
        seed: Optional[int] = None,
        key_seed: int = 1,
        auto_propose: bool = True,
        shared_hub: bool = True,
        group=None,
        member_ids: Optional[Sequence[str]] = None,
        behaviors: Optional[Dict[str, object]] = None,
        wal_dir: Optional[str] = None,
        wan_profile: Optional[object] = None,
    ) -> None:
        if config is not None:
            if n != 4 and n != config.n:  # both given and conflicting
                raise ValueError(
                    f"n={n} conflicts with config.n={config.n}; pass one"
                )
            self.config = config
        else:
            self.config = Config(
                n=n,
                batch_size=batch_size,
                crypto_backend=crypto_backend,
                device=device,
            )
        if member_ids is None:
            member_ids = [f"node{i:03d}" for i in range(self.config.n)]
        self.ids: List[str] = sorted(member_ids)
        self._key_seed = key_seed
        self.keys = setup_keys(self.config, self.ids, seed=key_seed,
                               group=group)
        # wan_profile: a name from transport.wan.PROFILES
        # (or a WanProfile) mounts the seeded link-delay model on the
        # channel scheduler — geo-realistic delivery schedules priced
        # on a virtual clock, still byte-identical for a fixed seed
        self.net = ChannelNetwork(
            seed=seed,
            delivery_columnar=self.config.delivery_columnar,
            wave_routing=self.config.wave_routing,
            egress_columnar=self.config.egress_columnar,
            wan_profile=wan_profile,
        )
        # dedup=True: the shared hub verifies each distinct pure crypto
        # check ONCE for the whole roster (see CryptoHub docstring) —
        # the in-proc stand-in for N real hosts verifying in parallel
        hub = (
            CryptoHub(get_backend(self.config), dedup=True)
            if shared_hub
            else None
        )
        # tracing (Config.trace): a cluster-shared hub's flushes serve
        # the whole roster, so they record on a dedicated "hub" track
        # rather than any one node's timeline; per-node hubs
        # (shared_hub=False) inherit their owner's recorder inside
        # HoneyBadger.  tools/tracetool.py merges all tracks.
        self.hub_trace = None
        if hub is not None and self.config.trace:
            from cleisthenes_tpu_torch.utils.trace import maybe_recorder

            self.hub_trace = maybe_recorder(self.config, "hub")
            hub.trace = self.hub_trace
        # same rationale as dedup above: N in-proc nodes re-parse the
        # identical decrypted blobs; per-node deployments pass None.
        # Instance-scoped and shared across THIS cluster's nodes only
        # (dies with the cluster — never process-global state).
        from cleisthenes_tpu_torch.protocol.honeybadger import make_tx_parse_memo

        tx_memo = make_tx_parse_memo() if shared_hub else None
        behaviors = behaviors or {}
        unknown = sorted(set(behaviors) - set(self.ids))
        if unknown:
            raise ValueError(f"behaviors for non-members: {unknown}")
        self.behaviors = behaviors
        self.nodes: Dict[str, HoneyBadger] = {}
        self._hub = hub
        self._tx_memo = tx_memo
        self._auto_propose = auto_propose
        # authenticators are kept per node: dynamic membership
        # installs joiner pair keys / drops retirees through them
        self.auths: Dict[str, HmacAuthenticator] = {}
        # attested sender log (Config.attested_log): the cluster holds
        # the directory — the in-proc stand-in for each node's sealed
        # TEE NVRAM.  Vault state (counters, slots) survives
        # restart_node() with an incarnation bump, exactly the
        # monotonicity a real attested counter must keep across
        # process restarts; fork evidence aggregates here too.
        self.attest_dir = (
            AttestationDirectory()
            if self.config.attested_log
            else None
        )
        # optional per-node durable WALs (crash/restart tests):
        # wal_dir/<node>.log, restored by restart_node()
        self._wal_dir = wal_dir
        # per-node construction parameters, so restart_node() rebuilds
        # a process-restart-faithful node (same genesis view; the WAL
        # replay re-derives any roster versions it lived through)
        self._node_params: Dict[str, dict] = {}
        for nid in self.ids:
            auth = self._make_auth(nid, self.keys[nid].mac_keys)
            self.auths[nid] = auth
            self._node_params[nid] = {
                "config": self.config,
                "member_ids": list(self.ids),
                "joining": False,
                "roster_version_base": 0,
            }
            hb = HoneyBadger(
                config=self.config,
                node_id=nid,
                member_ids=self.ids,
                keys=self.keys[nid],
                out=ChannelBroadcaster(self.net, nid, self.ids),
                auto_propose=auto_propose,
                hub=hub,
                tx_parse_memo=tx_memo,
                behavior=behaviors.get(nid),
                authenticator=auth,
                batch_log=self._make_wal(nid),
            )
            self.nodes[nid] = hb
            self.net.join(nid, hb, auth)
            # public route to MAC-rejection/delivery counts:
            # Metrics.snapshot()["transport"]
            hb.metrics.set_transport_stats(
                lambda nid=nid: self.net.endpoint_stats(nid)
            )
            if self.net.wan is not None:
                hb.metrics.set_wan_stats(self.net.wan.stats)
        self._rr = 0  # submit() round-robin cursor
        # lazily-built per-node ingress planes (see ingress())
        self._ingress_planes: Dict[str, object] = {}
        # SLO watchdog plane (utils/watchdog.py): one per node, peer
        # state from the channel network's fault view (crash/partition)
        # and peer LAG from the epoch frontiers the in-proc cluster can
        # see directly.  Alert counters fold into each node's
        # Metrics.snapshot()["alerts"]; cluster.health() is the
        # worst-of verdict.
        from cleisthenes_tpu_torch.utils.watchdog import SloWatchdog

        self.watchdogs: Dict[str, SloWatchdog] = {}
        for nid in self.ids:
            wd = SloWatchdog(
                metrics=self.nodes[nid].metrics,
                pending_fn=self.nodes[nid].outstanding_tx_count,
                stall_factor=self.config.slo_stall_factor,
                stall_grace_s=self.config.slo_stall_grace_s,
                queue_depth_limit=self.config.slo_queue_depth,
                peer_lag_epochs=self.config.slo_peer_lag_epochs,
                peer_states_fn=lambda nid=nid: self.net.link_states(nid),
                peer_lag_fn=lambda nid=nid: self._peer_lag(nid),
                decrypt_lag_budget=self.config.decrypt_lag_max,
                budget_floor_fn=self._wan_floor,
                trace=self.nodes[nid].trace,
            )
            self.nodes[nid].metrics.set_alerts(wd.alerts_block)
            self.watchdogs[nid] = wd
        # live telemetry endpoints (Config.obs_port): ONE server fronts
        # the whole roster, each sample labeled node="..." — started
        # eagerly (there is no listen() phase on the in-proc cluster).
        # Each node gets a bounded-ring sampler (utils/timeseries.py);
        # the sampler threads only READ thread-safe metrics, so the
        # deterministic scheduler is unaffected.
        self.obs = None
        self.samplers: Dict[str, object] = {}
        if self.config.obs_port is not None:
            from cleisthenes_tpu_torch.transport.obs_http import (
                ObsServer,
                ObsTarget,
            )
            from cleisthenes_tpu_torch.utils.timeseries import TimeSeriesSampler

            targets = []
            for nid in self.ids:
                sampler = TimeSeriesSampler(self.nodes[nid].metrics.snapshot)
                sampler.on_tick(self.watchdogs[nid].check)
                sampler.start(self.config.obs_sample_period_s)
                self.samplers[nid] = sampler
                targets.append(
                    ObsTarget(
                        nid,
                        self.nodes[nid].metrics,
                        self.watchdogs[nid],
                        sampler,
                    )
                )
            self.obs = ObsServer(targets, port=self.config.obs_port)
            self.obs.start()

    # -- application surface ----------------------------------------------

    def submit(self, tx: bytes, node_id: Optional[str] = None) -> None:
        """Queue a transaction at ``node_id`` (default: round-robin)."""
        if node_id is None:
            node_id = self.ids[self._rr % len(self.ids)]
            self._rr += 1
        self.nodes[node_id].add_transaction(tx)

    def pending(self) -> int:
        return sum(hb.pending_tx_count() for hb in self.nodes.values())

    def ingress(self, node_id: Optional[str] = None):
        """The in-process twin of the client gRPC surface: an
        ``InProcIngressClient`` over ``node_id``'s IngressPlane
        (transport/ingress.py), round-tripping the identical encoded
        client frames through the identical admission/subscription
        code — minus the sockets.  Needs a mounted mempool
        (Config.mempool_capacity > 0); the plane is built lazily and
        cached per node."""
        from cleisthenes_tpu_torch.transport.ingress import (
            InProcIngressClient,
            IngressPlane,
        )

        nid = node_id or self.ids[0]
        plane = self._ingress_planes.get(nid)
        if plane is None:
            plane = IngressPlane(self.nodes[nid])
            self._ingress_planes[nid] = plane
        return InProcIngressClient(plane)

    def run_until_drained(
        self,
        max_rounds: int = 50,
        skip: Sequence[str] = (),
        before_round: Optional[Callable[[int], None]] = None,
        on_quiescence: Optional[Callable[[int], None]] = None,
    ) -> int:
        """Propose + drain until every live queue is empty (or
        ``max_rounds`` proposal rounds pass); returns rounds used.
        The module-level ``run_until_drained`` over this cluster's
        network and nodes (see its docstring for the callbacks)."""
        return run_until_drained(
            self.net,
            self.nodes,
            skip=skip,
            max_rounds=max_rounds,
            before_round=before_round,
            on_quiescence=on_quiescence,
        )

    # the historical name; both spellings are public API
    run_epochs = run_until_drained

    def committed(self, node_id: Optional[str] = None) -> List[Batch]:
        return list(self.nodes[node_id or self.ids[0]].committed_batches)

    def merged(self, node_id: Optional[str] = None) -> List[Batch]:
        """The MERGED total order (== committed() at lanes=1): the
        cross-lane deterministic ledger every client reads."""
        return list(self.nodes[node_id or self.ids[0]].merged_batches)

    def assert_agreement(self, skip: Sequence[str] = ()) -> int:
        """Every live node committed the identical batch history —
        compared over the MERGED total order, which IS the per-lane
        committed history at lanes=1; returns the common depth."""
        live = {
            nid: hb for nid, hb in self.nodes.items() if nid not in skip
        }
        depth = min(len(hb.merged_batches) for hb in live.values())
        assert depth > 0, "no common committed epoch"
        for e in range(depth):
            lists = {
                tuple(hb.merged_batches[e].tx_list())
                for hb in live.values()
            }
            assert len(lists) == 1, f"fork at merged slot {e}"
        return depth

    def _make_auth(self, nid: str, mac_keys) -> HmacAuthenticator:
        """Build one node's authenticator: plain pairwise-MAC, or —
        under Config.attested_log — the attesting subclass bound to
        the node's vault in the cluster-held directory.  attach()
        bumps the vault incarnation, so a restarted node resumes its
        sender log monotonically instead of re-using sequence
        numbers."""
        if self.attest_dir is None:
            return HmacAuthenticator(nid, mac_keys)
        return AttestingAuthenticator(
            nid, mac_keys, self.attest_dir.attach(nid)
        )

    def _make_wal(self, nid: str):
        if self._wal_dir is None:
            return None
        import os

        from cleisthenes_tpu_torch.core.ledger import BatchLog

        return BatchLog(os.path.join(self._wal_dir, f"{nid}.log"))

    def restart_node(self, nid: str):
        """Process-restart one (crashed) node from its WAL: a FRESH
        HoneyBadger rebuilt with the node's ORIGINAL construction
        parameters replays the log — committed history, ordered-ahead
        window, and every roster version it lived through (the RCFG
        records cross-check the re-derivation) — then rejoins the
        network.  Requires ``wal_dir``."""
        if self._wal_dir is None:
            raise ValueError("restart_node() needs wal_dir")
        old = self.nodes[nid]
        if old.batch_log is not None:
            old.batch_log.close()
        # the old ingress plane (if any) holds the dead node; drop it
        # so the next ingress() call builds one over the restarted node
        stale_plane = self._ingress_planes.pop(nid, None)
        if stale_plane is not None:
            stale_plane.close()
        params = self._node_params[nid]
        auth = self._make_auth(nid, self.keys[nid].mac_keys)
        self.auths[nid] = auth
        hb = HoneyBadger(
            config=params["config"],
            node_id=nid,
            member_ids=params["member_ids"],
            keys=self.keys[nid],
            out=ChannelBroadcaster(
                self.net, nid, params["member_ids"]
            ),
            auto_propose=self._auto_propose,
            hub=self._hub,
            tx_parse_memo=self._tx_memo,
            authenticator=auth,
            joining=params["joining"],
            roster_version_base=params["roster_version_base"],
            batch_log=self._make_wal(nid),
        )
        self.nodes[nid] = hb
        self.net.restart(nid, hb, auth)
        hb.metrics.set_transport_stats(
            lambda nid=nid: self.net.endpoint_stats(nid)
        )
        if self.net.wan is not None:
            hb.metrics.set_wan_stats(self.net.wan.stats)
        # rewire the observability plane to the NEW instance: the old
        # watchdog/sampler closures hold the dead node's metrics and
        # would keep feeding frozen pre-crash state to SLO checks and
        # scrapes
        from cleisthenes_tpu_torch.utils.watchdog import SloWatchdog

        wd = SloWatchdog(
            metrics=hb.metrics,
            pending_fn=hb.outstanding_tx_count,
            stall_factor=self.config.slo_stall_factor,
            stall_grace_s=self.config.slo_stall_grace_s,
            queue_depth_limit=self.config.slo_queue_depth,
            peer_lag_epochs=self.config.slo_peer_lag_epochs,
            peer_states_fn=lambda nid=nid: self.net.link_states(nid),
            peer_lag_fn=lambda nid=nid: self._peer_lag(nid),
            decrypt_lag_budget=self.config.decrypt_lag_max,
            budget_floor_fn=self._wan_floor,
            trace=hb.trace,
        )
        hb.metrics.set_alerts(wd.alerts_block)
        self.watchdogs[nid] = wd
        old_sampler = self.samplers.pop(nid, None)
        if old_sampler is not None:
            from cleisthenes_tpu_torch.transport.obs_http import ObsTarget
            from cleisthenes_tpu_torch.utils.timeseries import (
                TimeSeriesSampler,
            )

            old_sampler.stop()
            sampler = TimeSeriesSampler(hb.metrics.snapshot)
            sampler.on_tick(wd.check)
            sampler.start(self.config.obs_sample_period_s)
            self.samplers[nid] = sampler
            if self.obs is not None:
                fresh = ObsTarget(nid, hb.metrics, wd, sampler)
                for i, t in enumerate(self.obs.targets):
                    if t.node_id == nid:
                        self.obs.targets[i] = fresh
                        break
                else:
                    self.obs.add_target(fresh)
        return hb

    # -- dynamic membership (protocol.reconfig) ----------------------------

    def roster_versions(self) -> Dict[str, int]:
        """Every node's ACTIVE roster version (the convergence check
        reconfig tests assert against)."""
        return {
            nid: hb.roster_version for nid, hb in self.nodes.items()
        }

    def begin_reconfig(
        self,
        join: Sequence[str] = (),
        retire: Sequence[str] = (),
        submit_via: Optional[str] = None,
    ) -> int:
        """Operator surface: construct the joiner nodes, wire them to
        the network, and submit the RECONFIG transaction that starts
        the reshare ceremony.  Returns the new version number.  The
        ceremony itself runs in-band (protocol.reconfig) as the
        cluster keeps draining epochs; activation follows
        automatically once the qualified dealer set commits."""
        from cleisthenes_tpu_torch.protocol import reconfig as rcfg

        # the authoritative current roster is any CURRENT member's
        # latest version (all agree by construction) — a parked
        # retiree from an earlier reconfig still sits in self.nodes
        # but carries no active key material, so it cannot be the
        # source of the roster's public keys
        any_node = None
        for nid in sorted(self.nodes):
            hb = self.nodes[nid]
            if hb.active_view.keys is not None and (
                any_node is None
                or hb.rosters.latest().version
                > any_node.rosters.latest().version
            ):
                any_node = hb
        if any_node is None:
            raise ValueError("no active member to anchor the reconfig")
        latest = any_node.rosters.latest()
        current = list(latest.member_ids)
        version = latest.version + 1
        unknown = sorted(set(retire) - set(current))
        if unknown:
            raise ValueError(f"cannot retire non-members: {unknown}")
        clash = sorted(set(join) & set(current))
        if clash:
            raise ValueError(f"cannot join existing members: {clash}")
        new_ids = sorted((set(current) - set(retire)) | set(join))
        old_view_keys = any_node.active_view.keys
        enroll_pubs: Dict[str, int] = {}
        for jid in sorted(join):
            secret, pub = self._add_joiner(
                jid, version, current, old_view_keys
            )
            enroll_pubs[jid] = pub
        tx = rcfg.encode_reconfig_tx(
            version,
            [(mid, "", 0) for mid in new_ids],
            enroll_pubs,
            any_node.group,
        )
        via = submit_via
        if via is None:  # first member surviving the change
            via = next(m for m in current if m not in set(retire))
        self.nodes[via].add_transaction(tx)
        return version

    def _add_joiner(
        self,
        jid: str,
        version: int,
        current_ids: Sequence[str],
        old_keys,
    ):
        """Construct + wire one JOINER: enrollment keypair (seeded
        off key_seed for replayable tests), bootstrap NodeKeys (public
        threshold keys + DH-derived pair keys, no shares), and a
        ``joining=True`` HoneyBadger attached to the live network."""
        import dataclasses as _dc
        import hashlib as _hashlib

        from cleisthenes_tpu_torch.protocol import reconfig as rcfg
        from cleisthenes_tpu_torch.protocol.honeybadger import NodeKeys
        from cleisthenes_tpu_torch.utils.watchdog import SloWatchdog

        eseed = int.from_bytes(
            _hashlib.sha256(
                b"cluster-enroll|%d|%d|" % (self._key_seed, version)
                + jid.encode("utf-8")
            ).digest()[:8],
            "big",
        )
        secret, pub = rcfg.enrollment_keypair(
            eseed, old_keys.tpke_pub.group
        )
        mac_keys = rcfg.joiner_bootstrap_keys(
            secret, version, old_keys.coin_pub, current_ids, jid
        )
        keys = NodeKeys(
            tpke_pub=old_keys.tpke_pub,
            tpke_share=None,
            coin_pub=old_keys.coin_pub,
            coin_share=None,
            mac_keys=mac_keys,
            enroll_secret=secret,
        )
        jcfg = _dc.replace(self.config, n=len(current_ids), f=None)
        auth = self._make_auth(jid, mac_keys)
        self._node_params[jid] = {
            "config": jcfg,
            "member_ids": list(current_ids),
            "joining": True,
            "roster_version_base": version - 1,
        }
        hb = HoneyBadger(
            config=jcfg,
            node_id=jid,
            member_ids=current_ids,
            keys=keys,
            out=ChannelBroadcaster(self.net, jid, current_ids),
            auto_propose=self._auto_propose,
            hub=self._hub,
            tx_parse_memo=self._tx_memo,
            authenticator=auth,
            joining=True,
            roster_version_base=version - 1,
            batch_log=self._make_wal(jid),
        )
        self.nodes[jid] = hb
        self.auths[jid] = auth
        self.keys[jid] = keys
        self.net.join(jid, hb, auth)
        hb.metrics.set_transport_stats(
            lambda jid=jid: self.net.endpoint_stats(jid)
        )
        if self.net.wan is not None:
            hb.metrics.set_wan_stats(self.net.wan.stats)
        if jid not in self.ids:
            self.ids.append(jid)
            self.ids.sort()
        wd = SloWatchdog(
            metrics=hb.metrics,
            pending_fn=hb.outstanding_tx_count,
            stall_factor=self.config.slo_stall_factor,
            stall_grace_s=self.config.slo_stall_grace_s,
            queue_depth_limit=self.config.slo_queue_depth,
            peer_lag_epochs=self.config.slo_peer_lag_epochs,
            peer_states_fn=lambda jid=jid: self.net.link_states(jid),
            peer_lag_fn=lambda jid=jid: self._peer_lag(jid),
            decrypt_lag_budget=self.config.decrypt_lag_max,
            budget_floor_fn=self._wan_floor,
            trace=hb.trace,
        )
        hb.metrics.set_alerts(wd.alerts_block)
        self.watchdogs[jid] = wd
        if self.obs is not None:
            from cleisthenes_tpu_torch.transport.obs_http import ObsTarget
            from cleisthenes_tpu_torch.utils.timeseries import (
                TimeSeriesSampler,
            )

            sampler = TimeSeriesSampler(hb.metrics.snapshot)
            sampler.on_tick(wd.check)
            sampler.start(self.config.obs_sample_period_s)
            self.samplers[jid] = sampler
            self.obs.add_target(
                ObsTarget(jid, hb.metrics, wd, sampler)
            )
        return secret, pub

    # -- observability (telemetry + SLO surface) ---------------------------

    def _wan_floor(self) -> float:
        """The epoch-stall budget floor the mounted WAN profile needs
        (0 without one) — keeps a p50 self-calibrated on fast local
        epochs from flipping DOWN when the link model's delay tail
        lands (watchdog hardening)."""
        wan = self.net.wan
        return 0.0 if wan is None else wan.stall_floor_s()

    def _peer_lag(self, node_id: str) -> Dict[str, int]:
        """``node_id``'s view of peers trailing its epoch frontier
        (positive gaps only) — the in-proc peer-lag signal: a crashed
        or starved node stops advancing and shows up here on every
        healthy node's watchdog."""
        own = self.nodes[node_id].merged_ordered_frontier
        return {
            nid: own - hb.merged_ordered_frontier
            for nid, hb in self.nodes.items()
            if nid != node_id and own - hb.merged_ordered_frontier > 0
        }

    def health(self) -> Dict[str, object]:
        """Run every node's SLO watchdog checks and return the
        /healthz-shaped verdict: ``{"status": worst, "nodes": {...}}``
        (the convenience accessor tests assert against — no HTTP
        round-trip needed)."""
        from cleisthenes_tpu_torch.utils.watchdog import worst_health

        nodes = {
            nid: self.watchdogs[nid].check() for nid in self.ids
        }
        return {"status": worst_health(nodes.values()), "nodes": nodes}

    def stop(self) -> None:
        """Tear down background observers (the in-proc cluster itself
        has no threads; only the opt-in obs plane does)."""
        for sampler in self.samplers.values():
            sampler.stop()
        if self.obs is not None:
            self.obs.stop()
        for hb in self.nodes.values():
            if hb.batch_log is not None:
                hb.batch_log.close()

    # -- observability (the flight-recorder surface) -----------------------

    def trace_events(self) -> Dict[str, list]:
        """Every node's trace buffer (plus the shared hub's, under
        the key "hub"), for tools/tracetool.py merging.  Empty when
        Config.trace is off."""
        out: Dict[str, list] = {}
        for nid, hb in self.nodes.items():
            if hb.trace is not None:
                out[nid] = hb.trace.events()
        if self.hub_trace is not None:
            out["hub"] = self.hub_trace.events()
        return out

    def write_trace(self, path: str) -> None:
        """Write the merged Chrome-trace-event artifact (Perfetto-
        loadable; see docs/TRACING.md).  Raises if tracing is off —
        an empty artifact would silently hide a misconfiguration."""
        events = self.trace_events()
        if not events:
            raise ValueError(
                "no trace buffers: construct the cluster with "
                "Config(trace=True)"
            )
        from cleisthenes_tpu_torch.utils.trace import write_chrome

        write_chrome(path, events)

    # -- fault injection (delegates to the network) ------------------------

    def crash(self, node_id: str) -> None:
        self.net.crash(node_id)

    def partition(self, a: str, b: str) -> None:
        self.net.partition(a, b)

    @property
    def fault_filter(self):
        return self.net.fault_filter

    @fault_filter.setter
    def fault_filter(self, f) -> None:
        self.net.fault_filter = f


__all__ = ["SimulatedCluster", "run_until_drained"]
