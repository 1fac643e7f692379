"""SLO watchdogs: the plane that watches a *running* validator.

The flight recorder explains a finished run; the dial layer's
health tracker sees only sockets.  Nothing watched the protocol-level
SLOs — "are we still committing?", "is the queue runaway?", "is a peer
being starved/left behind?" — which is exactly what a per-link
omission adversary (protocol.byzantine.SelectiveMute) or a silent
partition exploits.  This module is that watcher, three detectors per
node:

- **epoch_stall**: no commit within a budget *derived from the node's
  own recent epoch p50* (``max(grace, factor * p50)``) while work is
  pending.  Self-calibrating: an N=128 cluster with 3 s epochs gets a
  proportionally longer leash than a 4-node demo, with the grace floor
  covering cold starts before any p50 exists.
- **queue_backpressure**: pending transactions above a configured
  depth — ingress outrunning commit throughput.
- **peer_lag**: any peer reported DOWN by the transport health
  tracker, or (in-proc clusters) any peer whose epoch frontier trails
  the roster's by more than a configured gap.
- **settle_stall**: the two-frontier commit split
  (Config.order_then_settle) has its ordered frontier sitting at the
  ``decrypt_lag_max`` backpressure bound — ciphertext ordering is
  parked because plaintext settlement stopped trailing it (e.g. a
  share-forging coalition delaying the decryption exchange).  Flips
  DEGRADED, not DOWN: ordering holds safely at the bound.

Each firing increments a monotonic alert counter, records the reason,
and emits a trace instant (category ``alert``) so alerts land on the
merged timeline next to the protocol events that explain them.
Detector state folds into ``Metrics.snapshot()["alerts"]`` and drives
the /healthz verdict: DOWN on an active stall, DEGRADED on any other
active alert or non-UP peer, UP otherwise.

Determinism: the watchdog lives in utils/ (outside the determinism
plane), reads protocol state only through provider callables, and
writes NOTHING back — protocol code never branches on watchdog state.
``check(now=...)`` takes a synthetic clock so fault tests fire
detectors without sleeping.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from cleisthenes_tpu_torch.utils.determinism import guarded_by
from cleisthenes_tpu_torch.utils.lockcheck import new_lock
from cleisthenes_tpu_torch.utils.metrics import Metrics

UP = "up"
DEGRADED = "degraded"
DOWN = "down"
# a peer-LINK state (not a health verdict): the transport reports the
# peer alive but inside a WAN straggler episode.  Counts as non-UP for
# the DEGRADED scan, never as DOWN — a slow honest node is the one
# failure mode a BFT watchdog must not escalate.
STRAGGLING = "straggling"

# detector names (the ``alert=`` label vocabulary of the exposition)
EPOCH_STALL = "epoch_stall"
QUEUE_BACKPRESSURE = "queue_backpressure"
PEER_LAG = "peer_lag"
SETTLE_STALL = "settle_stall"


class _Alert:
    __slots__ = ("name", "count", "active", "reason")

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0  # lifetime firings (inactive -> active edges)
        self.active = False
        self.reason = ""


@guarded_by("_lock", "_alerts")
class SloWatchdog:
    """One node's detector set.  Thread-safe: ``check`` runs on the
    sampler tick thread and on every HTTP scrape, while
    ``Metrics.snapshot`` reads ``alerts_block`` from arbitrary
    callers."""

    def __init__(
        self,
        *,
        metrics: Metrics,
        pending_fn: Callable[[], int],
        stall_factor: float = 8.0,
        stall_grace_s: float = 10.0,
        queue_depth_limit: int = 100_000,
        peer_lag_epochs: int = 8,
        peer_states_fn: Optional[Callable[[], Dict[str, object]]] = None,
        peer_lag_fn: Optional[Callable[[], Dict[str, int]]] = None,
        decrypt_lag_budget: int = 4,
        budget_floor_fn: Optional[Callable[[], float]] = None,
        trace=None,
    ) -> None:
        if stall_factor <= 0 or stall_grace_s <= 0:
            raise ValueError(
                f"stall budget needs factor>0 grace>0, got "
                f"{stall_factor}/{stall_grace_s}"
            )
        self._metrics = metrics
        self._pending = pending_fn
        self.stall_factor = stall_factor
        self.stall_grace_s = stall_grace_s
        self.queue_depth_limit = queue_depth_limit
        self.peer_lag_epochs = peer_lag_epochs
        self._peer_states = peer_states_fn
        self._peer_lag = peer_lag_fn
        # the settle-stall SLO budget: ordered - settled at (or past)
        # this bound means the trailing decrypt frontier is wedged and
        # ordering is parked on backpressure.  The natural value is
        # Config.decrypt_lag_max — the same bound the protocol parks
        # at — read via metrics.decrypt_lag_epochs() (zero on the
        # coupled path, so the detector is inert there).
        self.decrypt_lag_budget = decrypt_lag_budget
        # transport-aware leash floor: when the transport
        # prices links like a WAN profile, a p50 self-calibrated on
        # fast epochs must not flip DOWN the moment the tail of the
        # link-delay distribution lands — the floor provider (e.g.
        # WanEmulator.stall_floor_s) raises the budget's lower bound
        # to what the mounted link model can legitimately cost
        self._budget_floor = budget_floor_fn
        self.trace = trace
        self._alerts: Dict[str, _Alert] = {
            name: _Alert(name)
            for name in (
                EPOCH_STALL,
                QUEUE_BACKPRESSURE,
                PEER_LAG,
                SETTLE_STALL,
            )
        }
        self._lock = new_lock()

    # -- detectors ---------------------------------------------------------

    def stall_budget_s(self) -> float:
        """The commit-progress SLO: ``max(grace, factor * epoch p50,
        transport floor)`` — derived from this node's own recent
        latency, so the leash scales with roster size and batch
        weight; the optional transport floor keeps a LAN-calibrated
        p50 from flipping DOWN under WAN-priced links."""
        floor = 0.0
        if self._budget_floor is not None:
            floor = self._budget_floor()
        p50 = self._metrics.epoch_latency.p50
        if p50 is None:
            return max(self.stall_grace_s, floor)
        return max(self.stall_grace_s, self.stall_factor * p50, floor)

    def check(self, now: Optional[float] = None) -> str:
        """Evaluate every detector once; returns the health verdict.
        ``now`` (a monotonic instant) lets tests drive synthetic
        clocks; live callers pass nothing."""
        if now is None:
            # never read back by protocol state (pure observability)
            now = time.monotonic()  # watchdog clock (outside the plane)
        pending = self._pending()
        budget = self.stall_budget_s()
        stalled = (
            pending > 0
            and self._metrics.last_commit_age_s(now) > budget
        )
        self._transition(
            EPOCH_STALL,
            stalled,
            lambda: f"no commit for > {round(budget, 3)}s "
            f"with {pending} txs pending",
        )
        self._transition(
            QUEUE_BACKPRESSURE,
            pending > self.queue_depth_limit,
            lambda: f"{pending} txs pending > limit "
            f"{self.queue_depth_limit}",
        )
        lagging = self._lagging_peers()
        self._transition(
            PEER_LAG,
            bool(lagging),
            lambda: "peers down/lagging: " + ",".join(lagging[:8]),
        )
        decrypt_lag = self._metrics.decrypt_lag_epochs()
        # lag AT the bound alone is the intended steady state of a
        # decrypt-bound node (ordering oscillates at the backpressure
        # bound while settlement streams behind); the alert condition
        # is the bound WITH settlement no longer progressing — same
        # self-calibrating leash as EPOCH_STALL, since settles are
        # commits on the two-frontier path
        self._transition(
            SETTLE_STALL,
            decrypt_lag >= self.decrypt_lag_budget
            and self._metrics.last_commit_age_s(now) > budget,
            lambda: f"ordered frontier {decrypt_lag} epochs ahead of "
            f"settlement (budget {self.decrypt_lag_budget}) with no "
            f"settle for > {round(budget, 3)}s; ordering parked on "
            "decrypt-lag backpressure",
        )
        return self.health()

    def _peer_state_map(self) -> Dict[str, str]:
        """Peer -> link-state string.  The provider may return plain
        strings (gRPC PeerHealthTracker) or per-link dicts with a
        ``state`` field (ChannelNetwork.link_states with its WAN
        model fields) — both transports feed the same detector."""
        if self._peer_states is None:
            return {}
        out: Dict[str, str] = {}
        for peer, state in self._peer_states().items():
            if isinstance(state, dict):
                state = state.get("state", UP)
            out[peer] = str(state)
        return out

    def _lagging_peers(self) -> List[str]:
        out: List[str] = []
        if self._peer_states is not None:
            # DOWN only: a STRAGGLING peer is alive and must degrade,
            # not alert — the epoch-gap clause below still catches it
            # if it genuinely falls behind the roster
            out.extend(
                peer
                for peer, state in sorted(self._peer_state_map().items())
                if state == DOWN
            )
        if self._peer_lag is not None:
            out.extend(
                peer
                for peer, lag in sorted(self._peer_lag().items())
                if lag > self.peer_lag_epochs and peer not in out
            )
        return out

    def _transition(
        self, name: str, active: bool, reason_fn: Callable[[], str]
    ) -> None:
        # reason_fn defers the f-string build to active ticks only:
        # this path runs per scrape and per sampler tick on every node
        fired = False
        reason = ""
        with self._lock:
            alert = self._alerts[name]
            if active:
                reason = reason_fn()
                if not alert.active:
                    alert.count += 1
                    fired = True
                alert.reason = reason
            alert.active = active
        if fired and self.trace is not None:
            # on the node's own timeline, next to the stalled epoch's
            # protocol events (args stay deterministic: no timestamps)
            self.trace.instant("alert", name, reason=reason)

    # -- verdicts ----------------------------------------------------------

    def health(self) -> str:
        """UP / DEGRADED / DOWN from detector + peer state.  An active
        stall is DOWN (the node is not doing its job); every other
        active alert — or any peer not UP — is DEGRADED."""
        with self._lock:
            if self._alerts[EPOCH_STALL].active:
                return DOWN
            degraded = any(a.active for a in self._alerts.values())
        if not degraded and self._peer_states is not None:
            degraded = any(
                state != UP for state in self._peer_state_map().values()
            )
        return DEGRADED if degraded else UP

    def alerts_block(self) -> Dict[str, Dict[str, object]]:
        """The ``Metrics.snapshot()["alerts"]`` block."""
        with self._lock:
            return {
                name: {
                    "count": a.count,
                    "active": a.active,
                    "reason": a.reason,
                }
                for name, a in sorted(self._alerts.items())
            }


def worst_health(verdicts) -> str:
    """Fold many verdicts into one (/healthz over a whole cluster)."""
    order = {UP: 0, DEGRADED: 1, DOWN: 2}
    worst = UP
    for v in verdicts:
        if order.get(v, 2) > order[worst]:
            worst = v
    return worst


__all__ = [
    "UP",
    "DEGRADED",
    "DOWN",
    "STRAGGLING",
    "EPOCH_STALL",
    "QUEUE_BACKPRESSURE",
    "PEER_LAG",
    "SETTLE_STALL",
    "SloWatchdog",
    "worst_health",
]
