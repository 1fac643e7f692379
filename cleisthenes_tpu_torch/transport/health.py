"""Self-healing dial layer: backoff policy + per-peer health states.

The reference redials never (a lost stream stays lost until process
restart, conn.go:104-128), and a first redial loop that spun at
a fixed interval — the other failure mode: a roster of N validators
hammering a dead peer in lockstep, then reconnect-storming it the
moment it returns.  This module is the middle path, shared by boot
dials and mid-run redials (transport/host.py):

- ``Backoff``: capped exponential delays with seeded jitter.  Jitter
  de-synchronizes the roster's retries; seeding it (Config.seed) keeps
  fault tests replayable.
- ``PeerHealthTracker``: a per-peer UP / DEGRADED / DOWN state machine
  with reconnect counters and the recent delay schedule, surfaced
  through utils.metrics.Metrics.snapshot() as the transport-health
  block — the observability that proves the redial layer is backing
  off rather than spinning.

State machine (per peer):

    UP --stream lost--> DEGRADED --DOWN_AFTER consecutive
    failed dials--> DOWN; any successful dial --> UP (and, when the
    peer was not UP, reconnects += 1).
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

from cleisthenes_tpu_torch.utils.determinism import guarded_by
from cleisthenes_tpu_torch.utils.lockcheck import new_lock

# canonical UP/DEGRADED/DOWN vocabulary lives in utils/watchdog.py;
# dial health and SLO verdicts must stay comparable (host peer states
# feed SloWatchdog._lagging_peers and the /healthz fold)
from cleisthenes_tpu_torch.utils.watchdog import DEGRADED, DOWN, UP

# consecutive failed dials before a DEGRADED peer is declared DOWN
# (it keeps being redialed — DOWN is a reporting state, not a stop)
DOWN_AFTER = 5

# recent dial delays kept per peer (enough to show the backoff curve)
_DELAY_KEEP = 16


class Backoff:
    """Capped exponential backoff with jitter and a stability-gated
    reset.

    ``next_delay()`` returns base * factor^k jittered +/-25% so
    independent retriers spread out, then capped at ``max_s`` —
    ``max_s`` is a HARD bound (operators tune it to bound reconnect
    latency), so the jitter never overshoots it.  Deterministic for a
    seeded ``rng`` (fault tests), OS-random otherwise.

    Re-arming: a bare ``reset()`` re-arms unconditionally, but the
    dial layer must NOT call it on every successful dial — a WAN link
    that flaps (dial lands, stream dies seconds later, repeat) would
    then be re-probed from ``base_s`` forever, hammering the remote at
    base cadence with the cap never reached.
    Instead the owner reports ``note_connected()`` / ``note_lost()``
    and the schedule re-arms only when the connection stayed up for at
    least ``stability_s`` (default: ``max_s`` — a link must survive
    one full max-backoff period to count as healed); a shorter-lived
    success CONTINUES the capped seeded-jitter schedule.
    """

    def __init__(
        self,
        base_s: float,
        max_s: float,
        rng: Optional[random.Random] = None,
        factor: float = 2.0,
        stability_s: Optional[float] = None,
    ) -> None:
        if base_s <= 0 or max_s < base_s:
            raise ValueError(f"backoff needs 0 < base <= max, "
                             f"got base={base_s} max={max_s}")
        self.base_s = base_s
        self.max_s = max_s
        self.factor = factor
        self.stability_s = max_s if stability_s is None else stability_s
        self._rng = rng if rng is not None else random.Random()
        self._cur = base_s
        self._connected_at: Optional[float] = None

    def next_delay(self) -> float:
        d = self._cur
        self._cur = min(self._cur * self.factor, self.max_s)
        return min(d * (0.75 + 0.5 * self._rng.random()), self.max_s)

    def reset(self) -> None:
        self._cur = self.base_s

    def note_connected(self, now: Optional[float] = None) -> None:
        """The dial landed.  Starts the stability clock; does NOT
        re-arm the schedule (see class docstring)."""
        self._connected_at = (
            time.monotonic() if now is None else now
        )

    def note_lost(self, now: Optional[float] = None) -> None:
        """The stream died.  Re-arms the schedule only if the
        connection survived ``stability_s`` — a flap continues the
        capped schedule instead of restarting it."""
        if now is None:
            now = time.monotonic()
        if (
            self._connected_at is not None
            and now - self._connected_at >= self.stability_s
        ):
            self.reset()
        self._connected_at = None


def backoff_rng(seed: Optional[int], node_id: str, peer_id: str) -> random.Random:
    """Jitter source for one (node, peer) dial lane: derived from the
    config seed when set — every retry schedule replays — and from OS
    entropy in production (Config.seed docs)."""
    if seed is None:
        return random.Random()
    return random.Random(f"{seed}|{node_id}|{peer_id}|dial")


class _PeerHealth:
    __slots__ = (
        "state",
        "ever_up",
        "reconnects",
        "dial_attempts",
        "dial_failures",
        "consecutive_failures",
        "recent_delays",
        "since",
    )

    def __init__(self) -> None:
        self.state = DEGRADED  # not connected until the first dial lands
        self.ever_up = False
        self.reconnects = 0  # successful re-establishments after a loss
        self.dial_attempts = 0
        self.dial_failures = 0
        self.consecutive_failures = 0
        self.recent_delays: List[float] = []
        self.since = time.monotonic()

    def _enter(self, state: str) -> None:
        if state != self.state:
            self.state = state
            self.since = time.monotonic()


@guarded_by("_lock", "_peers", "_retired")
class PeerHealthTracker:
    """Thread-safe per-peer health registry for one validator host.

    Writers are the dial paths (connect loop, redial threads, stream
    loss callbacks) and the retirement path (dynamic membership);
    readers are Metrics.snapshot() and tests.
    """

    def __init__(self, peer_ids=()) -> None:
        self._peers: Dict[str, _PeerHealth] = {
            p: _PeerHealth() for p in peer_ids
        }
        # peers removed from the roster (RECONFIG retirement): their
        # health rows are dropped from snapshots and every later dial
        # event for them is ignored — without the flag, a racing
        # redial thread's dial_failed() would silently resurrect the
        # row and the backoff loop would hammer a host that is GONE,
        # forever (the redial-storm the retirement satellite kills)
        self._retired: set = set()
        self._lock = new_lock()

    def _peer_locked(self, peer_id: str) -> _PeerHealth:
        """Lookup-or-create; caller holds ``_lock`` (CONC001 naming
        contract)."""
        ph = self._peers.get(peer_id)
        if ph is None:
            ph = self._peers[peer_id] = _PeerHealth()
        return ph

    def retire(self, peer_id: str) -> None:
        """Peer left the roster: drop its health state and ignore
        every later dial event for it.  Idempotent."""
        with self._lock:
            self._retired.add(peer_id)
            self._peers.pop(peer_id, None)

    def readmit(self, peer_id: str) -> None:
        """Un-retire: a later RECONFIG re-admitted the id.  The peer
        starts from a fresh (DEGRADED-until-dialed) health row, like
        any new joiner."""
        with self._lock:
            self._retired.discard(peer_id)

    def is_retired(self, peer_id: str) -> bool:
        """Dial loops poll this to cancel their backoff (a retired
        peer must stop generating redial storms)."""
        with self._lock:
            return peer_id in self._retired

    def dial_scheduled(self, peer_id: str, delay_s: float) -> None:
        """A redial was scheduled ``delay_s`` in the future: record the
        backoff curve (the anti-spinning evidence)."""
        with self._lock:
            if peer_id in self._retired:
                return
            ph = self._peer_locked(peer_id)
            ph.recent_delays.append(delay_s)
            del ph.recent_delays[:-_DELAY_KEEP]

    def dial_started(self, peer_id: str) -> None:
        with self._lock:
            if peer_id in self._retired:
                return
            self._peer_locked(peer_id).dial_attempts += 1

    def dial_failed(self, peer_id: str) -> None:
        with self._lock:
            if peer_id in self._retired:
                return
            ph = self._peer_locked(peer_id)
            ph.dial_failures += 1
            ph.consecutive_failures += 1
            ph._enter(
                DOWN
                if ph.consecutive_failures >= DOWN_AFTER
                else DEGRADED
            )

    def connected(self, peer_id: str) -> None:
        with self._lock:
            if peer_id in self._retired:
                return
            ph = self._peer_locked(peer_id)
            if ph.ever_up and ph.state != UP:
                # re-establishment, not the boot-time first connect
                ph.reconnects += 1
            ph.ever_up = True
            ph.consecutive_failures = 0
            ph._enter(UP)

    def stream_lost(self, peer_id: str) -> None:
        with self._lock:
            if peer_id in self._retired:
                return
            ph = self._peer_locked(peer_id)
            ph._enter(DEGRADED)

    def state(self, peer_id: str) -> str:
        with self._lock:
            if peer_id in self._retired:
                return DOWN  # reported, never re-created
            return self._peer_locked(peer_id).state

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Per-peer health block for Metrics.snapshot()."""
        now = time.monotonic()
        with self._lock:
            return {
                peer: {
                    "state": ph.state,
                    "reconnects": ph.reconnects,
                    "dial_attempts": ph.dial_attempts,
                    "dial_failures": ph.dial_failures,
                    "consecutive_failures": ph.consecutive_failures,
                    "recent_delays_s": list(ph.recent_delays),
                    "state_age_s": round(now - ph.since, 3),
                }
                for peer, ph in self._peers.items()
            }


__all__ = [
    "UP",
    "DEGRADED",
    "DOWN",
    "DOWN_AFTER",
    "Backoff",
    "backoff_rng",
    "PeerHealthTracker",
]
