"""Seeded WAN emulation plane: per-link delay models on a virtual clock.

Every bench and fuzz band before the WAN plane ran on a same-box
zero-latency ``ChannelNetwork``, so the robustness machinery (stall
watchdogs, CATCHUP, K-deep pipelining) had never been exercised in the
regime HBBFT was designed for: asynchronous WANs with heterogeneous
links.  This module prices every frame's admission into a *virtual*
delivery deadline; the channel scheduler holds the frame invisible
until its seeded virtual clock passes that deadline (see
``ChannelNetwork._wan_release``).  Virtual time never touches wall
time — a ``wan_global`` schedule with 300 ms RTTs still runs at CPU
speed — and every draw routes through ``utils.determinism.wan_rng``
named streams, so a fixed (seed, profile) pair replays byte-identical
ledgers across processes and PYTHONHASHSEED values.

Model, per ordered (sender, receiver) pair (``LinkModel``):

- base RTT drawn once per link from the profile's intra-/inter-region
  range (regions assigned round-robin in registration order);
- per-frame jitter as a seeded fraction of the one-way delay;
- loss as *reliable-transport retransmission delay*: each seeded
  "lost" transmission adds one exponentially-backed-off RTO to the
  deadline.  Frames are never silently dropped — the channel transport
  has no retransmit layer, so a true drop would model a broken TCP
  stack, not a lossy WAN, and would wedge liveness for reasons the
  protocol under test cannot fix;
- a bandwidth cap that serializes frames sharing a link (per-link
  ``busy_until`` in virtual time);
- heavy-tailed straggler episodes: a seeded minority of nodes suffers
  Pareto-distributed slow episodes that multiply the delay of every
  frame they send or receive while active.

The profile matrix (``PROFILES``) is the named scenario vocabulary for
``SimulatedCluster(wan_profile=)``, ``tools/fuzz.py --wan`` and
bench.py's WAN section; docs/FAULTS.md documents what each profile is
meant to catch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

from cleisthenes_tpu_torch.utils.determinism import guarded_by, wan_rng
from cleisthenes_tpu_torch.utils.lockcheck import new_lock

# an episode's Pareto tail is capped so one draw cannot freeze a link
# for the whole schedule (virtual seconds)
_EPISODE_DUR_CAP_S = 120.0
# retransmission attempts are capped: past this the emulated link is
# effectively down for the frame and the accumulated RTOs already
# dominate the deadline
_MAX_RETRANSMITS = 8


@dataclasses.dataclass(frozen=True)
class WanProfile:
    """One named WAN scenario: every knob the link models read."""

    name: str
    regions: Tuple[str, ...]
    intra_rtt_ms: Tuple[float, float]  # base RTT range within a region
    inter_rtt_ms: Tuple[float, float]  # base RTT range across regions
    jitter_frac: float  # per-frame one-way jitter, fraction of base
    loss_p: float  # per-transmission loss probability
    bandwidth_bps: Optional[float]  # link serialization rate, bytes/s
    straggler_fraction: float  # fraction of nodes with episodes
    straggler_gap_s: float  # mean virtual gap between episodes
    straggler_dur_s: float  # episode duration scale (Pareto)
    straggler_alpha: float  # Pareto shape; smaller = heavier tail
    straggler_mult: Tuple[float, float]  # delay multiplier range
    delivery_quantum_ms: float  # co-deadline coalescing window
    stall_floor_s: float  # epoch-stall watchdog budget floor


PROFILES: Dict[str, WanProfile] = {
    # same-rack control: sub-ms RTT, no loss, no stragglers — the
    # regression anchor proving the WAN plane at its floor matches
    # the zero-latency scheduler's protocol outcomes
    "lan": WanProfile(
        name="lan",
        regions=("rack",),
        intra_rtt_ms=(0.2, 0.6),
        inter_rtt_ms=(0.2, 0.6),
        jitter_frac=0.05,
        loss_p=0.0,
        bandwidth_bps=1.25e9,
        straggler_fraction=0.0,
        straggler_gap_s=1.0,
        straggler_dur_s=0.1,
        straggler_alpha=2.0,
        straggler_mult=(1.0, 1.0),
        delivery_quantum_ms=0.1,
        stall_floor_s=2.0,
    ),
    # three continents, clean links: the canonical geo-replication
    # deployment — exercises RTT heterogeneity (intra vs inter gap)
    # and the partition/heal scenarios between region blocks
    "wan_3region": WanProfile(
        name="wan_3region",
        regions=("us-east", "eu-west", "ap-south"),
        intra_rtt_ms=(1.0, 3.0),
        inter_rtt_ms=(30.0, 120.0),
        jitter_frac=0.10,
        loss_p=0.002,
        bandwidth_bps=1.25e7,
        straggler_fraction=0.0,
        straggler_gap_s=10.0,
        straggler_dur_s=1.0,
        straggler_alpha=1.5,
        straggler_mult=(1.0, 1.0),
        delivery_quantum_ms=5.0,
        stall_floor_s=8.0,
    ),
    # five regions, long tails, thin pipes, mild stragglers: the
    # worst realistic envelope — bandwidth serialization starts to
    # matter for batched frames
    "wan_global": WanProfile(
        name="wan_global",
        regions=("us-east", "us-west", "eu-west", "ap-south", "ap-east"),
        intra_rtt_ms=(2.0, 5.0),
        inter_rtt_ms=(80.0, 320.0),
        jitter_frac=0.20,
        loss_p=0.01,
        bandwidth_bps=2.5e6,
        straggler_fraction=0.2,
        straggler_gap_s=20.0,
        straggler_dur_s=2.0,
        straggler_alpha=1.5,
        straggler_mult=(2.0, 8.0),
        delivery_quantum_ms=10.0,
        stall_floor_s=20.0,
    ),
    # moderate RTTs, but a seeded minority of nodes hits heavy-tailed
    # slow episodes (alpha 1.1: infinite-variance durations) with
    # 10-100x delay multipliers — the watchdog-calibration scenario:
    # epoch-stall must not flip DOWN while the honest majority makes
    # progress, and a straggling-but-alive peer must read DEGRADED
    "straggler_tail": WanProfile(
        name="straggler_tail",
        regions=("us-east", "eu-west"),
        intra_rtt_ms=(1.0, 3.0),
        inter_rtt_ms=(20.0, 60.0),
        jitter_frac=0.10,
        loss_p=0.001,
        bandwidth_bps=1.25e7,
        straggler_fraction=0.3,
        straggler_gap_s=5.0,
        straggler_dur_s=1.0,
        straggler_alpha=1.1,
        straggler_mult=(10.0, 100.0),
        delivery_quantum_ms=5.0,
        stall_floor_s=30.0,
    ),
    # 5% per-transmission loss on thin links: retransmission delay
    # dominates — exercises the RBC echo/ready paths and CATCHUP under
    # pervasive delay variance rather than topology
    "lossy": WanProfile(
        name="lossy",
        regions=("us-east", "eu-west"),
        intra_rtt_ms=(1.0, 3.0),
        inter_rtt_ms=(10.0, 40.0),
        jitter_frac=0.15,
        loss_p=0.05,
        bandwidth_bps=5e6,
        straggler_fraction=0.0,
        straggler_gap_s=10.0,
        straggler_dur_s=1.0,
        straggler_alpha=1.5,
        straggler_mult=(1.0, 1.0),
        delivery_quantum_ms=2.0,
        stall_floor_s=10.0,
    ),
}


def wan_profile_names() -> Tuple[str, ...]:
    """Sorted profile names — the seed-draw vocabulary for fuzz."""
    return tuple(sorted(PROFILES))


class _Straggler:
    """One node's heavy-tailed slow-episode process in virtual time.

    Episodes are generated lazily as the clock advances: Pareto
    durations (capped), uniform delay multipliers, exponential gaps.
    The whole trajectory is a pure function of the node's named rng
    stream, independent of how often it is sampled.
    """

    __slots__ = ("rng", "profile", "episode_until", "mult", "next_start", "episodes")

    def __init__(self, rng, profile: WanProfile) -> None:
        self.rng = rng
        self.profile = profile
        self.episode_until = 0.0
        self.mult = 1.0
        self.next_start = rng.expovariate(1.0 / profile.straggler_gap_s)
        self.episodes = 0

    def multiplier(self, now: float) -> float:
        p = self.profile
        while self.next_start <= now:
            dur = min(
                p.straggler_dur_s * self.rng.paretovariate(p.straggler_alpha),
                _EPISODE_DUR_CAP_S,
            )
            self.episode_until = self.next_start + dur
            self.mult = self.rng.uniform(*p.straggler_mult)
            self.episodes += 1
            self.next_start = self.episode_until + self.rng.expovariate(
                1.0 / p.straggler_gap_s
            )
        return self.mult if now < self.episode_until else 1.0

    def active(self, now: float) -> bool:
        self.multiplier(now)  # advance the process to ``now``
        return now < self.episode_until


class LinkModel:
    """Delay state for one ordered (sender, receiver) pair."""

    __slots__ = ("rng", "rtt_s", "busy_until")

    def __init__(self, profile: WanProfile, same_region: bool, rng) -> None:
        lo, hi = (
            profile.intra_rtt_ms if same_region else profile.inter_rtt_ms
        )
        self.rng = rng
        self.rtt_s = rng.uniform(lo, hi) / 1e3
        self.busy_until = 0.0  # bandwidth serialization horizon


@guarded_by("_lock", "_links", "_regions", "_stragglers")
class WanEmulator:
    """The virtual clock + the lazy per-link / per-node model maps.

    Owned by ``ChannelNetwork``; the scheduler calls ``admit`` at
    enqueue time and ``advance`` when the visible queue drains.  All
    state is keyed by name (node id, ordered pair), never by
    construction order, so observability reads cannot perturb replay.

    The lazy model maps are guarded: ``admit`` runs on the scheduler
    thread while ``stats``/``link_info`` serve the metrics scrape
    thread, and an unguarded lazy fill racing a scrape iteration is a
    dict-mutation error at best and a silently forked model at worst
    (the interprocedural lock sweep surfaced exactly this).  The
    virtual clock and the two delay counters stay unguarded: they are
    scalar monotone values read opportunistically by observers.
    """

    def __init__(
        self,
        profile: Union[str, WanProfile],
        seed: Optional[int],
    ) -> None:
        if isinstance(profile, str):
            try:
                profile = PROFILES[profile]
            except KeyError:
                raise ValueError(
                    f"unknown WAN profile {profile!r}; "
                    f"known: {', '.join(wan_profile_names())}"
                ) from None
        self.profile = profile
        self._seed = seed
        self.now = 0.0  # the virtual clock (seconds)
        self._lock = new_lock()
        self._links: Dict[Tuple[str, str], LinkModel] = {}
        self._regions: Dict[str, str] = {}
        self._stragglers: Dict[str, Optional[_Straggler]] = {}
        self.frames_delayed = 0
        self.retransmits = 0

    # -- topology ------------------------------------------------------

    def _register_locked(self, node_id: str) -> None:
        if node_id not in self._regions:
            regions = self.profile.regions
            self._regions[node_id] = regions[len(self._regions) % len(regions)]

    def register(self, node_id: str) -> None:
        """Assign ``node_id`` a region, round-robin in registration
        order (ChannelNetwork.join order — sorted ids for every
        driver in the tree, so the mapping is schedule-stable)."""
        with self._lock:
            self._register_locked(node_id)

    def _region_of_locked(self, node_id: str) -> str:
        self._register_locked(node_id)
        return self._regions[node_id]

    def region_of(self, node_id: str) -> str:
        with self._lock:
            return self._region_of_locked(node_id)

    def _link_locked(self, sender: str, receiver: str) -> LinkModel:
        key = (sender, receiver)
        link = self._links.get(key)
        if link is None:
            same = self._region_of_locked(
                sender
            ) == self._region_of_locked(receiver)
            link = LinkModel(
                self.profile,
                same,
                wan_rng(self._seed, "link", sender, receiver),
            )
            self._links[key] = link
        return link

    def _straggler_locked(self, node_id: str) -> Optional[_Straggler]:
        if node_id not in self._stragglers:
            p = self.profile
            rng = wan_rng(self._seed, "straggler", node_id)
            picked = (
                p.straggler_fraction > 0.0
                and rng.random() < p.straggler_fraction
            )
            self._stragglers[node_id] = _Straggler(rng, p) if picked else None
        return self._stragglers[node_id]

    # -- the pricing model ---------------------------------------------

    def admit(self, sender: str, receiver: str, nbytes: int) -> float:
        """Price one frame: the virtual time at which it becomes
        visible to the delivery scheduler."""
        p = self.profile
        now = self.now
        with self._lock:
            link = self._link_locked(sender, receiver)
            owd = (link.rtt_s / 2.0) * (
                1.0 + p.jitter_frac * link.rng.random()
            )
            if p.loss_p > 0.0:
                # reliable-transport retransmission: every seeded loss
                # adds one RTO, doubling (TCP-ish) up to the cap
                rto = max(2.0 * link.rtt_s, 0.01)
                lost = 0
                while (
                    lost < _MAX_RETRANSMITS
                    and link.rng.random() < p.loss_p
                ):
                    owd += rto
                    rto *= 2.0
                    lost += 1
                self.retransmits += lost
            start = now
            if p.bandwidth_bps:
                # frames sharing a link serialize behind its horizon
                start = max(now, link.busy_until) + nbytes / p.bandwidth_bps
                link.busy_until = start
            mult = 1.0
            s = self._straggler_locked(sender)
            if s is not None:
                mult = s.multiplier(now)
            r = self._straggler_locked(receiver)
            if r is not None:
                mult = max(mult, r.multiplier(now))
        ready = start + owd * mult
        if ready > now:
            self.frames_delayed += 1
        return ready

    def advance(self, t: float) -> None:
        """Move the virtual clock forward (never backward)."""
        if t > self.now:
            self.now = t

    # -- observability -------------------------------------------------

    def link_info(self, sender: str, receiver: str) -> Dict[str, object]:
        """One link's model state for ``ChannelNetwork.link_states``:
        base rtt_ms, the profile loss probability, and whether either
        endpoint is inside a straggler episode right now."""
        with self._lock:
            link = self._link_locked(sender, receiver)
            straggling = False
            for node in (sender, receiver):
                s = self._straggler_locked(node)
                if s is not None and s.active(self.now):
                    straggling = True
                    break
        return {
            "rtt_ms": link.rtt_s * 1e3,
            "loss": self.profile.loss_p,
            "straggling": straggling,
        }

    def stall_floor_s(self) -> float:
        """The epoch-stall watchdog budget floor this profile needs:
        a cold-start p50 measured on a LAN must not flip DOWN when the
        deployment's links are priced like this profile's."""
        return self.profile.stall_floor_s

    def stats(self) -> Dict[str, object]:
        """The ``Metrics.snapshot()["wan"]`` provider payload."""
        with self._lock:
            episodes = sum(
                s.episodes
                for s in self._stragglers.values()
                if s is not None
            )
        return {
            "enabled": 1,
            "profile": self.profile.name,
            "frames_delayed": self.frames_delayed,
            "retransmits": self.retransmits,
            "straggler_episodes": episodes,
            "virtual_time_ms": int(self.now * 1e3),
        }


__all__ = [
    "LinkModel",
    "PROFILES",
    "WanEmulator",
    "WanProfile",
    "wan_profile_names",
]
