"""Byzantine adversary toolkit for the in-proc transport.

SURVEY.md §5.3: the reference has no fault-injection framework and its
mock stream is "the natural injection point".  Here that idea is a
library of composable message-level adversaries for
``ChannelNetwork.fault_filter``, modeling a Byzantine coalition that
fully controls the traffic *of the faulty nodes* (the HBBFT threat
model: f arbitrary nodes, reliable channels between correct ones):

  - drop: lose a fraction of the coalition's messages
  - tamper: flip bytes (caught by envelope MACs)
  - duplicate: deliver the coalition's frames multiple times
  - replay: capture ANY node's frames and re-inject them later
    (valid MACs — the protocol's per-sender dedup must absorb them)
  - delay: hold the coalition's frames and release them much later
  - reorder: permute nearby frames of one (sender, receiver) pair

All randomness is seeded so every adversarial run replays exactly.

These stages attack the WIRE: everything here is absorbed by envelope
MACs and per-sender dedup.  The attacks the MAC layer explicitly does
NOT cover — a key-holding node lying to each peer separately — live
one layer up in ``protocol.byzantine`` (see docs/FAULTS.md).
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional, Sequence


class Coalition:
    """Composable fault filter builder for a set of Byzantine senders."""

    def __init__(self, members: Sequence[str], seed: int = 0):
        self.members = frozenset(members)
        self._rng = random.Random(seed)
        # stages: fn(sender, receiver, wire) -> list of frames
        self._stages: List[Callable] = []
        # replay capture: a seeded RESERVOIR over the whole run (not
        # the first N frames — see replay()); separate rng so capture
        # draws never perturb the stage randomness stream
        self._captured: List[bytes] = []
        self._capture_cap = 4096
        self._capture_seen = 0
        self._capture_rng = random.Random(seed ^ 0x5EED0)
        self._wants_capture = False
        # delay stage state: filter-call clock + held frames
        # (release_at, sender, receiver, frame), release bounded so a
        # pathological build-up cannot grow without bound
        self._calls = 0
        self._held: List[tuple] = []
        self._held_cap = 4096
        self.held_total = 0  # observability: frames ever delayed
        self.released_total = 0

    # -- builders ----------------------------------------------------------

    def drop(self, fraction: float) -> "Coalition":
        def stage(sender, receiver, frames):
            return [
                f for f in frames if self._rng.random() >= fraction
            ]

        self._stages.append(stage)
        return self

    def tamper(self, fraction: float) -> "Coalition":
        def stage(sender, receiver, frames):
            out = []
            for f in frames:
                if self._rng.random() < fraction and len(f) > 8:
                    i = self._rng.randrange(8, len(f))
                    f = f[:i] + bytes([f[i] ^ 0xFF]) + f[i + 1 :]
                out.append(f)
            return out

        self._stages.append(stage)
        return self

    def duplicate(self, fraction: float, copies: int = 2) -> "Coalition":
        def stage(sender, receiver, frames):
            out = []
            for f in frames:
                n = copies if self._rng.random() < fraction else 1
                out.extend([f] * n)
            return out

        self._stages.append(stage)
        return self

    def delay(self, fraction: float, hold: int = 16) -> "Coalition":
        """Hold a fraction of the coalition's frames and release them
        much later: a held frame re-enters delivery on the first
        ``filter`` call for the SAME (sender, receiver) pair at least
        ``hold`` filter calls in the future (pairwise envelope MACs
        make cross-pair release pointless — the receiver would just
        reject the frame).  Releases ride the filter-call clock, not
        wall time, so seeded runs replay exactly.  Frames whose pair
        never speaks again within the run simply stay held — in an
        asynchronous network an arbitrarily-delayed frame and a lost
        frame are indistinguishable."""

        def stage(sender, receiver, frames):
            out = []
            for f in frames:
                if self._rng.random() < fraction and (
                    len(self._held) < self._held_cap
                ):
                    self._held.append(
                        (self._calls + hold, sender, receiver, f)
                    )
                    self.held_total += 1
                else:
                    out.append(f)
            return out

        self._stages.append(stage)
        return self

    def reorder(self, fraction: float, window: int = 4) -> "Coalition":
        """Permute the delivery order of nearby coalition frames.

        A held frame waits for the next passing frame of the SAME
        (sender, receiver) pair, then the whole group — held frames
        plus the current one — is released in a seeded-shuffled order
        (pairwise envelope MACs make cross-pair reordering pointless:
        the receiver would just reject the frame).  ``window`` caps how
        many frames one pair can hold at once, bounding both memory and
        how far out of order a frame can arrive.  Frames still held
        when the pair last speaks stay held — in an asynchronous
        network an arbitrarily-delayed frame and a lost frame are
        indistinguishable (same caveat as ``delay``).  Seeded and
        replay-exact like every other stage.
        """
        held: dict = {}  # (sender, receiver) -> [frame, ...]

        def stage(sender, receiver, frames):
            out: List[bytes] = []
            key = (sender, receiver)
            buf = held.get(key)
            if buf is None:
                buf = held[key] = []
            for f in frames:
                if len(buf) < window and self._rng.random() < fraction:
                    buf.append(f)
                    self.held_total += 1
                elif buf:
                    group = buf + [f]
                    self._rng.shuffle(group)
                    out.extend(group)
                    self.released_total += len(buf)
                    del buf[:]
                else:
                    out.append(f)
            return out

        self._stages.append(stage)
        return self

    def _release_matured(self, sender: str, receiver: str) -> List[bytes]:
        """Held frames for this (sender, receiver) pair whose clock
        matured; removed from the hold queue."""
        if not self._held:
            return []
        out: List[bytes] = []
        kept: List[tuple] = []
        for item in self._held:
            release_at, s, r, f = item
            if s == sender and r == receiver and release_at <= self._calls:
                out.append(f)
            else:
                kept.append(item)
        if out:
            self._held = kept
            self.released_total += len(out)
        return out

    def replay(self, fraction: float) -> "Coalition":
        """Re-inject previously captured (any-sender) frames alongside
        the coalition's own traffic.

        Capture is a seeded RESERVOIR sample over every frame of the
        run, not the first ``_capture_cap`` frames: a first-N capture
        never sampled late-run traffic, so replay attacks could only
        ever resend epoch-0-era frames (the capture-bias fix)."""

        self._wants_capture = True

        def stage(sender, receiver, frames):
            out = list(frames)
            if self._captured and self._rng.random() < fraction:
                out.append(self._rng.choice(self._captured))
            return out

        self._stages.append(stage)
        return self

    def _capture(self, wire: bytes) -> None:
        """Algorithm-R reservoir: every frame of the run has equal
        probability ``cap/seen`` of being resident when replay picks."""
        self._capture_seen += 1
        if len(self._captured) < self._capture_cap:
            self._captured.append(wire)
            return
        j = self._capture_rng.randrange(self._capture_seen)
        if j < self._capture_cap:
            self._captured[j] = wire

    # -- the ChannelNetwork hook -------------------------------------------

    def filter(self, sender: str, receiver: str, wire: bytes):
        # capture everything (for replay), mutate only coalition traffic
        self._calls += 1
        if self._wants_capture:
            self._capture(wire)
        if sender not in self.members:
            return wire
        frames: List[bytes] = [wire]
        for stage in self._stages:
            frames = stage(sender, receiver, frames)
            if not frames:
                break
        # matured delayed frames for this pair rejoin delivery even if
        # the current frame itself was dropped/held
        frames = list(frames) + self._release_matured(sender, receiver)
        if not frames:
            return None
        return frames


__all__ = ["Coalition"]
