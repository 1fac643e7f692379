"""Determinism-plane helpers: audited entropy routing + lock
annotations.

This module is the ONLY sanctioned doorway between the determinism
plane (protocol/, core/, ops/ — everything whose state can reach wire
or ledger bytes) and OS entropy / concurrency hazards:

- ``proposal_rng`` centralizes the ``config.seed is None ->
  SystemRandom`` branch.  Production keeps batch sampling unpredictable
  (HBBFT's censorship-resistance story needs it); a seed makes every
  node's sampling a pure function of (seed, node_id) so replays and
  cross-PYTHONHASHSEED runs commit byte-identical ledgers.  Plane code
  must call this instead of touching ``random`` directly — the
  staticcheck DET001 rule enforces exactly that.
- ``guarded_by`` declares which instance attributes a class's lock
  protects.  By default it is a *declaration*, not a runtime wrapper
  (no per-access overhead on hot paths): the metadata lands on the
  class as ``__guarded_by__`` for tests/tooling, and the staticcheck
  CONC001/CONC003 rules statically require every access to sit inside
  ``with self.<lock>:`` (methods named ``*_locked`` assert the caller
  already holds it).  With ``CLEISTHENES_LOCKCHECK=1`` the SAME
  registry arms the runtime sanitizer (utils/lockcheck.py): the
  decorator installs per-access lock assertions, so the contract is
  either statically proven or dynamically watched — never merely
  commented.

utils/ sits OUTSIDE the determinism plane precisely so this module can
legally touch ``random.SystemRandom`` — one audited site instead of N
scattered ones.
"""

from __future__ import annotations

import random
from typing import Dict, Optional

from cleisthenes_tpu_torch.utils import lockcheck


def proposal_rng(seed: Optional[int], node_id: str) -> random.Random:
    """The audited seed->entropy fork for batch sampling.

    ``seed=None`` (production): OS-CSPRNG-backed SystemRandom —
    proposal contents stay unpredictable to an adversary watching the
    wire.  With a seed: a per-node deterministic stream keyed by
    (seed, node_id), so no two nodes share a stream yet every replay
    matches (Config.seed docs).
    """
    if seed is None:
        return random.SystemRandom()
    return random.Random(f"{seed}|{node_id}")


def wan_rng(seed: Optional[int], *lane: str) -> random.Random:
    """The audited entropy fork for the WAN emulation plane
    (transport/wan.py — in the determinism plane: its draws decide
    delivery order, which decides ledger bytes under a seeded
    schedule).

    Every independent stream in the emulator — one per link, one per
    node straggler process — names itself with a ``lane`` tuple, e.g.
    ``wan_rng(seed, "link", sender, receiver)``.  Keying streams by
    name (not by creation order) makes the whole plane insensitive to
    lazy-construction order: a link first touched by a metrics scrape
    draws the same delays as one first touched by a frame.

    ``seed=None`` (production): SystemRandom — emulated delays are
    unpredictable, replay is not claimed.  With a seed: a pure
    function of (seed, lane), byte-identical across processes and
    PYTHONHASHSEED values.
    """
    if seed is None:
        return random.SystemRandom()
    return random.Random(f"{seed}|wan|{'|'.join(lane)}")


def guarded_by(lock_attr: str, *attrs: str):
    """Class decorator declaring ``attrs`` as protected by
    ``self.<lock_attr>``.

    Stacks/merges across multiple decorators (a class may hold several
    locks).  The declaration is enforced statically by staticcheck's
    CONC001/CONC003 rules; at runtime it records
    ``cls.__guarded_by__ = {attr: lock_attr}`` so tests can assert
    coverage — and, when the lock sanitizer is armed
    (``CLEISTHENES_LOCKCHECK=1``), installs per-access held-lock
    assertions over exactly that registry (utils/lockcheck.py).
    """
    if not attrs:
        raise ValueError("guarded_by needs at least one attribute name")

    def deco(cls):
        merged: Dict[str, str] = dict(getattr(cls, "__guarded_by__", {}))
        for a in attrs:
            merged[a] = lock_attr
        cls.__guarded_by__ = merged
        if lockcheck.is_enabled():
            lockcheck.install(cls)
        return cls

    return deco


__all__ = ["proposal_rng", "wan_rng", "guarded_by"]
