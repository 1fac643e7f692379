"""Semantic Byzantine adversaries: protocol-level lies under valid MACs.

The wire-level toolkit (``utils.adversary.Coalition``) attacks below
the MAC line — drop/tamper/duplicate/replay/delay/reorder of frames —
and everything it does is absorbed by envelope MACs and per-sender
dedup.  The one attack class the MAC layer explicitly does NOT cover
is a KEY-HOLDING node that "lies to each peer separately"
(transport/base.py HmacAuthenticator docstring): every frame it emits
verifies, yet the protocol content is malicious.  That is the
canonical BFT adversary (HBBFT's threat model is f *arbitrary* nodes),
and this module is its library:

  - ``Equivocator``    conflicting RBC VAL/ECHO proposals per receiver
  - ``SplitVoter``     conflicting BVAL/AUX votes per receiver per round
  - ``BadDealer``      structurally-valid wrong shards / Merkle branches
  - ``ShareForger``    well-formed but wrong TPKE / coin shares
  - ``SelectiveMute``  per-receiver silence (lying by omission)
  - ``EpochSprayer``   far-future epoch spam against the demux window

Injection point: a ``Behavior`` plugs into one node via the
``behavior=`` seam on ``HoneyBadger`` (and through it
``SimulatedCluster`` / ``ValidatorHost``).  The seam sits BETWEEN the
protocol instances and the outbound coalescer — every payload the node
emits is offered to the behavior once per receiver, so a lie can
differ per peer while still riding the normal envelope/MAC/bundling
path.  Behaviors compose with each other (``CompositeBehavior``) and
with wire-level ``Coalition`` filters on the same run.

All behaviors are seeded: a seeded cluster + seeded behaviors + seeded
scheduler replays the identical adversarial run (the property
``tools/fuzz.py`` builds its shrinking repros on).
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence

from cleisthenes_tpu_torch.transport.message import (
    BbaPayload,
    BbaType,
    CatchupRespPayload,
    CoinPayload,
    DecSharePayload,
    RbcPayload,
    RbcType,
)

# how many per-epoch alternate proposals an Equivocator keeps alive
_ALT_EPOCH_CAP = 8


class Behavior:
    """One node's seeded malicious payload rewriter.

    Subclasses override ``rewrite(receiver, payload)`` and may return:
      - the payload unchanged (honest for this receiver),
      - a DIFFERENT payload (the lie),
      - ``None`` (suppress — lie by omission),
      - a list of payloads (inject extras alongside the original).

    ``attach(node)`` is called once by the HoneyBadger that hosts the
    behavior, giving it the node's identity, roster, config and crypto
    backend (an insider adversary holds all of those by definition).
    """

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self.rng = random.Random(seed)
        self.node = None
        self.rewrites = 0  # observability: lies actually told

    def attach(self, node) -> None:
        self.node = node
        self._attached()

    def _attached(self) -> None:
        """Subclass hook: runs once self.node is set."""

    def rewrite(self, receiver: str, payload):
        return payload

    # -- helpers -----------------------------------------------------------

    def split(self, fraction: float = 0.5) -> frozenset:
        """Seeded peer subset — the side the node lies TO.  Never
        includes the node itself (its self-delivery stays honest, as a
        real equivocator would keep its own state consistent)."""
        peers = [m for m in self.node.members if m != self.node.node_id]
        k = min(len(peers), max(1, round(len(peers) * fraction)))
        return frozenset(self.rng.sample(peers, k))


class BehaviorBroadcaster:
    """The seam: sits between one Byzantine node's protocol plane and
    its outbound coalescer, offering every payload to the behavior once
    per receiver.  Receivers are visited in sorted-roster order, so a
    seeded behavior's rng stream is deterministic."""

    def __init__(self, inner, member_ids: Sequence[str], behavior) -> None:
        self._inner = inner
        self._members: List[str] = sorted(member_ids)
        self._behavior = behavior

    def set_members(self, member_ids: Sequence[str]) -> None:
        """Roster-activation support (dynamic membership): the
        behavior keeps lying to whatever the CURRENT fan-out set is."""
        self._members = sorted(member_ids)

    def broadcast(self, payload) -> None:
        for member in self._members:
            self._send(member, payload)

    def send_to(self, member_id: str, payload) -> None:
        self._send(member_id, payload)

    def _send(self, member_id: str, payload) -> None:
        out = self._behavior.rewrite(member_id, payload)
        if out is None:
            return
        if isinstance(out, list):
            for p in out:
                self._inner.send_to(member_id, p)
        else:
            self._inner.send_to(member_id, out)


class Equivocator(Behavior):
    """Propose value A to one half of the roster and value B to the
    other — the textbook equivocation RBC exists to neutralize.

    For the node's OWN RBC instance, VAL and ECHO payloads to the
    seeded "B side" are rebuilt from a second, fully valid proposal:
    real RS shards, real Merkle tree, correct branch for the receiver's
    shard index.  Every frame verifies; the two sides just see
    irreconcilable roots.  A correct RBC must then either deliver ONE
    of the values everywhere or deliver nowhere (and ACS votes the
    proposer out) — never fork.
    """

    def _attached(self) -> None:
        self.side_b = self.split()
        self._alt: Dict[int, tuple] = {}  # epoch -> (tree, shards)

    def _alt_tree(self, epoch: int):
        ent = self._alt.get(epoch)
        if ent is None:
            from cleisthenes_tpu_torch.ops.payload import split_payload

            node = self.node
            value = b"equivocation|%d|" % epoch + bytes(
                self.rng.randrange(256) for _ in range(64)
            )
            data = split_payload(value, node.config.data_shards)
            shards = node.crypto.erasure.encode(data)
            tree = node.crypto.merkle.build(shards)
            ent = (tree, shards)
            self._alt[epoch] = ent
            while len(self._alt) > _ALT_EPOCH_CAP:
                del self._alt[min(self._alt)]
        return ent

    def rewrite(self, receiver: str, payload):
        if (
            payload.__class__ is RbcPayload
            and payload.type in (RbcType.VAL, RbcType.ECHO)
            and payload.proposer == self.node.node_id
            and receiver in self.side_b
        ):
            tree, shards = self._alt_tree(payload.epoch)
            j = payload.shard_index
            self.rewrites += 1
            return RbcPayload(
                type=payload.type,
                proposer=payload.proposer,
                epoch=payload.epoch,
                root_hash=tree.root,
                branch=tuple(tree.branch(j)),
                shard=shards[j].tobytes(),
                shard_index=j,
            )
        return payload


class SplitVoter(Behavior):
    """Vote BVAL/AUX(v) to one half of the roster and (not v) to the
    other, every BBA round of every instance — the agreement-splitting
    attack the 2f+1 thresholds and the common coin exist for."""

    def _attached(self) -> None:
        self.side_b = self.split()

    def rewrite(self, receiver: str, payload):
        if (
            payload.__class__ is BbaPayload
            and payload.type in (BbaType.BVAL, BbaType.AUX)
            and receiver in self.side_b
        ):
            self.rewrites += 1
            return payload._replace(value=not payload.value)
        return payload


class BadDealer(Behavior):
    """A proposer that deals STRUCTURALLY valid but cryptographically
    wrong erasure shards / Merkle branches for its own instance:
    correct lengths, correct branch shape, correct root — the shard
    bytes or one branch sibling are garbage.  The receiver's batched
    branch verification must burn the slot (one vote per sender) and
    the roster must still converge on the honest echoes."""

    def _attached(self) -> None:
        self.side_b = self.split()

    def rewrite(self, receiver: str, payload):
        if (
            payload.__class__ is RbcPayload
            and payload.type in (RbcType.VAL, RbcType.ECHO)
            and payload.proposer == self.node.node_id
            and receiver in self.side_b
        ):
            self.rewrites += 1
            if payload.branch and self.rng.random() < 0.5:
                # corrupt one sibling hash: right shape, wrong proof
                i = self.rng.randrange(len(payload.branch))
                branch = tuple(
                    bytes(32) if k == i else b
                    for k, b in enumerate(payload.branch)
                )
                return payload._replace(branch=branch)
            shard = bytes(b ^ 0xA5 for b in payload.shard)
            return payload._replace(shard=shard)
        return payload


class ShareForger(Behavior):
    """Broadcast well-formed but WRONG threshold shares: valid Shamir
    index, in-range field elements, garbage value.  Coin shares attack
    BBA liveness (a forged share in the f+1 subset fails the batched
    CP verification and must burn without wedging the reveal); TPKE
    decryption shares attack the optimistic combine (bad tag must flip
    the proposer onto the CP-verified path)."""

    def __init__(
        self, seed: int = 0, kinds: Sequence[str] = ("coin", "dec")
    ) -> None:
        super().__init__(seed)
        self.kinds = tuple(kinds)

    def _attached(self) -> None:
        self.side_b = self.split()

    def _forge(self, d: int) -> int:
        forged = d ^ self.rng.randrange(2, 1 << 64)
        return forged if forged > 1 else 12345

    def rewrite(self, receiver: str, payload):
        cls = payload.__class__
        if (
            (cls is CoinPayload and "coin" in self.kinds)
            or (cls is DecSharePayload and "dec" in self.kinds)
        ) and receiver in self.side_b:
            self.rewrites += 1
            return payload._replace(d=self._forge(payload.d))
        return payload


class SelectiveMute(Behavior):
    """Silence toward a seeded peer subset only: the node looks live to
    most of the roster while starving a few members of its votes and
    shards — per-link omission, which no MAC can see and no global
    liveness counter flags."""

    def __init__(self, seed: int = 0, fraction: float = 0.34) -> None:
        super().__init__(seed)
        self.fraction = fraction
        self.muted: frozenset = frozenset()

    def _attached(self) -> None:
        self.muted = self.split(self.fraction)

    def rewrite(self, receiver: str, payload):
        if receiver in self.muted:
            self.rewrites += 1
            return None
        return payload


class EpochSprayer(Behavior):
    """Spam the epoch demux window: alongside honest traffic, inject
    payloads for far-future epochs (forcing receivers through the
    far-ahead CATCHUP sighting path) and junk CatchupResp bodies inside
    the tally window (attacking the f+1 adoption quorum's memory).
    Every sprayed frame is validly MAC'd — the sliding window, the
    tally bounds and the f+1 body quorum are the only defenses."""

    def __init__(
        self, seed: int = 0, every: int = 16, max_ahead: int = 1000
    ) -> None:
        super().__init__(seed)
        from cleisthenes_tpu_torch.protocol.honeybadger import EPOCH_HORIZON

        self.every = max(1, every)
        # a spray must land BEYOND the demux horizon or it is just a
        # normal future-epoch payload; clamp so repro-file args can
        # never turn the spray range empty
        self.max_ahead = max(max_ahead, EPOCH_HORIZON + 2)
        self._count = 0

    def rewrite(self, receiver: str, payload):
        self._count += 1
        if self._count % self.every:
            return payload
        from cleisthenes_tpu_torch.protocol.honeybadger import EPOCH_HORIZON

        self.rewrites += 1
        node = self.node
        if self.rng.random() < 0.5:
            ahead = self.rng.randrange(EPOCH_HORIZON + 1, self.max_ahead)
            spray = BbaPayload(
                type=BbaType.BVAL,
                proposer=node.node_id,
                epoch=node.epoch + ahead,
                round=0,
                value=True,
            )
        else:
            spray = CatchupRespPayload(
                epoch=node.epoch + self.rng.randrange(1, 64),
                body=b"sprayed-junk-%d" % self._count,
            )
        return [payload, spray]


class TxInjector(Behavior):
    """A Byzantine proposer that slips its OWN transactions into its
    proposals.  Perfectly legal under HBBFT — any proposer may propose
    any bytes — which is exactly what makes it the fuzzer's PLANTED
    violation: the harness knows every submitted tx, so a committed
    foreign one trips the ``no_foreign_tx`` invariant with certainty,
    deterministically, on every replay (tools/fuzz.py shrinker
    self-test)."""

    def __init__(self, seed: int = 0, count: int = 1) -> None:
        super().__init__(seed)
        self.count = count

    def _attached(self) -> None:
        for i in range(self.count):
            self.node.add_transaction(
                b"injected|%d|%d" % (self.seed, i)
            )


class CompositeBehavior:
    """Chain several behaviors on one node: each payload flows through
    every behavior in order (suppressions and injections included), so
    e.g. an Equivocator can ride with an EpochSprayer."""

    def __init__(self, behaviors: Sequence[Behavior]) -> None:
        self.behaviors = list(behaviors)
        self.node = None

    @property
    def rewrites(self) -> int:
        return sum(b.rewrites for b in self.behaviors)

    def attach(self, node) -> None:
        self.node = node
        for b in self.behaviors:
            b.attach(node)

    def rewrite(self, receiver: str, payload):
        items = [payload]
        for b in self.behaviors:
            nxt: List = []
            for p in items:
                out = b.rewrite(receiver, p)
                if out is None:
                    continue
                if isinstance(out, list):
                    nxt.extend(out)
                else:
                    nxt.append(out)
            items = nxt
            if not items:
                return None
        return items[0] if len(items) == 1 else items


# -- registry (the fuzzer's construction surface) ---------------------------

BEHAVIOR_KINDS = {
    "equivocator": Equivocator,
    "split_voter": SplitVoter,
    "bad_dealer": BadDealer,
    "share_forger": ShareForger,
    "selective_mute": SelectiveMute,
    "epoch_sprayer": EpochSprayer,
    "tx_injector": TxInjector,
}


def make_behavior(kind: str, seed: int = 0, **args) -> Behavior:
    """Build one behavior from its registry name — the JSON-schedule
    construction path ``tools/fuzz.py`` uses for replayable repros."""
    cls = BEHAVIOR_KINDS.get(kind)
    if cls is None:
        raise ValueError(
            f"unknown behavior kind {kind!r}; "
            f"known: {sorted(BEHAVIOR_KINDS)}"
        )
    return cls(seed=seed, **args)


__all__ = [
    "Behavior",
    "BehaviorBroadcaster",
    "Equivocator",
    "SplitVoter",
    "BadDealer",
    "ShareForger",
    "SelectiveMute",
    "EpochSprayer",
    "TxInjector",
    "CompositeBehavior",
    "BEHAVIOR_KINDS",
    "make_behavior",
]
