"""Network roster: Address, Member, MemberMap — and, since the
dynamic-membership PR, the VERSIONED roster vocabulary.

Mirrors reference member_map.go: ``Address{Ip, Port}``
(member_map.go:12-19), ``Member{Id, Addr}`` (member_map.go:22-25), and
the RWMutex-guarded id->member ``MemberMap`` with Members/Member/Add/Del
(member_map.go:43-87).

``RosterVersion`` / ``RosterSchedule`` are the dynamic-membership
additions (docs/ARCHITECTURE.md "Dynamic membership"): a roster is no
longer a construction-time constant but a VERSIONED value activating
at an epoch boundary — every epoch-scoped structure resolves n/f/keys
through ``RosterSchedule.version_for(epoch)`` instead of reading the
construction-time ``Config``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from cleisthenes_tpu_torch.utils.determinism import guarded_by
from cleisthenes_tpu_torch.utils.lockcheck import new_rlock


@dataclasses.dataclass(frozen=True, order=True)
class Address:
    """Peer network address (reference member_map.go:12-19)."""

    ip: str
    port: int

    def __str__(self) -> str:
        return f"{self.ip}:{self.port}"


@dataclasses.dataclass(frozen=True, order=True)
class Member:
    """A validator identity: id + address (reference member_map.go:22-25).

    ``id`` is an opaque string (the reference uses uuid strings for
    connection ids, comm.go:46); for consensus we conventionally use
    stable validator names so Shamir share indices can be derived from
    roster order.
    """

    id: str
    addr: Address = Address("", 0)

    def address(self) -> Address:
        """Reference member_map.go:38."""
        return self.addr


@dataclasses.dataclass(frozen=True)
class RosterVersion:
    """One activated (or pending) roster configuration.

    ``activation_epoch``: the first epoch ORDERED under this roster —
    the ordered frontier is the switch point, so the boundary is
    WAL-durable and identical at every honest node.  ``members`` is
    the sorted member tuple (sorted order defines Shamir share
    indices, exactly like the construction-time roster).
    ``key_material_digest`` commits to the version's public threshold
    key material (TPKE + coin master keys and verification-key
    tables): every honest node derives the identical digest from the
    committed ceremony, which makes key agreement a checkable
    cross-node invariant (tools/fuzz.py reconfig band).
    """

    version: int
    activation_epoch: int
    members: Tuple[Member, ...]
    key_material_digest: bytes = b""

    def __post_init__(self) -> None:
        ordered = tuple(sorted(self.members, key=lambda m: m.id))
        if ordered != self.members:
            object.__setattr__(self, "members", ordered)

    @property
    def member_ids(self) -> Tuple[str, ...]:
        return tuple(m.id for m in self.members)

    @property
    def n(self) -> int:
        return len(self.members)

    @property
    def f(self) -> int:
        """Maximum fault budget under the BASELINE (3f+1) trust model.
        Quorum-mode-aware consumers use ``fault_budget``."""
        return (len(self.members) - 1) // 3

    def fault_budget(self, reduced_quorum: bool = False) -> int:
        """Maximum tolerable f for this roster size under the given
        trust model: floor((n-1)/3) baseline, floor((n-1)/2) when the
        attested sender log enables the reduced (2f+1) quorum mode —
        the seam through which roster views carry the quorum mode
        (Config.reduced_quorum re-derives per-version f through the
        same arithmetic in HoneyBadger.install_roster_version)."""
        d = 2 if reduced_quorum else 3
        return (len(self.members) - 1) // d


class RosterSchedule:
    """The ordered sequence of roster versions one node knows about.

    Single-threaded (owned by the protocol actor); versions append in
    order and never retract — a version, once installed, is a durable
    fact of the log (the RCFG WAL record replays it).
    """

    def __init__(self, genesis: RosterVersion) -> None:
        # the base version is 0 for a dealer-provisioned deployment;
        # a JOINER boots with the cluster's CURRENT version as its
        # base (its view of history starts at the roster it dials)
        if genesis.activation_epoch != 0:
            raise ValueError(
                "genesis roster must activate at epoch 0"
            )
        self._versions: List[RosterVersion] = [genesis]

    def install(self, rv: RosterVersion) -> None:
        last = self._versions[-1]
        if rv.version != last.version + 1:
            raise ValueError(
                f"roster version {rv.version} does not extend "
                f"{last.version}"
            )
        if rv.activation_epoch <= last.activation_epoch:
            raise ValueError(
                f"activation epoch {rv.activation_epoch} does not "
                f"advance past {last.activation_epoch}"
            )
        self._versions.append(rv)

    def version_for(self, epoch: int) -> RosterVersion:
        """The roster an epoch runs under: the newest version with
        ``activation_epoch <= epoch`` (epochs below 0 resolve to
        genesis)."""
        for rv in reversed(self._versions):
            if rv.activation_epoch <= epoch:
                return rv
        return self._versions[0]

    def latest(self) -> RosterVersion:
        return self._versions[-1]

    def known_member_ids(self) -> frozenset:
        """Union of every version's member ids — the membership test
        for epoch-UNSCOPED traffic (CATCHUP, reshare gossip), where a
        joiner or a retiree is still a legitimate correspondent."""
        out: set = set()
        for rv in self._versions:
            out.update(rv.member_ids)
        return frozenset(out)

    def __len__(self) -> int:
        return len(self._versions)

    def __iter__(self):
        return iter(self._versions)


@guarded_by("_lock", "_members")
class MemberMap:
    """Lock-guarded id -> Member map (reference member_map.go:43-87)."""

    def __init__(self) -> None:
        self._members: Dict[str, Member] = {}
        self._lock = new_rlock()

    def add(self, member: Member) -> None:
        with self._lock:
            self._members[member.id] = member

    def delete(self, member_id: str) -> None:
        """Reference member_map.go:82-87 (Del)."""
        with self._lock:
            self._members.pop(member_id, None)

    def member(self, member_id: str) -> Optional[Member]:
        with self._lock:
            return self._members.get(member_id)

    def members(self) -> List[Member]:
        """Snapshot of all members, sorted by id for deterministic
        roster order (share indices, proposer ordering)."""
        with self._lock:
            return sorted(self._members.values(), key=lambda m: m.id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._members)

    def __contains__(self, member_id: str) -> bool:
        with self._lock:
            return member_id in self._members
