"""Dealer key setup and the tx-list / ciphertext codecs of the epoch.

The helpers the lockstep executor takes from the reference's
``cleisthenes_tpu/protocol/honeybadger.py:137-310`` (tx-list and
ciphertext serialization, ``NodeKeys``, ``setup_keys``) and the
pairwise MAC key schedule of ``transport/base.py:363-382``
(``HmacAuthenticator.pair_key`` / ``key_map``), split out so the
lockstep epoch does not pull in the message-passing protocol plane;
``protocol/honeybadger.py`` re-exports them where the reference
defines them.  Byte formats and key derivations are identical to the
reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Dict, List, Optional, Sequence

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.ops import tpke as tpke_mod
from cleisthenes_tpu_torch.ops.tpke import (
    Ciphertext,
    ThresholdPublicKey,
    ThresholdSecretShare,
)

# cap on a deserialized tx list's declared count (honeybadger.py:129)
MAX_TXS_PER_LIST = 1_000_000


def serialize_txs(txs: Sequence[bytes]) -> bytes:
    out = [struct.pack(">I", len(txs))]
    for tx in txs:
        out.append(struct.pack(">I", len(tx)))
        out.append(tx)
    return b"".join(out)


def deserialize_txs(data: bytes, memo=None) -> List[bytes]:
    """Parse a tx list.  ``memo`` (``honeybadger.make_tx_parse_memo``)
    caches parses by content digest, for in-proc clusters whose nodes
    all parse the same plaintexts; None parses every time."""
    if memo is not None and len(data) >= 256:
        # small blobs: the digest costs about as much as the parse
        key = hashlib.sha256(data).digest()
        hit = memo.map.get(key)
        if hit is not None:
            return list(hit)
        out = _deserialize_txs_uncached(data)
        memo.put(key, tuple(out))
        return out
    return _deserialize_txs_uncached(data)


def _deserialize_txs_uncached(data: bytes) -> List[bytes]:
    if len(data) < 4:
        raise ValueError("truncated tx list")
    (count,) = struct.unpack_from(">I", data, 0)
    if count > MAX_TXS_PER_LIST:
        raise ValueError(f"tx count {count} exceeds cap")
    off = 4
    txs: List[bytes] = []
    for _ in range(count):
        if off + 4 > len(data):
            raise ValueError("truncated tx list")
        (ln,) = struct.unpack_from(">I", data, off)
        off += 4
        if off + ln > len(data):
            raise ValueError("truncated tx")
        txs.append(data[off : off + ln])
        off += ln
    if off != len(data):
        raise ValueError("trailing bytes in tx list")
    return txs


def serialize_ciphertext(ct: Ciphertext, group=None) -> bytes:
    """c1 is fixed-width at the roster's group size."""
    group = group or tpke_mod.DEFAULT_GROUP
    return (
        ct.c1.to_bytes(group.nbytes, "big")
        + struct.pack(">I", len(ct.c2))
        + ct.c2
        + ct.tag
    )


def deserialize_ciphertext(data: bytes, group=None) -> Ciphertext:
    group = group or tpke_mod.DEFAULT_GROUP
    nb = group.nbytes
    if len(data) < nb + 4:
        raise ValueError("truncated ciphertext")
    c1 = int.from_bytes(data[:nb], "big")
    if not tpke_mod.is_group_element(c1, group):
        # c1 outside the prime-order subgroup would make every honest
        # node's decryption share fail verification forever
        raise ValueError("ciphertext c1 not in the prime-order subgroup")
    (ln,) = struct.unpack_from(">I", data, nb)
    if nb + 4 + ln + 32 != len(data):
        raise ValueError("bad ciphertext framing")
    return Ciphertext(
        c1=c1, c2=data[nb + 4 : nb + 4 + ln], tag=data[nb + 4 + ln :]
    )


def pair_key(master_secret: bytes, a: str, b: str) -> bytes:
    """The dealer's unordered-pair MAC key
    ``H("macpair|" || master || "|" || min(a,b) || "|" || max(a,b))``."""
    lo, hi = sorted((a.encode("utf-8"), b.encode("utf-8")))
    return hashlib.sha256(
        b"macpair|" + master_secret + b"|" + lo + b"|" + hi
    ).digest()


def key_map(master_secret: bytes, self_id: str, roster_ids) -> Dict[str, bytes]:
    """Every pair key ``self_id`` belongs to (the dealer's schedule)."""
    return {peer: pair_key(master_secret, self_id, peer) for peer in roster_ids}


@dataclasses.dataclass(frozen=True)
class NodeKeys:
    """Everything one validator needs from the dealer."""

    tpke_pub: ThresholdPublicKey
    tpke_share: Optional[ThresholdSecretShare]
    coin_pub: ThresholdPublicKey
    coin_share: Optional[ThresholdSecretShare]
    # this node's pairwise MAC keys: peer_id -> k_{self,peer}
    mac_keys: Dict[str, bytes]
    # a joiner's static-DH enrollment secret (dynamic membership in
    # the reference); None for dealer-provisioned roster members
    enroll_secret: Optional[int] = None


def setup_keys(
    config: Config,
    member_ids: Sequence[str],
    seed: Optional[int] = None,
    group=None,
) -> Dict[str, NodeKeys]:
    """TPKE.SetUp + coin setup + MAC master for the whole roster
    (docs/THRESHOLD_ENCRYPTION-EN.md:33; share x-coordinates follow
    sorted roster order).

    With ``seed=None`` all key material comes from the OS CSPRNG.  A
    seed makes the whole key set reproducible — for tests and
    benchmarks ONLY.
    """
    members = sorted(member_ids)
    if len(members) != config.n:
        raise ValueError(f"roster size {len(members)} != n={config.n}")
    group = group or tpke_mod.DEFAULT_GROUP
    tpke_pub, tpke_shares = tpke_mod.deal(
        config.n, config.decryption_threshold, seed=seed, group=group
    )
    coin_pub, coin_shares = tpke_mod.deal(
        config.n,
        config.f + 1,
        seed=None if seed is None else seed + 1,
        group=group,
    )
    if seed is None:
        import secrets

        # the envelope-MAC master MUST be unpredictable; it never
        # influences protocol scheduling, so it is sanctioned entropy:
        mac_master = secrets.token_bytes(32)  # staticcheck: allow[DET001] dealer keygen
    else:
        mac_master = b"cleisthenes-tpu-test-mac|%d" % seed
    return {
        m: NodeKeys(
            tpke_pub=tpke_pub,
            tpke_share=tpke_shares[i],
            coin_pub=coin_pub,
            coin_share=coin_shares[i],
            mac_keys=key_map(mac_master, m, members),
        )
        for i, m in enumerate(members)
    }


__all__ = [
    "NodeKeys",
    "setup_keys",
    "serialize_txs",
    "deserialize_txs",
    "serialize_ciphertext",
    "deserialize_ciphertext",
    "pair_key",
    "key_map",
]
