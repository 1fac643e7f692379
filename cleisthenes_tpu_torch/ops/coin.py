"""Threshold common coin for BBA.

The reference specifies (but does not implement) a network-global
random bit per BBA round, "built in such a way that the correct
processes need to cooperate to compute the value of each bit"
(reference docs/BBA-EN.md:163-177) — i.e. a threshold-cryptographic
coin, costed at ~4N^2 signature sharings per node per epoch
(docs/HONEYBADGER-EN.md:93-94).

Construction: a DDH-based threshold VUF over the same group as TPKE.
For coin id C, let x = hash_to_group(C) (unknown discrete log).  Each
node publishes share d_i = x^{s_i} with a Chaum-Pedersen proof; any
f+1 verified shares Lagrange-combine to the unique value x^s, and the
coin bit is a hash of it.  Unpredictable until f+1 nodes cooperate,
and identical at every correct node — exactly the two properties
docs/BBA-EN.md:174-177 demands.  Share issue and verification batch
across shares and concurrent BBA instances through ops/tpke (the
lockstep executor calls it directly).

This is the PyTorch port's copy of ``cleisthenes_tpu/ops/coin.py``, cut
to what the lockstep epoch uses.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

from cleisthenes_tpu_torch.ops import tpke
from cleisthenes_tpu_torch.ops.modmath import DEFAULT_GROUP, GroupParams
from cleisthenes_tpu_torch.ops.tpke import (
    DhShare,
    ThresholdPublicKey,
)


def coin_base(
    coin_id: bytes, group: GroupParams = DEFAULT_GROUP
) -> int:
    """The group element x = H2G(coin_id) whose s-th power is the coin."""
    return tpke.hash_to_group(b"coin|" + coin_id, group)


class CommonCoin:
    """One coin key set shared by all BBA instances of a network."""

    def __init__(
        self, pub: ThresholdPublicKey, backend: str = "cuda"
    ):
        self.pub = pub
        self.backend = backend
        self.group = pub.group  # the key set carries its group

    def group_params(self, coin_id: bytes):
        """(pub, base, context) for this coin — the key the lockstep
        executor folds into one cross-instance
        tpke.verify_and_combine_share_groups call."""
        return self.pub, coin_base(coin_id, self.group), b"coin|" + coin_id

    def combine(self, coin_id: bytes, shares: Sequence[DhShare]) -> int:
        """Full 256-bit coin value from >= f+1 verified shares."""
        val = tpke.combine_shares(shares, self.pub.threshold, self.group)
        return int.from_bytes(
            hashlib.sha256(
                b"coinval|"
                + coin_id
                + val.to_bytes(self.group.nbytes, "big")
            ).digest(),
            "big",
        )

    def toss(self, coin_id: bytes, shares: Sequence[DhShare]) -> bool:
        """The single random bit BBA phase 3 consumes
        (docs/BBA-EN.md:163-181)."""
        return bool(self.combine(coin_id, shares) & 1)


__all__ = ["CommonCoin", "coin_base"]
