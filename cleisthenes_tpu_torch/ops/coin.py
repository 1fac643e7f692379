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

This is the PyTorch port's copy of ``cleisthenes_tpu/ops/coin.py``; its
batched ops take the engine's ``backend``, ``device`` and ``mesh``
(the reference's ``mesh``).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

from cleisthenes_tpu_torch.ops import tpke
from cleisthenes_tpu_torch.ops.modmath import DEFAULT_GROUP, GroupParams
from cleisthenes_tpu_torch.ops.tpke import (
    DhShare,
    ThresholdPublicKey,
    ThresholdSecretShare,
    issue_shares_batch,
    verify_share_groups,
)


def coin_base(
    coin_id: bytes, group: GroupParams = DEFAULT_GROUP
) -> int:
    """The group element x = H2G(coin_id) whose s-th power is the coin."""
    return tpke.hash_to_group(b"coin|" + coin_id, group)


def share_batch(
    items: Sequence[tuple],
    group: GroupParams = DEFAULT_GROUP,
    backend: str = "cuda",
    device="cuda",
    mesh=None,
) -> List[DhShare]:
    """Issue MANY coin shares — across instances, rounds, and (in an
    in-proc cluster) issuers — in ONE vectorized multi-exponentiation
    dispatch with ONE CP-nonce entropy draw (the wave-column treatment
    ``Tpke.dec_share_batch`` already gave the TPKE side; Thetacrypt's
    batched threshold-service shape, PAPERS.md 2502.03247).

    ``items``: sequence of ``(secret, base, context, vk)`` exactly as
    ``tpke.issue_shares_batch`` takes them — ``base``/``context`` come
    from ``CommonCoin.group_params(coin_id)``, ``vk`` is the issuer's
    verification key (None recomputes it in the same dispatch).
    Semantics match mapping ``tpke.issue_share`` over the items;
    result order matches input order.  The reference's CryptoHub
    coin-issue column (``take_coin_issues``) dispatches through here;
    the lockstep spmd plane calls ``tpke.issue_shares_batch`` directly.
    On the 'cuda' engine a call of 64 or more exponentiations runs the
    fixed-base comb (K9)."""
    return issue_shares_batch(
        items, group=group, backend=backend, device=device, mesh=mesh
    )


class CommonCoin:
    """One coin key set shared by all BBA instances of a network."""

    def __init__(
        self, pub: ThresholdPublicKey, backend: str = "cuda", device="cuda",
        mesh=None,
    ):
        self.pub = pub
        self.backend = backend
        # the card the batched share ops run on (a 'cuda' backend's; the
        # engine resolves it, and raises on a machine without a GPU)
        self.device = device
        # the device mesh its batched share ops shard over, or None
        self.mesh = mesh
        self.group = pub.group  # the key set carries its group

    def share(
        self, secret: ThresholdSecretShare, coin_id: bytes
    ) -> DhShare:
        return tpke.issue_share(
            secret,
            coin_base(coin_id, self.group),
            b"coin|" + coin_id,
            self.group,
        )

    def share_batch(
        self,
        secret: ThresholdSecretShare,
        coin_ids: Sequence[bytes],
        vk: Optional[int] = None,
    ) -> List[DhShare]:
        """One issuer's coin shares for MANY coins — every (instance,
        round) a wave touched — in one vectorized dispatch and one
        CP-nonce draw.  Semantically ``[share(secret, cid) for cid in
        coin_ids]``; ``vk`` (the issuer's verification key
        g^{s_i}) defaults to the key set's own, saving one
        exponentiation per item."""
        if not coin_ids:
            return []
        if vk is None:
            vk = self.pub.verification_keys[secret.index - 1]
        return share_batch(
            [
                (secret, coin_base(cid, self.group), b"coin|" + cid, vk)
                for cid in coin_ids
            ],
            group=self.group,
            backend=self.backend,
            device=self.device,
            mesh=self.mesh,
        )

    def verify_shares(
        self, coin_id: bytes, shares: Sequence[DhShare]
    ) -> List[bool]:
        return tpke.verify_shares(
            self.pub,
            coin_base(coin_id, self.group),
            shares,
            b"coin|" + coin_id,
            self.backend,
            self.device,
            self.mesh,
        )

    def verify_shares_batch(
        self, entries: Sequence[Tuple[bytes, Sequence[DhShare]]]
    ) -> List[List[bool]]:
        """CP-verify MANY coins' pooled shares — across all BBA
        instances and rounds a wave touched — in ONE
        dual-exponentiation dispatch (semantically
        ``[verify_shares(cid, shs) for cid, shs in entries]``; result
        order matches input order).  The protocol hub reaches the same
        dispatch shape by folding coin groups into its share column
        (tpke.verify_share_groups); this is the coin-only entry point
        for callers without a hub (lockstep executor, tests)."""
        if not entries:
            return []
        return verify_share_groups(
            [
                (
                    self.pub,
                    coin_base(cid, self.group),
                    shs,
                    b"coin|" + cid,
                )
                for cid, shs in entries
            ],
            self.backend,
            self.device,
            self.mesh,
        )

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


__all__ = ["CommonCoin", "coin_base", "share_batch"]
