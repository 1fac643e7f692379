"""Carry key material from the reference package into the port.

The counterpart of carrying a model's weights across: a roster's
dealer output (TPKE and coin threshold keys, secret shares, pairwise
MAC keys) made by ``cleisthenes_tpu`` becomes the port's ``NodeKeys``.
The input is the plain form of that output — ints, bytes, and
sequences or numpy arrays of them, nested in dicts exactly as
``dataclasses.asdict`` lays out the reference's ``NodeKeys``:

    {member_id: {
        "tpke_pub":  {"n", "threshold", "master", "verification_keys",
                      "group": {"p", "q", "g"}},
        "tpke_share": {"index", "value"} or None,
        "coin_pub":  (as tpke_pub),
        "coin_share": (as tpke_share),
        "mac_keys":  {peer_id: bytes},
        "enroll_secret": int or None}}

so the port never imports the reference.  Verification keys may come as
a sequence of ints or as an (n, nbytes) uint8 array of big-endian rows.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from cleisthenes_tpu_torch.ops.modmath import GroupParams
from cleisthenes_tpu_torch.ops.tpke import (
    ThresholdPublicKey,
    ThresholdSecretShare,
)
from cleisthenes_tpu_torch.protocol.keys import NodeKeys


def _int(x) -> int:
    if isinstance(x, (bytes, bytearray)):
        return int.from_bytes(x, "big")
    return int(x)


def public_key_from_plain(d: Mapping[str, Any]) -> ThresholdPublicKey:
    grp = d["group"]
    group = GroupParams(p=_int(grp["p"]), q=_int(grp["q"]), g=_int(grp["g"]))
    vks = d["verification_keys"]
    if isinstance(vks, np.ndarray):
        vks = [int.from_bytes(row.tobytes(), "big") for row in vks]
    return ThresholdPublicKey(
        n=int(d["n"]),
        threshold=int(d["threshold"]),
        master=_int(d["master"]),
        verification_keys=tuple(_int(v) for v in vks),
        group=group,
    )


def _share_from_plain(
    d: Optional[Mapping[str, Any]],
) -> Optional[ThresholdSecretShare]:
    if d is None:
        return None
    return ThresholdSecretShare(index=int(d["index"]), value=_int(d["value"]))


def node_keys_from_plain(d: Mapping[str, Any]) -> NodeKeys:
    enroll = d.get("enroll_secret")
    return NodeKeys(
        tpke_pub=public_key_from_plain(d["tpke_pub"]),
        tpke_share=_share_from_plain(d["tpke_share"]),
        coin_pub=public_key_from_plain(d["coin_pub"]),
        coin_share=_share_from_plain(d["coin_share"]),
        mac_keys={str(k): bytes(v) for k, v in d["mac_keys"].items()},
        enroll_secret=None if enroll is None else _int(enroll),
    )


def keys_from_plain(plain: Mapping[str, Mapping[str, Any]]) -> Dict[str, NodeKeys]:
    """{member_id: plain NodeKeys} -> {member_id: port NodeKeys}."""
    return {str(m): node_keys_from_plain(d) for m, d in plain.items()}


__all__ = ["keys_from_plain", "node_keys_from_plain", "public_key_from_plain"]
