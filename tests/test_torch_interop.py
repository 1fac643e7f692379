"""Key material carried from the JAX package into the port
(cleisthenes_tpu_torch.interop) equals the port's own dealer output, and
the two packages agree on what those keys compute."""

import dataclasses

import numpy as np
import pytest

from cleisthenes_tpu.config import Config as RefConfig
from cleisthenes_tpu.ops import coin as ref_coin
from cleisthenes_tpu.ops import modmath as ref_mm
from cleisthenes_tpu.ops import tpke as ref_tpke
from cleisthenes_tpu.protocol.honeybadger import setup_keys as ref_setup_keys
from cleisthenes_tpu_torch import interop
from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.ops import coin, modmath, tpke
from cleisthenes_tpu_torch.protocol.keys import setup_keys


def _ids(n):
    return [f"node{i:03d}" for i in range(n)]


def _carried(n, seed, group=None):
    ref = ref_setup_keys(
        RefConfig(n=n), _ids(n), seed=seed,
        group=group and getattr(ref_mm, group),
    )
    return ref, interop.keys_from_plain(
        {m: dataclasses.asdict(k) for m, k in ref.items()}
    )


@pytest.mark.parametrize(
    "n,seed,group",
    [(4, 1, None), (7, 5, None), (16, 77, None), (257, 13, None),
     (7, 21, "GROUP384")],
)
def test_carried_keys_equal_port_setup(n, seed, group):
    """Rosters of 4 to 257 (past the GF(2^8) ceiling) and the 384-bit
    group: the carried keys are the port's own dealer output."""
    _ref, carried = _carried(n, seed, group)
    ours = setup_keys(
        Config(n=n, device="cpu"), _ids(n), seed=seed,
        group=group and getattr(modmath, group),
    )
    assert carried == ours
    if group:
        assert ours[_ids(n)[0]].tpke_pub.group == modmath.GROUP384


@pytest.mark.parametrize("group,width", [(None, 32), ("GROUP384", 48)])
def test_verification_keys_as_byte_rows(group, width):
    ref = ref_setup_keys(
        RefConfig(n=4), _ids(4), seed=9, group=group and getattr(ref_mm, group)
    )
    plain = dataclasses.asdict(ref["node001"])
    vks = plain["tpke_pub"]["verification_keys"]
    assert ref["node001"].tpke_pub.group.nbytes == width
    plain["tpke_pub"]["verification_keys"] = np.stack(
        [np.frombuffer(v.to_bytes(width, "big"), np.uint8) for v in vks]
    )
    node = interop.node_keys_from_plain(plain)
    assert node.tpke_pub.verification_keys == tuple(vks)


def test_carried_keys_give_the_reference_coin_and_plaintext():
    n = 7
    ref, carried = _carried(n, 3)
    ids = _ids(n)
    coin_id = b"7|node002|4"
    r_coin = ref_coin.CommonCoin(ref[ids[0]].coin_pub)
    p_coin = coin.CommonCoin(carried[ids[0]].coin_pub)
    _pub, base, ctx = p_coin.group_params(coin_id)
    assert r_coin.group_params(coin_id)[1:] == (base, ctx)
    t = carried[ids[0]].coin_pub.threshold
    # shares issued by each package from its own copy of the keys
    p_sh = tpke.issue_shares_batch(
        [(carried[m].coin_share, base, ctx, None) for m in ids[:t]],
        backend="cuda",
        device="cpu",
    )
    r_sh = ref_tpke.issue_shares_batch(
        [(ref[m].coin_share, base, ctx, None) for m in ids[-t:]]
    )
    assert p_coin.combine(coin_id, p_sh) == r_coin.combine(coin_id, r_sh)
    assert p_coin.toss(coin_id, p_sh) == r_coin.toss(coin_id, r_sh)
    # a ciphertext made by the port opens under the reference's shares
    pub = carried[ids[0]].tpke_pub
    ct = tpke.Tpke(pub).encrypt(b"carried across")
    r_ct = ref_tpke.Ciphertext(c1=ct.c1, c2=ct.c2, tag=ct.tag)
    r_t = ref_tpke.Tpke(ref[ids[0]].tpke_pub)
    dec = ref_tpke.issue_shares_batch(
        [
            (ref[m].tpke_share, ct.c1, r_t.context(r_ct), None)
            for m in ids[: pub.threshold]
        ]
    )
    assert r_t.combine(r_ct, dec) == b"carried across"
