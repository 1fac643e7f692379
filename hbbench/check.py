"""The comparison that decides ``correct``: what the timed path produced,
held to the plain reference (``hbbench/reference``).

Every number below counts disagreements and has the limit 0:

- ``keys``: dealt secret shares, master keys and verification keys of the
  decryption and coin key sets that differ from the reference's dealing.
- ``ledger_wrong``: positions of the committed ledger whose transaction
  is not, byte for byte, the one the queues and the commit rule give for
  that epoch; a batch too many or too few counts each of its positions.
- ``ledger_missing``: transactions due (proposed by the replay, or due in
  an open loop's window) that no batch commits.
- ``ledger_duplicate``: transactions committed more than once.
- ``rbc_shards``, ``rbc_roots``, ``rbc_decoded``: in the sampled epochs,
  shard rows, Merkle roots (of the encode and of the delivery recheck)
  and delivered proposals that differ from the reference's encoding of
  the epoch's ciphertexts; a delivered proposal must also be the
  ciphertext that was decrypted.
- ``coin_tosses``: coin tosses unlike the reference's coin.
- ``bba_rounds``: epochs whose round count is not the reference's, and
  (instance, round) coins an instance needed before it decided that the
  epoch never tossed.
- ``plaintexts``: decrypted proposals unlike the reference's decryption
  of the same ciphertext, or unlike the proposer's transaction list.

Over a group wider than 256 bits the reference's powers (the dealing, a
coin a tossed id, a decryption key a ciphertext) are worked out first, over
worker processes, one a CPU this process may use (``workers_for``).
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hbbench.reference import gf256, ledger, merkle, threshold
from hbbench.traffic import index_of

NAMES = (
    "keys", "ledger_wrong", "ledger_missing", "ledger_duplicate",
    "rbc_shards", "rbc_roots", "rbc_decoded", "coin_tosses", "bba_rounds",
    "plaintexts",
)
LIMITS = {name: 0 for name in NAMES}


@dataclasses.dataclass
class Evidence:
    """What the run hands the comparison: the benchmark's own inputs and
    the program's outputs, as plain data."""

    group: threshold.Group
    key_seed: int
    ids: List[str]
    n: int
    f: int
    batch_size: int
    pool: object  # traffic.TxPool
    sub_before: List[int]  # transactions submitted before epoch e started;
    # transaction i, submitted i-th, went to validator i mod N
    due: Optional[Sequence[int]]  # indices that must commit; None: all proposed
    committed: List[List[bytes]]  # the program's ledger, epoch by epoch
    port_keys: dict  # {"tpke"|"coin": (master, vks, shares by id)}
    bba_rounds: List[int]  # the program's stats, epoch by epoch
    rbc: Dict[int, dict]
    tosses: Dict[int, Dict[bytes, bool]]
    plain: Dict[int, list]  # (c1, c2, tag, plaintext) in proposer order
    cts: Dict[int, list]  # (c1, c2, tag) in proposer order


def _key_mismatches(dealt: threshold.Dealt, port, ids) -> int:
    master, vks, shares = port
    bad = int(master != dealt.master)
    bad += sum(a != b for a, b in zip(vks, dealt.verification_keys)) + abs(len(vks) - len(dealt.verification_keys))
    bad += sum(shares[nid] != dealt.shares[i] for i, nid in enumerate(ids))
    return bad


def workers_for(grp: threshold.Group) -> int:
    """Processes for the reference's powers: one a CPU for a group wider
    than 256 bits, else this one alone."""
    return len(os.sched_getaffinity(0)) if grp.p.bit_length() > 256 else 1


def compare(ev: Evidence) -> Tuple[Dict[str, int], int]:
    """The disagreement counts, and how many transactions were due."""
    out = dict.fromkeys(NAMES, 0)
    ids = sorted(ev.ids)
    n, f = ev.n, ev.f
    k = n - 2 * f
    grp = ev.group
    workers = workers_for(grp)
    tpke = threshold.deal(grp, n, f + 1, ev.key_seed, workers)
    coin = threshold.deal(grp, n, f + 1, ev.key_seed + 1, workers)
    out["keys"] = _key_mismatches(tpke, ev.port_keys["tpke"], ids) + _key_mismatches(
        coin, ev.port_keys["coin"], ids
    )

    # the queues and the commit rule, epoch by epoch
    queues = ledger.Queues(ids, ev.batch_size)
    proposals: List[Dict[str, List[int]]] = []
    fed = 0
    for e, upto in enumerate(ev.sub_before):
        for idx in range(fed, upto):
            queues.submit(ids[idx % n], idx)
        fed = upto
        props = queues.propose()
        proposals.append(props)
        want = [ev.pool.tx(i) for i in ledger.commit({nid: props[nid] for nid in ids})]
        got = ev.committed[e] if e < len(ev.committed) else []
        out["ledger_wrong"] += sum(a != b for a, b in zip(want, got)) + abs(len(want) - len(got))
    for extra in ev.committed[len(ev.sub_before):]:
        out["ledger_wrong"] += len(extra)
    counts = collections.Counter(
        index_of(tx) for batch in ev.committed for tx in batch if tx == ev.pool.tx(index_of(tx))
    )
    out["ledger_duplicate"] = sum(c - 1 for c in counts.values() if c > 1)
    due = ev.due if ev.due is not None else [i for p in proposals for txs in p.values() for i in txs]
    out["ledger_missing"] = sum(1 for i in due if i not in counts)

    # the coin and the rounds it decides
    cache: Dict[bytes, bool] = {}
    sigma: Dict[bytes, int] = {}
    shared: Dict[int, int] = {}
    if workers > 1:
        cids = sorted({cid for tossed in ev.tosses.values() for cid in tossed})
        sigma = dict(zip(cids, threshold.pows(
            [(threshold.coin_base(grp, cid), coin.secret) for cid in cids], grp.p, workers)))
        c1s = sorted({row[0] for pairs in ev.plain.values() for row in pairs})
        shared = dict(zip(c1s, threshold.pows([(c1, tpke.secret) for c1 in c1s], grp.p, workers)))

    def toss(cid: bytes) -> bool:
        if cid not in cache:
            cache[cid] = threshold.coin_toss(grp, coin.secret, cid, sigma.get(cid))
        return cache[cid]

    for e, tossed in ev.tosses.items():
        out["coin_tosses"] += sum(bit != toss(cid) for cid, bit in tossed.items())
        decide = []
        for pid in ids:
            rnd = 0
            while not toss(threshold.coin_id(e, pid, rnd)):
                if threshold.coin_id(e, pid, rnd) not in tossed:
                    out["bba_rounds"] += 1
                rnd += 1
            if threshold.coin_id(e, pid, rnd) not in tossed:
                out["bba_rounds"] += 1
            decide.append(rnd + 1)
        if e >= len(ev.bba_rounds) or ev.bba_rounds[e] != max(decide):
            out["bba_rounds"] += 1

    # threshold decryption: the proposer's transaction list, every epoch
    for e, pairs in ev.plain.items():
        props = proposals[e] if e < len(proposals) else {}
        out["plaintexts"] += abs(len(pairs) - n)
        for nid, (c1, c2, tag, pt) in zip(ids, pairs):
            try:
                ref = threshold.decrypt(grp, tpke.secret, c1, c2, tag, shared.get(c1))
            except ValueError:
                out["plaintexts"] += 1
                continue
            want = ledger.tx_list([ev.pool.tx(i) for i in props.get(nid, [])])
            out["plaintexts"] += int(ref != pt or ref != want)

    # RBC, in the sampled epochs
    for e, slot in ev.rbc.items():
        values = [ledger.ciphertext(grp.nbytes, *ct) for ct in ev.cts.get(e, [])]
        if len(values) != n or not {"full", "roots", "decoded", "decoded_roots"} <= set(slot):
            out["rbc_shards"] += n * n
            out["rbc_roots"] += 2 * n
            out["rbc_decoded"] += n
            continue
        data = ledger.epoch_data(values, k)
        full = gf256.encode(data, n)
        port_full = np.asarray(slot["full"])
        if port_full.shape != full.shape:
            out["rbc_shards"] += n * n
        else:
            out["rbc_shards"] += int((port_full != full).any(axis=2).sum())
        roots = [merkle.root(full[i]) for i in range(n)]
        out["rbc_roots"] += sum(a != b for a, b in zip(roots, slot["roots"]))
        dec_roots = [np.asarray(r).tobytes() for r in slot["decoded_roots"]]
        out["rbc_roots"] += sum(a != b for a, b in zip(roots, dec_roots))
        dec = np.asarray(slot["decoded"])
        delivered = [ledger.ciphertext(grp.nbytes, *row[:3]) for row in ev.plain.get(e, [])]
        for i in range(n):
            same = dec.shape == data.shape and np.array_equal(dec[i], data[i])
            same = same and i < len(delivered) and delivered[i] == values[i]
            out["rbc_decoded"] += int(not same)
    return out, len(due)
