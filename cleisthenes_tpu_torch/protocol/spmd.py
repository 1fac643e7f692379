"""LockstepCluster: one HBBFT epoch for ALL N validators as batched
array programs — the SPMD answer to BASELINE configs 4 and 5.

The message-passing path (protocol.cluster.SimulatedCluster) executes
the protocol one delivered frame at a time; faithful, asynchronous,
Byzantine-capable — and at N=128 the per-message host work dominates
any accelerator.  This module is the other end of the framework's
design space: under a BENIGN schedule (no crashes, no equivocation,
reliable in-order delivery — the schedule every benchmark of the
reference's lineage measures, docs/HONEYBADGER-EN.md:110-113) the
protocol's data flow is a fixed sequence of synchronous waves, and
each wave is a single batched crypto call over every (node, instance)
pair at once:

  propose   N TPKE encryptions
  RBC       1 batched RS encode (N proposals) + 1 Merkle forest build
            + 1 batched verify of the N^2 distinct (proposer, shard)
            ECHO branches + 1 fused decode/re-encode/root-recheck over
            N proposals
  BBA       per round: N^2 coin-share issues (one batched
            exponentiation dispatch), (f+1) x N CP verifications (one
            dispatch), N Lagrange combines (one dispatch)
  decrypt   N^2 decryption-share issues (one dispatch) + N optimistic
            combines (one dispatch) with ciphertext-tag checks
  commit    the reference dedup/commit rule, one Batch per epoch

Work accounting is the DEDUPLICATED cluster total — each distinct
pure computation once, exactly like the shared-hub CryptoHub memo
(protocol.hub): per-node honest work is preserved, only the
single-process artifact of re-running identical math N times is gone.
Share ISSUANCE is not deduplicable (each node's secret differs) and
runs at full N^2 volume.

Every cryptographic operation is the real one; the commit rule is
HoneyBadger's own (the reference's protocol.honeybadger._maybe_commit).
What the lockstep path does NOT exercise: the wire codec, MAC
authentication, asynchronous scheduling, and fault handling.

This is the PyTorch port's copy of ``cleisthenes_tpu/protocol/spmd.py``,
unchanged in logic.  With the default ``crypto_backend='cuda'`` every
wave's batched crypto runs in the port's CUDA kernels on ``device``:
the RBC wave (RS encode, Merkle forest, the N^2 branch checks, the
fused decode/re-encode/root recheck) and the BBA and decrypt waves'
modexp (the fixed-base comb for share issue, the dual pow for the CP
verify with its fused Lagrange combine, the generic pow for the
unfused decrypt combine).  The propose wave's N TPKE encryptions stay
on the host's native Montgomery kernel, as in the reference.
tests/test_torch_lockstep.py holds its committed batches and round
counts to the reference's.

The coin is the real threshold VUF: per (instance, round) all N
shares are issued with CP proofs, f+1 verify, and the combined value
decides the round exactly as protocol.bba does — so round counts are
the true geometric distribution, not a stub.
"""

# staticcheck: allow-file[DET001] bench executor: time.perf_counter here
# only fills the returned stats dict (wall-clock observability); no
# timing value ever feeds protocol state, wire bytes, or the commit rule

# staticcheck: allow-file[DET003] the lockstep plane IS its own columnar
# batch layer: every epoch's crypto already runs as a handful of wide
# dispatches with no hub in the loop, which is exactly the discipline
# DET003 protects on the async path

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core.batch import Batch
from cleisthenes_tpu_torch.ops.backend import get_backend
from cleisthenes_tpu_torch.ops.payload import join_payload, split_payload
from cleisthenes_tpu_torch.ops.tpke import (
    combine_shares_batch,
    issue_shares_batch,
    verify_and_combine_share_groups,
)
from cleisthenes_tpu_torch.protocol.keys import (
    deserialize_ciphertext,
    deserialize_txs,
    serialize_ciphertext,
    serialize_txs,
    setup_keys,
)

# A round decides with probability 1/2 per instance; 64 rounds is
# P ~ 2^-64 per instance — the same class of bound as bba.MAX_ROUNDS.
MAX_COIN_ROUNDS = 64


class LockstepCluster:
    """N validators, synchronous benign schedule, batched waves."""

    def __init__(
        self,
        n: int = 4,
        *,
        config: Optional[Config] = None,
        batch_size: int = 256,
        crypto_backend: str = "cuda",
        device: str = "cuda",
        key_seed: int = 1,
        member_ids: Optional[Sequence[str]] = None,
        group=None,
        coin_block_doubling: bool = True,
        coin_block_initial: int = 1,
        mesh_devices: Optional[Sequence] = None,
    ) -> None:
        if config is not None:
            if n != 4 and n != config.n:
                raise ValueError(
                    f"n={n} conflicts with config.n={config.n}; pass one"
                )
            self.config = config
        else:
            self.config = Config(
                n=n,
                batch_size=batch_size,
                crypto_backend=crypto_backend,
                device=device,
            )
        cfg = self.config
        if member_ids is None:
            member_ids = [f"node{i:03d}" for i in range(cfg.n)]
        self.ids: List[str] = sorted(member_ids)
        self._base_key_seed = key_seed
        self._group = group
        self.keys = setup_keys(cfg, self.ids, seed=key_seed, group=group)
        # the devices of config.mesh_shape's mesh when not its defaults
        # (one card carrying several handles of itself)
        self._mesh_devices = mesh_devices
        self.crypto = get_backend(cfg, mesh_devices)
        k0 = self.keys[self.ids[0]]
        self.tpke = self.crypto.tpke(k0.tpke_pub)
        self.coin = self.crypto.coin(k0.coin_pub)
        self.queues: Dict[str, collections.deque] = {
            nid: collections.deque() for nid in self.ids
        }
        self.committed_batches: List[Batch] = []
        self.epoch = 0
        self._rr = 0
        # b = max(B, n): the reference's batch floor
        # (honeybadger.go:62-104 via protocol.honeybadger)
        self.b = max(cfg.batch_size, cfg.n)
        # doubling coin-round blocks batch several rounds' coin work
        # into one wave; block=1 is the serial comparator
        self.coin_block_doubling = coin_block_doubling
        # first block's round count: 1 = the default doubling schedule
        # ([0],[1],[2,3],...); 4 = ([0..3],[8-wide],...) — E[decided
        # after 4 rounds] = 15/16 of the roster, so the extra
        # speculative issue mass buys two fewer sequential waves
        self.coin_block_initial = max(1, int(coin_block_initial))
        self.last_stats: Dict[str, float] = {}

    # -- application surface ----------------------------------------------

    def submit(self, tx: bytes, node_id: Optional[str] = None) -> None:
        if node_id is None:
            node_id = self.ids[self._rr % len(self.ids)]
            self._rr += 1
        self.queues[node_id].append(tx)

    def pending_tx_count(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def committed(self, node_id: Optional[str] = None) -> List[Batch]:
        """Per the agreement property every node's history is the
        same list; ``node_id`` is accepted for SimulatedCluster API
        compatibility."""
        return list(self.committed_batches)

    def reconfigure(
        self,
        join: Sequence[str] = (),
        retire: Sequence[str] = (),
        key_seed: Optional[int] = None,
    ) -> None:
        """The lockstep analogue of the reshare ceremony's ACTIVATION
        boundary: between epochs, swap the roster and rebind fresh
        threshold key material.  The asynchronous plane reaches the
        same switch through the in-band ceremony (PVSS dealings, the
        RCFG record, the frontier-gated activation); the lockstep
        plane models the BENIGN schedule only, so it applies the
        already-agreed outcome as one synchronous step — same roster
        arithmetic (n, f, data shards re-derived under the active
        quorum mode), same commit rule, continuous epoch counter.
        Pending txs queued at a retiring member re-route round-robin
        to the survivors (the message-passing twin's clients fail
        over the same way)."""
        import dataclasses as _dc

        ids = sorted((set(self.ids) | set(join)) - set(retire))
        if not ids:
            raise ValueError("reconfigure would empty the roster")
        stranded: List[bytes] = []
        for nid in retire:
            stranded.extend(self.queues.get(nid, ()))
        cfg = _dc.replace(self.config, n=len(ids), f=None)
        self.config = cfg
        self.ids = ids
        self.keys = setup_keys(
            cfg,
            ids,
            seed=self._next_key_seed() if key_seed is None else key_seed,
            group=self._group,
        )
        self.crypto = get_backend(cfg, self._mesh_devices)
        k0 = self.keys[ids[0]]
        self.tpke = self.crypto.tpke(k0.tpke_pub)
        self.coin = self.crypto.coin(k0.coin_pub)
        self.queues = {
            nid: self.queues.get(nid, collections.deque()) for nid in ids
        }
        self.b = max(cfg.batch_size, cfg.n)
        for tx in stranded:
            self.submit(tx)

    def _next_key_seed(self) -> int:
        """Deterministic proactive-rekey schedule: version v uses
        key_seed + v (the async ceremony derives fresh material from
        the dealings; here the seed schedule stands in for it)."""
        self._key_version = getattr(self, "_key_version", 0) + 1
        return self._base_key_seed + self._key_version

    # -- one epoch ---------------------------------------------------------

    def run_epoch(self) -> Dict[str, float]:
        cfg = self.config
        n, f, k = cfg.n, cfg.f, cfg.data_shards
        ids = self.ids
        group = self.tpke.group
        backend = self.crypto.engine_backend
        device = self.crypto.device
        mesh = self.crypto.mesh
        stats: Dict[str, float] = {}
        t_all = time.perf_counter()

        # ---- propose: batch select + TPKE encrypt (N ciphertexts) ----
        t0 = time.perf_counter()
        per_node = self.b // n
        my_txs: Dict[str, List[bytes]] = {}
        values: List[bytes] = []
        for nid in ids:
            q = self.queues[nid]
            txs = [q.popleft() for _ in range(min(per_node, len(q)))]
            my_txs[nid] = txs
            ct = self.tpke.encrypt(serialize_txs(txs))
            values.append(serialize_ciphertext(ct, group))
        stats["propose_s"] = time.perf_counter() - t0

        # ---- RBC: encode + forest + N^2 branch verify + decode ----
        t0 = time.perf_counter()
        mats = [split_payload(v, k) for v in values]
        L = max(m.shape[1] for m in mats)
        data = np.zeros((n, k, L), dtype=np.uint8)
        for i, m in enumerate(mats):
            data[i, :, : m.shape[1]] = m
        full = self.crypto.erasure.encode_batch(data)  # (n, n, L)
        trees = self.crypto.merkle.build_batch(full)
        roots = [t.root for t in trees]
        stats["rbc_encode_s"] = time.perf_counter() - t0

        # the N^2 distinct ECHO-phase proofs (docs/HONEYBADGER-EN.md:96),
        # one batched verify — the deduplicated receiver-side work
        t0 = time.perf_counter()
        root_arr = np.repeat(
            np.frombuffer(b"".join(roots), dtype=np.uint8).reshape(n, 32),
            n,
            axis=0,
        )
        leaves = np.ascontiguousarray(full.reshape(n * n, L))
        depth = trees[0].depth
        branches = np.zeros((n * n, depth, 32), dtype=np.uint8)
        leaf_idx = np.arange(n)
        for i, tree in enumerate(trees):
            for d_ in range(depth):
                # sibling of leaf j at depth d_ is level[d_][(j>>d_)^1]
                branches[i * n : (i + 1) * n, d_] = tree.levels[d_][
                    (leaf_idx >> d_) ^ 1
                ]
        indices = np.tile(np.arange(n), n)
        ok = self.crypto.merkle.verify_batch(
            root_arr, leaves, branches, indices
        )
        if not bool(np.all(ok)):
            raise AssertionError("honest branch failed verification")
        stats["rbc_verify_s"] = time.perf_counter() - t0

        # delivery: fused decode + re-encode + root recheck over all N
        t0 = time.perf_counter()
        idx_arr = np.tile(np.arange(k), (n, 1))
        shard_arr = np.ascontiguousarray(full[:, :k, :])
        dec_data, dec_roots, _disp = self.crypto.decode_recheck_batch(
            idx_arr, shard_arr
        )
        delivered: List[bytes] = []
        for i in range(n):
            if dec_roots[i].tobytes() != roots[i]:
                raise AssertionError("decode root recheck failed")
            delivered.append(join_payload(dec_data[i]))
        stats["rbc_decode_s"] = time.perf_counter() - t0

        # ---- BBA: every instance gets input 1 (all RBCs delivered);
        # vals == {1} each round, so the instance decides when its real
        # threshold coin tosses 1 (docs/BBA-EN.md:163-181).
        #
        # Rounds run in DOUBLING BLOCKS — [0], [1], [2,3], [4..7], … —
        # each block one issue dispatch + one fused verify/combine
        # dispatch for every (instance, round) pair in it.  A round-r
        # coin share is a deterministic VUF of (epoch, proposer, r),
        # independent of any protocol state, so precomputing a block
        # for instances that may decide mid-block only wastes a
        # BOUNDED slice of issue mass (~N^2/4 expected, ~12% over the
        # sequential minimum — the undecided set halves each round
        # while block sizes double), and the number of sequential
        # device waves falls from E[max rounds] ~ log2 N + 2 to
        # O(log log-rounds): 7 rounds of N=128 take 4 waves x 2
        # dispatches instead of 7 x 3.
        t0 = time.perf_counter()
        coin_pub = self.coin.pub
        coin_vks = coin_pub.verification_keys
        rounds_used = 0
        coin_issues = 0
        coin_verifies = 0
        undecided = list(range(n))
        coin_bits: Dict[tuple, bool] = {}  # (inst, rnd) -> toss

        # the decrypt wave (N^2 share issues + N optimistic combines)
        # depends only on the RBC-delivered ciphertexts, never on the
        # coin — so its issue items ride BBA round 0's issue dispatch
        # and its combines ride round 0's fused verify/combine
        # dispatch: the whole wave costs ZERO extra device round-trips
        tpke_pub = self.tpke.pub
        tpke_vks = tpke_pub.verification_keys
        cts = [deserialize_ciphertext(v, group) for v in delivered]
        dec_items = []
        for ct in cts:
            context = self.tpke.context(ct)
            for nid in ids:
                sec = self.keys[nid].tpke_share
                dec_items.append(
                    (sec, ct.c1, context, tpke_vks[sec.index - 1])
                )
        # riding round 0 requires one shared Lagrange threshold;
        # distinct thresholds (non-default configs) fall back to a
        # separate decrypt wave after BBA
        fuse_dec = tpke_pub.threshold == coin_pub.threshold
        dec_subsets: List[list] = []

        def run_rounds(rnd_list, inst_list, dec=False):
            """Issue + fused verify/combine + toss for every
            (inst, rnd) pair — two dispatches total; fills coin_bits.
            With ``dec``, the decrypt wave's issues and combines ride
            the same two dispatches."""
            nonlocal coin_issues, coin_verifies
            items = []
            metas = []
            for rnd in rnd_list:
                for inst in inst_list:
                    coin_id = b"%d|%s|%d" % (
                        self.epoch, ids[inst].encode(), rnd,
                    )
                    pub, base, context = self.coin.group_params(coin_id)
                    metas.append((inst, rnd, coin_id, pub, base, context))
                    for nid in ids:
                        sec = self.keys[nid].coin_share
                        items.append(
                            (sec, base, context, coin_vks[sec.index - 1])
                        )
            n_coin = len(items)
            if dec:
                items = items + dec_items
            shares = issue_shares_batch(
                items, group=group, backend=backend, device=device, mesh=mesh
            )
            coin_issues += n_coin
            if dec:
                dec_shares = shares[n_coin:]
                dec_subsets.extend(
                    dec_shares[i * n : i * n + tpke_pub.threshold]
                    for i in range(len(cts))
                )
            # receivers verify the first f+1 pooled shares per
            # instance (the honest-case minimum) and combine the same
            # subset — one fused dispatch for both
            groups = []
            subsets = []
            for mi, (inst, rnd, coin_id, pub, base, context) in enumerate(
                metas
            ):
                sub = shares[mi * n : mi * n + (f + 1)]
                subsets.append(sub)
                groups.append((pub, base, sub, context))
            verdicts, _sigmas, _dec_vals = verify_and_combine_share_groups(
                groups,
                coin_pub.threshold,
                backend=backend,
                combine_only_sets=dec_subsets if dec else (),
                combine_only_group=group,
                device=device,
                mesh=mesh,
            )
            coin_verifies += sum(len(v) for v in verdicts)
            if not all(all(v) for v in verdicts):
                raise AssertionError("honest coin share failed CP check")
            for (inst, rnd, coin_id, *_rest), sub in zip(metas, subsets):
                # pure memo hit on the fused combine: no dispatch
                coin_bits[(inst, rnd)] = self.coin.toss(coin_id, sub)

        next_rnd = 0
        block = self.coin_block_initial
        coin_waves = 0
        while undecided and next_rnd < MAX_COIN_ROUNDS:
            rnds = range(
                next_rnd, min(next_rnd + block, MAX_COIN_ROUNDS)
            )
            run_rounds(rnds, undecided, dec=fuse_dec and next_rnd == 0)
            coin_waves += 1
            for rnd in rnds:
                rounds_used = rnd + 1
                undecided = [
                    inst
                    for inst in undecided
                    if not coin_bits[(inst, rnd)]
                ]
                if not undecided:
                    break
            next_rnd = rnds.stop
            if self.coin_block_doubling:
                block = block * 2 if next_rnd > 1 else 1
        if undecided:
            raise AssertionError(
                f"instances undecided after {MAX_COIN_ROUNDS} rounds"
            )
        stats["bba_s"] = time.perf_counter() - t0
        stats["bba_rounds"] = rounds_used
        stats["coin_waves"] = coin_waves
        stats["coin_issues"] = coin_issues
        stats["coin_verifies"] = coin_verifies
        # attribution note: with dec_fused=1 the decrypt wave's device
        # work is timed inside bba_s (it rides round 0's dispatches)
        # and decrypt_s measures only the memo-hit tail — not
        # comparable with pre-fusion artifacts' decrypt_s
        stats["dec_fused"] = float(fuse_dec)

        # ---- decrypt tail: combines are memo hits from round 0 ----
        t0 = time.perf_counter()
        if not fuse_dec:
            dec_shares = issue_shares_batch(
                dec_items, group=group, backend=backend, device=device, mesh=mesh
            )
            dec_subsets.extend(
                dec_shares[i * n : i * n + tpke_pub.threshold]
                for i in range(len(cts))
            )
            # optimistic combine (protocol.honeybadger._try_decrypt):
            # the ciphertext tag authenticates the KEM value, so the
            # honest case spends zero CP verifications on dec shares
            combine_shares_batch(
                dec_subsets,
                tpke_pub.threshold,
                group=group,
                backend=backend,
                device=device,
                mesh=mesh,
            )
        decrypted: Dict[str, List[bytes]] = {}
        for i, (ct, sub) in enumerate(zip(cts, dec_subsets)):
            plain = self.tpke.combine(ct, sub)  # memo hit + tag check
            decrypted[ids[i]] = deserialize_txs(plain)
        stats["decrypt_s"] = time.perf_counter() - t0
        stats["dec_issues"] = len(dec_items)

        # ---- commit: the reference dedup/ordering rule ----
        # (protocol.honeybadger._maybe_commit)
        t0 = time.perf_counter()
        seen: set = set()
        contributions: Dict[str, List[bytes]] = {}
        for proposer in sorted(decrypted):
            mine = []
            for tx in decrypted[proposer]:
                if tx not in seen:
                    seen.add(tx)
                    mine.append(tx)
            if mine:
                contributions[proposer] = mine
        self.committed_batches.append(Batch(contributions=contributions))
        stats["commit_s"] = time.perf_counter() - t0

        stats["epoch_s"] = time.perf_counter() - t_all
        self.epoch += 1
        self.last_stats = stats
        return stats

    def run_epochs(self, max_epochs: int = 50) -> int:
        """Drive epochs until every queue drains (or the cap)."""
        for e in range(max_epochs):
            self.run_epoch()
            if self.pending_tx_count() == 0:
                return e + 1
        return max_epochs


__all__ = ["LockstepCluster", "MAX_COIN_ROUNDS"]
