"""What the benchmark records at the calls into the program's layers.

The port returns only its ledger, so the benchmark wraps, on the one
``LockstepCluster`` it drives, the calls its epoch makes into each layer
and keeps what they return: each proposal's ciphertext (propose), the
epoch's shards, Merkle roots and decoded proposals (RBC), every coin toss
(BBA), every decrypted proposal (threshold decryption).  The wrappers
replace attributes of the cluster's own service objects and engine; the
program's modules are not touched.  With tracing on, each wrapped call is
also a ``torch.profiler`` span, and the modexp engine's calls keep their
inputs for the roofline: the dual pow's rows, and on an engine of a wide
family (K12) also the rows of its pows, grouped and flat, as the calls
passed them.

Shards, roots and decoded proposals are kept for ``rbc_epochs`` epochs
of the window, drawn from the seed by reservoir sampling, because
working them out again costs about a second an epoch at N=128; coins and
plaintexts are kept for every epoch, as tuples of ints and bytes, which
the garbage collector stops tracking: what the benchmark holds must not
add to the collector's work in the window.
"""

from __future__ import annotations

import contextlib
import random
from typing import Dict, List


def _no_span(_name):
    return contextlib.nullcontext()


class Recorder:
    def __init__(self, seed: int, rbc_epochs: int, trace: bool, wide: bool = False) -> None:
        self.rng = random.Random(seed * 7919 + 17)
        self.rbc_epochs = rbc_epochs
        self.trace = trace
        self.wide = wide  # the engine runs a wide family (K12)
        self.epoch = -1
        self.sampling = False  # only window and drain epochs are sampled
        self.window = False  # inside the timed window
        self._seen = 0
        self.rbc: Dict[int, dict] = {}
        self.tosses: Dict[int, Dict[bytes, bool]] = {}
        self.plain: Dict[int, list] = {}
        self.cts: Dict[int, list] = {}
        self.verify_shapes: List[tuple] = []
        self.dual_rows: List[tuple] = []
        self.pow_groups: List[list] = []  # a wide engine's grouped calls
        self.pow_rows: List[tuple] = []  # a wide engine's flat calls
        self._in_decode = False
        if trace:
            from torch.profiler import record_function

            self.span = record_function
        else:
            self.span = _no_span

    # -- epoch bookkeeping, called by the harness around run_epoch ----

    def begin_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.tosses[epoch] = {}
        self.plain[epoch] = []
        self.cts[epoch] = []
        if not self.sampling:
            return
        i = self._seen
        self._seen += 1
        if i < self.rbc_epochs:
            self.rbc[epoch] = {}
            return
        j = self.rng.randrange(i + 1)
        if j < self.rbc_epochs:
            del self.rbc[sorted(self.rbc)[j]]
            self.rbc[epoch] = {}

    def _rbc_slot(self):
        return self.rbc.get(self.epoch)

    # -- the wrappers ---------------------------------------------------

    def install(self, cluster, engine) -> None:
        tpke, coin, crypto = cluster.tpke, cluster.coin, cluster.crypto
        erasure, merkle = crypto.erasure, crypto.merkle
        rec = self

        encrypt = tpke.encrypt

        def encrypt_w(msg, *a, **kw):
            with rec.span("propose.encrypt"):
                ct = encrypt(msg, *a, **kw)
            rec.cts[rec.epoch].append((ct.c1, ct.c2, ct.tag))
            return ct

        encode_batch = erasure.encode_batch

        def encode_w(data):
            with rec.span("rbc.encode"):
                full = encode_batch(data)
            slot = rec._rbc_slot()
            if slot is not None and not rec._in_decode:
                slot["full"] = full
            return full

        build_batch = merkle.build_batch

        def build_w(shards):
            with rec.span("rbc.forest"):
                trees = build_batch(shards)
            slot = rec._rbc_slot()
            if slot is not None and not rec._in_decode:
                slot["roots"] = [t.root for t in trees]
            return trees

        verify_batch = merkle.verify_batch

        def verify_w(roots, leaves, branches, indices):
            with rec.span("rbc.verify"):
                ok = verify_batch(roots, leaves, branches, indices)
            if rec.trace and rec.window:
                rec.verify_shapes.append((leaves.shape[0], leaves.shape[1], branches.shape[1]))
            return ok

        decode_recheck = crypto.decode_recheck_batch

        def decode_w(indices, shards):
            rec._in_decode = True
            try:
                with rec.span("rbc.decode"):
                    out = decode_recheck(indices, shards)
            finally:
                rec._in_decode = False
            slot = rec._rbc_slot()
            if slot is not None:
                slot["decoded"], slot["decoded_roots"] = out[0], out[1]
            return out

        toss = coin.toss

        def toss_w(coin_id, shares):
            bit = toss(coin_id, shares)
            rec.tosses[rec.epoch][coin_id] = bit
            return bit

        combine = tpke.combine

        def combine_w(ct, shares):
            with rec.span("decrypt.combine"):
                pt = combine(ct, shares)
            rec.plain[rec.epoch].append((ct.c1, ct.c2, ct.tag, pt))
            return pt

        tpke.encrypt = encrypt_w
        erasure.encode_batch = encode_w
        merkle.build_batch = build_w
        merkle.verify_batch = verify_w
        crypto.decode_recheck_batch = decode_w
        coin.toss = toss_w
        tpke.combine = combine_w
        if engine is not None and self.trace:
            self._install_engine(engine)

    def _install_engine(self, engine) -> None:
        rec = self
        dual = engine.dual_pow_batch
        grouped = engine.pow_batch_grouped
        pow_batch = engine.pow_batch

        def dual_w(u1, e1, u2, e2):
            with rec.span("engine.dual_pow"):
                out = dual(u1, e1, u2, e2)
            if rec.window:
                rec.dual_rows.append((u1, e1, u2, e2))
            return out

        def grouped_w(groups):
            with rec.span("engine.pow_grouped"):
                out = grouped(groups)
            if rec.wide and rec.window:
                rec.pow_groups.append(groups)
            return out

        def pow_w(bases, exps):
            with rec.span("engine.pow"):
                out = pow_batch(bases, exps)
            if rec.wide and rec.window:
                rec.pow_rows.append((bases, exps))
            return out

        engine.dual_pow_batch = dual_w
        engine.pow_batch_grouped = grouped_w
        engine.pow_batch = pow_w

    def wide_pow_calls(self) -> List[tuple]:
        """(bases, exponents) of each of the window's wide pow calls, a
        grouped call flattened as the engine flattens it."""
        flat = [([b for b, exps in groups for _ in exps], [e for _, exps in groups for e in exps])
                for groups in self.pow_groups]
        return [(b, e) for b, e in flat + self.pow_rows if e]

    @staticmethod
    def uninstall(engine) -> None:
        """Drop the engine's wrappers: the cached engine outlives one run,
        the cluster's objects do not."""
        for name in ("dual_pow_batch", "pow_batch_grouped", "pow_batch"):
            if name in vars(engine):
                delattr(engine, name)
