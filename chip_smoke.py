#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cleisthenes_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``; without a card it exits non-zero
before printing any result.  It prints, in order:

1. the card (``nvidia-smi`` name and power limit) and the seconds the
   kernels' build from ``cleisthenes_tpu_torch/csrc/*.cu`` took;
2. the kernel phase: every entry point — RS encode, shared and
   per-instance RS decode, ``sha256_rows``, the Merkle forest, the
   branch verify and the fused decode-recheck — on the card at the
   N=128/f=42 shapes of a real epoch and on an N=100/f=33 roster (whose
   forest pads leaves with the empty-leaf digest), each held byte for
   byte against its plain PyTorch version on the same inputs, with
   samples held against ``hashlib``.  At N=128 each line carries the
   kernel's time (CUDA events, median of 20 calls after a warm-up),
   the plain version's (median of 3), launches per call and the bound;
3. the main path: ``LockstepCluster(n=128, batch_size=10000,
   key_seed=77)`` with its defaults (the 'cuda' backend) commits
   3 epochs of random 64-byte transactions; every transaction must
   commit exactly once and every RBC entry point's launch count must
   rise during the epochs;
4. the ``{"kernels": [...]}`` JSON line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Tolerance everywhere is zero: all of this is exact integer math.  Any
failure exits non-zero before the last line.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM 3.35 TB/s.
# SHA-256 and the GF(2^8) table products are 32-bit integer ALU work,
# which the data sheet does not list: an SM issues 64 INT32 lanes per
# clock (half its 128 FP32 lanes), so 132 SMs x 64 x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit instructions sm_90a issues for SHA-256, counted in the SASS by
# ``python3 -m cleisthenes_tpu_torch.csrc.sass_ops``: 1,383 for one
# compression of words that do not fold (14 per round: 6 SHF, 4 LOP3 for
# the Sigmas, Ch and Maj, 4 adds; 10 per schedule word; 8 final adds),
# and 2,675 for the two compressions of a 65-byte Merkle node, whose
# second block is mostly constant padding.
SHA_OPS_PER_BLOCK = 1383
SHA_OPS_PER_NODE = 2675

N, F, BATCH, EPOCHS, KEY_SEED, TX_BYTES = 128, 42, 10000, 3, 77, 64


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def blocks(msg_len: int) -> int:
    """SHA-256 compressions for one message of msg_len bytes."""
    return (msg_len + 9 + 63) // 64


def bound(nbytes: int, ops: int):
    """(bound_ms, bound_by) from bytes moved and int32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int) -> float:
    """Median ms per call: CUDA events around each call after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def hashlib_root(shards) -> bytes:
    """Independent Merkle root of one (n, L) shard matrix (ops/merkle.py
    convention), with hashlib alone."""
    level = [hashlib.sha256(b"\x00" + row.tobytes()).digest() for row in shards]
    p = 1
    while p < len(level):
        p <<= 1
    level += [hashlib.sha256(b"cleisthenes-tpu:empty-leaf").digest()] * (p - len(level))
    while len(level) > 1:
        level = [
            hashlib.sha256(b"\x01" + level[i] + level[i + 1]).digest()
            for i in range(0, len(level), 2)
        ]
    return level[0]


def payload_len(n: int, batch: int) -> int:
    """Bytes of one proposer's serialized TPKE ciphertext in the epoch:
    c1 (32) + length (4) + the serialized tx list + tag (32)."""
    from cleisthenes_tpu_torch.protocol.keys import serialize_txs

    per_node = max(batch, n) // n
    return 32 + 4 + len(serialize_txs([bytes(TX_BYTES)] * per_node)) + 32


def kernel_phase(torch, n: int, f: int, batch: int, dev, timed: bool, rng) -> dict:
    """Every entry point at one roster's epoch shapes, on ``dev``, held
    against its plain version; returns {entry point: record}."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.ops import gf256
    from cleisthenes_tpu_torch.ops import rs_cuda as rs
    from cleisthenes_tpu_torch.ops import sha256_cuda as sh
    from cleisthenes_tpu_torch.ops.payload import split_payload

    k = n - 2 * f
    b = n
    L = split_payload(bytes(payload_len(n, batch)), k).shape[1]
    p = sh.next_pow2(n)
    depth = p.bit_length() - 1

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    data_np = rng.integers(0, 256, (b, k, L), dtype="uint8")
    data = put(data_np)
    enc = put(gf256.systematic_rs_matrix(n, k))
    full = rs.rs_encode(enc, data)
    shared_idx = sorted(rng.choice(n, k, replace=False).tolist())
    a_np = gf256.systematic_rs_matrix(n, k)
    dec = put(gf256.gf_mat_inv(a_np[shared_idx]))
    shards = full[:, shared_idx].contiguous()
    pats = [sorted(rng.choice(n, k, replace=False).tolist()) for _ in range(b)]
    decs = put(np.stack([gf256.gf_mat_inv(a_np[q]) for q in pats]))
    shards_pi = torch.stack([full[i, q] for i, q in enumerate(pats)]).contiguous()
    leaf_rows = full.reshape(b * n, L)
    forest = sh.build_forest(full)
    roots = forest[:, -1]
    # the N^2 ECHO branches, as protocol/spmd.py assembles them
    forest_np = forest.cpu().numpy()
    offs = [0]
    for lvl in range(depth):
        offs.append(offs[-1] + (p >> lvl))
    j = np.arange(n)
    br = np.stack(
        [forest_np[:, offs[d] + ((j >> d) ^ 1)] for d in range(depth)], 2
    ).reshape(b * n, depth, 32)
    leaves_np = leaf_rows.cpu().numpy().copy()
    idx_np = np.tile(j, b).astype(np.int64)
    expect = np.ones(b * n, dtype=bool)
    # tampered leaf, tampered sibling, wrong index: must verify False
    leaves_np[1, 0] ^= 0x01
    br[n + 2, depth - 1, 7] ^= 0x80
    idx_np[2 * n + 3] ^= 1
    expect[[1, n + 2, 2 * n + 3]] = False
    roots_rep = roots.repeat_interleave(n, 0).contiguous()
    leaves_v, br_v, idx_v = put(leaves_np), put(np.ascontiguousarray(br)), put(idx_np)

    L1 = L + 1
    cases = {
        "rs_encode": (
            lambda: rs.rs_encode(enc, data),
            lambda: rs.gf256_apply_plain(enc, data),
            b * k * L + n * k + b * n * L, 2 * b * (n - k) * k * L,
        ),
        "rs_decode": (
            lambda: rs.rs_decode(dec, shards),
            lambda: rs.gf256_apply_plain(dec, shards),
            2 * b * k * L + k * k, 2 * b * k * k * L,
        ),
        "rs_decode_per_instance": (
            lambda: rs.rs_decode(decs, shards_pi),
            lambda: rs.gf256_apply_plain(decs, shards_pi),
            2 * b * k * L + b * k * k, 2 * b * k * k * L,
        ),
        "sha256_rows": (
            lambda: sh.sha256_rows(leaf_rows, 0),
            lambda: sh.sha256_rows_plain(leaf_rows, 0),
            b * n * (L + 32), b * n * blocks(L1) * SHA_OPS_PER_BLOCK,
        ),
        "merkle_forest": (
            lambda: sh.build_forest(full),
            lambda: sh.build_forest_plain(full),
            b * n * L + b * (2 * p - 1) * 32,
            b * (n * blocks(L1) * SHA_OPS_PER_BLOCK + (p - 1) * SHA_OPS_PER_NODE),
        ),
        "merkle_verify": (
            lambda: sh.verify_branches(roots_rep, leaves_v, br_v, idx_v),
            lambda: sh.verify_branches_plain(roots_rep, leaves_v, br_v, idx_v),
            b * n * (32 + L + depth * 32 + 8 + 1),
            b * n * (blocks(L1) * SHA_OPS_PER_BLOCK + depth * SHA_OPS_PER_NODE),
        ),
        "decode_recheck": (
            lambda: rs.decode_recheck(dec, enc, shards),
            lambda: rs.decode_recheck_plain(dec, enc, shards),
            b * k * L + k * k + n * k + b * k * L + b * 32,
            2 * b * k * k * L + 2 * b * (n - k) * k * L
            + b * (n * blocks(L1) * SHA_OPS_PER_BLOCK + (p - 1) * SHA_OPS_PER_NODE),
        ),
    }
    out = {}
    for name, (kern, plain, nbytes, ops) in cases.items():
        before = sum(COUNTS.kernels.values())
        got = kern()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        per_call = sum(COUNTS.kernels.values()) - before
        want = plain()
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        equal = all(torch.equal(g, w) for g, w in zip(got_t, want_t))
        if all(g.shape == w.shape for g, w in zip(got_t, want_t)):
            err = max(
                int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                for g, w in zip(got_t, want_t)
            )
        else:
            err = float("inf")
        rec = {"equal": equal, "max_abs_err": float(err), "launches_per_call": per_call}
        # independent checks beyond the plain version
        if name in ("rs_decode", "rs_decode_per_instance"):
            rec["equal"] &= torch.equal(got, data)
        elif name == "sha256_rows":
            rows = leaf_rows.cpu().numpy()
            dig = got.cpu().numpy()
            for i in rng.choice(b * n, 64, replace=False):
                rec["equal"] &= dig[i].tobytes() == hashlib.sha256(b"\x00" + rows[i].tobytes()).digest()
        elif name == "merkle_forest":
            full_np = full.cpu().numpy()
            for i in (0, b - 1):
                rec["equal"] &= got[i, -1].cpu().numpy().tobytes() == hashlib_root(full_np[i])
        elif name == "merkle_verify":
            rec["equal"] &= bool(np.array_equal(got.cpu().numpy(), expect))
        elif name == "decode_recheck":
            rec["equal"] &= torch.equal(got[0], data) and torch.equal(got[1], roots)
        if timed:
            rec["kernel_ms"] = time_ms(torch, kern, 20)
            rec["plain_ms"] = time_ms(torch, plain, 3)
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops)
        line = (
            f"kernel {name} n={n} f={f} B={b} k={k} L={L}: "
            f"equal={rec['equal']} launches_per_call={per_call}"
        )
        if timed:
            line += (
                f" kernel_ms={rec['kernel_ms']} plain_ms={rec['plain_ms']}"
                f" bound_ms={rec['bound_ms']} ({rec['bound_by']})"
            )
        print(line, flush=True)
        out[name] = rec
    return out


def main_path(torch, n: int, batch: int, epochs: int, **overrides) -> dict:
    """The port's main path through its user entry point, with its
    defaults unless ``overrides`` (a CPU rehearsal passes
    device='cpu')."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster

    native = native_modpow_path()
    print(f"native modexp: {native}", flush=True)
    t0 = time.perf_counter()
    cluster = LockstepCluster(n=n, batch_size=batch, key_seed=KEY_SEED, **overrides)
    print(
        f"main_path: LockstepCluster(n={n}, batch_size={batch}, "
        f"key_seed={KEY_SEED}) backend={cluster.config.crypto_backend} "
        f"device={cluster.crypto.erasure.device} f={cluster.config.f} "
        f"setup_s={time.perf_counter() - t0}",
        flush=True,
    )
    total = (batch // n) * n * epochs
    txs = np.random.default_rng(13).integers(0, 256, (total, TX_BYTES), dtype=np.uint8)
    submitted = [row.tobytes() for row in txs]
    for tx in submitted:
        cluster.submit(tx)
    COUNTS.reset()
    epoch_s = []
    for e in range(epochs):
        s = cluster.run_epoch()
        epoch_s.append(s["epoch_s"])
        keys = ("propose_s", "rbc_encode_s", "rbc_verify_s", "rbc_decode_s",
                "bba_s", "decrypt_s", "commit_s", "epoch_s", "bba_rounds")
        print(f"epoch {e}: " + " ".join(f"{k_}={s[k_]}" for k_ in keys), flush=True)
    if cluster.crypto.erasure.device.type == "cuda":
        torch.cuda.synchronize()
    launches = {"kernels": dict(COUNTS.kernels), "sites": dict(COUNTS.sites)}
    committed = [tx for batch in cluster.committed_batches for tx in batch.tx_list()]
    if cluster.pending_tx_count() != 0:
        raise AssertionError(f"{cluster.pending_tx_count()} txs still pending")
    if len(committed) != len(submitted) or set(committed) != set(submitted):
        raise AssertionError(
            f"committed {len(committed)} txs ({len(set(committed))} distinct)"
            f" of {len(submitted)} submitted"
        )
    on_card = cluster.crypto.erasure.device.type == "cuda"
    for site in ("rs_encode", "merkle_forest", "merkle_verify", "decode_recheck"):
        if on_card and launches["sites"].get(site, 0) <= 0:
            raise AssertionError(f"main path never launched {site}: {launches}")
    print(
        f"main_path: txs={len(submitted)} committed_once={len(committed)} "
        f"epochs={epochs} epoch_p50_s={statistics.median(epoch_s)} "
        f"tx_per_s={len(committed) / sum(epoch_s)}",
        flush=True,
    )
    print(
        "waves: RBC (RS encode, Merkle forest, N^2 branch verify, fused "
        "decode-recheck) on the port's CUDA kernels; BBA coin and "
        f"decryption-share modexp on the host's native Montgomery kernel "
        f"({native}; the device modexp is slice 2)",
        flush=True,
    )
    print("launches_main_path " + json.dumps(launches, sort_keys=True), flush=True)
    return launches


def native_modpow_path() -> str:
    """Path of the host's native modexp library, which BBA runs on in
    this slice; raises if it did not build or load, since the main
    path's times would then measure Python's ``pow`` instead."""
    from cleisthenes_tpu_torch.native.build import load_error
    from cleisthenes_tpu_torch.ops.modmath import get_engine

    nat = get_engine("cpu")._nat
    if nat is None:
        raise RuntimeError(
            f"native modexp library did not load: {load_error('modpow256')}"
        )
    return nat._name


KERNELS = (
    # (entry point, source, TPU kernel replaced)
    ("rs_encode", "cleisthenes_tpu_torch/csrc/gf256.cu", "cleisthenes_tpu/ops/rs_xla.py:59"),
    ("rs_decode", "cleisthenes_tpu_torch/csrc/gf256.cu", "cleisthenes_tpu/ops/rs_xla.py:65"),
    ("decode_recheck", "cleisthenes_tpu_torch/ops/rs_cuda.py", "cleisthenes_tpu/ops/rs_xla.py:80"),
    ("sha256_rows", "cleisthenes_tpu_torch/csrc/sha256.cu", "cleisthenes_tpu/ops/sha256_xla.py:127"),
    ("merkle_forest", "cleisthenes_tpu_torch/csrc/sha256.cu", "cleisthenes_tpu/ops/sha256_xla.py:157"),
    ("merkle_verify", "cleisthenes_tpu_torch/csrc/sha256.cu", "cleisthenes_tpu/ops/sha256_xla.py:206"),
)


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch unavailable: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from cleisthenes_tpu_torch.csrc import build

    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    paths = build.build_all()
    for name in paths:
        build.load(name)
    print(
        f"build: {len(paths)} libraries from csrc/*.cu in "
        f"{time.perf_counter() - t0} s (nvcc {build.nvcc_path()})",
        flush=True,
    )
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(2026)
    records = kernel_phase(torch, N, F, BATCH, dev, True, rng)
    small = kernel_phase(torch, 100, 33, BATCH, dev, False, rng)
    bad = [
        f"{name}@n={n_}"
        for n_, recs in ((N, records), (100, small))
        for name, rec in recs.items()
        if not rec["equal"]
    ]
    print(
        "parity " + json.dumps(
            {name: rec["equal"] and small[name]["equal"] for name, rec in records.items()}
        ),
        flush=True,
    )
    if bad:
        print(f"chip_smoke: kernel disagrees with its plain version: {bad}", file=sys.stderr)
        return 1
    launches = main_path(torch, N, BATCH, EPOCHS)
    kernels = []
    for name, source, replaces in KERNELS:
        rec = records[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches["sites"].get(name, 0),
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": None,
        })
    missing = [k_["name"] for k_ in kernels if k_["launches"] <= 0]
    if missing:
        print(f"chip_smoke: main path never launched {missing}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as exc:  # report, never print the ok line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
