#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cleisthenes_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``; without a card it exits non-zero
before printing any result.  It prints, in order:

1. the card (``nvidia-smi`` name and power limit), the seconds the
   kernels' build from ``cleisthenes_tpu_torch/csrc/*.cu`` took, the
   binary and s8 tensor-core rates that ``csrc/mma_probe.py`` measures
   (bit products a second) and K11's b1 yardstick from them
   (``b1_yardstick``: the b1 reading scaled by NVIDIA's published s8 peak
   over the s8 reading);
2. the kernel phases: every RBC entry point — RS encode, shared and
   per-instance RS decode, ``sha256_rows``, the Merkle forest, the
   branch verify and the fused decode-recheck — on the card at the
   N=128/f=42 shapes of a real epoch and on an N=100/f=33 roster (whose
   forest pads leaves with the empty-leaf digest), each held byte for
   byte against its plain PyTorch version on the same inputs, with
   samples held against ``hashlib``; the modexp entry points — the
   comb at both epochs' round-0 shapes (N=128: 257 bases, g with
   32,768 exponents and 256 bases with 256 each; N=512: 1,025 bases, g
   with 524,288 and 1,024 with 1,024 each; one table per base as the
   engine sends them), the dual pow at both (22,016 and 350,208 rows,
   half of them Lagrange rows u2=1, e2=0), both also untimed on ragged
   batches (1, 33, 127, 129 rows; a base with a single exponent), the
   generic pow (5,504 items) and the Montgomery product (16,384) — held
   against their plain versions (timed once after a warm-up at N=512)
   and against Python's ``pow`` on a sample, in the default group and,
   parity only, in a second 256-bit group; the
   GF(2^16) codec (K11) at the N=512/f=170 epoch's shapes (B=512,
   k=172, n=512, 64 symbols: first a decode by the identity, which pins
   the bit order of the tensor-core fragments, then encode, shared and
   per-instance decode, with the 512-leaf forest and the D=9 branch
   verify) and, parity only, at N=300/f=99, encode held also against the
   host ``Cpu16ErasureCoder``, K11 and the forest held to one launch a
   call; untimed, the paths of both that no epoch takes (``edge_phase``:
   K11 past one lifted span, at an odd symbol count and off a 4-byte
   boundary; forests of rows staged by byte loads and of rows past the
   64 KB staging budget); and the wide pow and dual pow (K12) in the
   384-bit (batch 2048), 768-bit (512) and 2048-bit (128) groups, at the
   GROUP384 epoch's own calls (a pow of 98,304 exponents over 257
   bases, a dual pow of 22,016 rows, half of them Lagrange rows) and,
   untimed, on ragged batches (1, 33, 2,047 and 98,303 rows at 384
   bits; 1, 33 and 511 at 768; 1, 33 and 127 at 2048), every batch
   starting with edge rows (bases 0, 1, p - 1; exponents 0, 1, q,
   all-ones; e2 = 0 beside e1 != 0), held against their plain versions
   and Python's ``pow``.  The timed lines carry the kernel's time (CUDA
   events, median of 20 calls after a warm-up; 5 for the 2048-bit
   group), the plain version's (median of 3), launches per call and the
   bound (for a pow or dual pow, from the fewest Montgomery products a
   fixed-window method needs for the run's exponents; for the comb, the
   fewest a comb of any width 2..8 per base needs, ``least_comb``; for
   K11 also the tensor-core bound, its bit products at the b1 yardstick
   against its bytes);
3. three paths through ``LockstepCluster`` with its defaults (the
   'cuda' backend), each committing 3 epochs of random 64-byte
   transactions, every one exactly once, with the launch counts set to
   zero just before and read just after:
   - N=128 (``n=128, batch_size=10000, key_seed=77``): the RBC entry
     points, the comb (share issue) and the dual pow (CP verify with
     the fused Lagrange combine) must launch, and on every path none of
     ``OFF_PATH``.  Each epoch's line splits
     ``bba_s`` by the modexp engine's own ``stats``;
   - N=512 (``batch_size=4096``): the GF(2^16) codec's encode and
     decode, the forest, the branch verify, the comb and the dual pow
     must launch;
   - GROUP384 (N=128, every exponentiation in the 384-bit group): the
     engine must be the card's, the wide pow and dual pow must launch
     and the 256-bit comb, dual pow and pow must not;
   and after every timed path, one N=512 epoch of a fresh cluster under
   ``torch.profiler``, which prints the device time per kernel and per
   memcpy direction and the share of the epoch the device was busy (or
   that the profiler gave no device events);
4. the decrypt-combine phase, after the N=128 path: one more epoch of
   fresh transactions, whose 128 decryption-share sets (43 shares each)
   are kept from its fused verify/combine call and combined again
   through ``combine_shares_batch(..., backend='cuda')`` — the unfused
   decrypt branch, one generic-pow dispatch — must give the values the
   epoch's fused dispatch left in the combine memo;
5. the seconds the run took after the build, the ``{"kernels": [...]}``
   JSON line (K1-K12; ``OFF_PATH``'s kernels, mont_mul and sha256_rows,
   which no path launches, carry the paths' 0 with their kernel-phase
   launches and the reason beside it; K11's and K5's entries carry both
   their bounds), the card line again, and last
   ``{"ok": true, "device": {...}}``.

Tolerance everywhere is zero: all of this is exact integer math.  Any
failure exits non-zero before the last line.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM 3.35 TB/s.
# SHA-256 and the GF(2^8) table products are 32-bit integer ALU work,
# which the data sheet does not list: an SM issues 64 INT32 lanes per
# clock (half its 128 FP32 lanes), so 132 SMs x 64 x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# dense INT8 tensor-core peak of the same data sheet, 1,979 TOPS, at two
# operations a multiply-accumulate (K11's b1 yardstick scales by it)
S8_PUBLISHED_MACS_PER_S = 1979e12 / 2
# 32-bit instructions sm_90a issues for SHA-256, counted in the SASS by
# ``python3 -m cleisthenes_tpu_torch.csrc.sass_ops``: 1,383 for one
# compression of words that do not fold (14 per round: 6 SHF, 4 LOP3 for
# the Sigmas, Ch and Maj, 4 adds; 10 per schedule word; 8 final adds),
# and 2,675 for the two compressions of a 65-byte Merkle node, whose
# second block is mostly constant padding.
SHA_OPS_PER_BLOCK = 1383
SHA_OPS_PER_NODE = 2675
# the second 256-bit safe prime of the repository's group tests
P2 = 0x93A40B764F1F5026ADA7C38AA3EF4EE81E01E89F9FE80837B1E370913DA99F13
# the wide groups of bench.py's wide-group section, with its batches:
# the 384-bit GROUP384 prime, RFC 2409 Oakley group 1 (768-bit), RFC 3526
# MODP group 14 (2048-bit)
P384 = int(
    "F7E12F10702F5E910CBEC741E84E2608D29D655C81BF7BF093B38ED4267537C9"
    "249C8FE3A20A0C68153E6DAA5F9A23F3",
    16,
)
OAKLEY1 = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A63A3620FFFFFFFFFFFFFFFF",
    16,
)
MODP14 = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
# (bits, p, batch)
WIDE_GROUPS = ((384, P384, 2048), (768, OAKLEY1, 512), (2048, MODP14, 128))

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


def gf2_bit_products(m: int, k: int, cols: int) -> int:
    """Bit products of K11's function as a lifted GF(2) product: 16 m
    lifted rows x 16 k lifted columns x cols symbol columns (the zeros
    the kernel pads k with are not work the function needs)."""
    return 16 * m * 16 * k * cols


def b1_yardstick(b1_rate: float, s8_rate: float) -> float:
    """The binary tensor cores' peak, in bit products a second, from the
    ``mma.sync`` readings of ``mma_probe.mma_rates``: NVIDIA publishes no
    b1 rate, and the probe reads s8 below NVIDIA's published dense s8
    peak (``S8_PUBLISHED_MACS_PER_S``: on Hopper only wgmma reaches it),
    so the b1 reading scaled by that gap, or the reading itself if the
    gap ever closes."""
    return max(b1_rate, b1_rate * S8_PUBLISHED_MACS_PER_S / s8_rate)


def tc_bound(nbytes: int, bit_products: int, b1_rate: float):
    """(bound_ms, bound_by) of K11 on the binary tensor cores: bytes at
    the HBM rate against bit products at ``b1_rate`` (bit products a
    second, ``b1_yardstick``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = bit_products / b1_rate
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


def kernel_phase(torch, n: int, f: int, batch: int, dev, timed: bool, rng, b1_rate=None) -> dict:
    """Every entry point at one roster's epoch shapes, on ``dev``, held
    against its plain version; returns {entry point: record}.  Past 256
    validators the codec is GF(2^16) (K11 ``rs16_*`` on uint16 symbols,
    no fused decode-recheck), first decoding by the identity (the bit
    order of its tensor-core fragments), with a second bound on the
    binary tensor cores at ``b1_rate`` (``tc_bound_ms``); below, GF(2^8)
    (K1-K3).  K11 and the forest must make one launch a call."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.ops import gf256, gf65536
    from cleisthenes_tpu_torch.ops import rs16_cuda as rs16
    from cleisthenes_tpu_torch.ops import rs_cuda as rs
    from cleisthenes_tpu_torch.ops import sha256_cuda as sh
    from cleisthenes_tpu_torch.ops.payload import split_payload
    from cleisthenes_tpu_torch.ops.rs16 import Cpu16ErasureCoder

    k = n - 2 * f
    b = n
    L = split_payload(bytes(payload_len(n, batch)), k).shape[1]
    p = sh.next_pow2(n)
    depth = p.bit_length() - 1
    wide = n > 256
    field = gf65536 if wide else gf256
    # symbol bytes, int32 ops per multiply-accumulate (csrc/gf256.cu: table
    # product and XOR; for GF(2^16) the int-op yardstick of the log/exp
    # design K11 had before its tensor-core one, kept for comparison: log
    # sum, two minimums, XOR)
    sym, mac_ops = (2, 4) if wide else (1, 2)
    S = L // sym
    prefix = "rs16_" if wide else "rs_"
    encode, decode, apply_plain = (
        (rs16.rs16_encode, rs16.rs16_decode, rs16.gf65536_apply_plain) if wide
        else (rs.rs_encode, rs.rs_decode, rs.gf256_apply_plain)
    )

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    data_np = rng.integers(0, 256, (b, k, L), dtype="uint8")
    data = put(data_np.view(np.uint16) if wide else data_np)
    a_np = field.systematic_rs_matrix(n, k)
    enc = put(a_np)
    if wide:
        rs16.mark_systematic(enc, a_np)
    full_s = encode(enc, data)  # (b, n, S) symbols
    full = full_s.view(torch.uint8) if wide else full_s  # (b, n, L) bytes
    shared_idx = sorted(rng.choice(n, k, replace=False).tolist())
    dec = put(field.gf_mat_inv(a_np[shared_idx]))
    # survivors picked on the host (CUDA has no uint16 indexing kernel)
    full_np = full_s.cpu().numpy()
    shards = put(full_np[:, shared_idx])
    # a distinct erasure pattern per instance, so that a kernel reading
    # another instance's matrix cannot pass
    pats = [sorted(rng.choice(n, k, replace=False).tolist()) for _ in range(b)]
    decs = put(np.stack([field.gf_mat_inv(a_np[q]) for q in pats]))
    shards_pi = put(np.stack([full_np[i, q] for i, q in enumerate(pats)]))
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
    out = {}
    if wide:
        # the bit order of K11's fragments: a decode by the identity
        before = sum(COUNTS.kernels.values())
        got = decode(put(np.eye(k, dtype=np.uint16)), data)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        rec = {"equal": torch.equal(got.to(torch.int32), data.to(torch.int32)),
               "max_abs_err": 0.0, "launches_per_call": sum(COUNTS.kernels.values()) - before}
        print(f"kernel rs16_identity n={n} f={f} B={b} k={k} L={L}: equal={rec['equal']} "
              f"launches_per_call={rec['launches_per_call']}", flush=True)
        out["rs16_identity"] = rec
    cases = {
        prefix + "encode": (
            lambda: encode(enc, data),
            lambda: apply_plain(enc, data),
            b * k * L + sym * n * k + b * n * L, mac_ops * b * (n - k) * k * S,
        ),
        prefix + "decode": (
            lambda: decode(dec, shards),
            lambda: apply_plain(dec, shards),
            2 * b * k * L + sym * k * k, mac_ops * b * k * k * S,
        ),
        prefix + "decode_per_instance": (
            lambda: decode(decs, shards_pi),
            lambda: apply_plain(decs, shards_pi),
            2 * b * k * L + sym * b * k * k, mac_ops * b * k * k * S,
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
    }
    if not wide:
        cases["decode_recheck"] = (
            lambda: rs.decode_recheck(dec, enc, shards),
            lambda: rs.decode_recheck_plain(dec, enc, shards),
            b * k * L + k * k + n * k + b * k * L + b * 32,
            2 * b * k * k * L + 2 * b * (n - k) * k * L
            + b * (n * blocks(L1) * SHA_OPS_PER_BLOCK + (p - 1) * SHA_OPS_PER_NODE),
        )
    # bit products of K11's lifted GF(2) product
    tc_bits = {
        prefix + "encode": gf2_bit_products(n - k, k, b * S),
        prefix + "decode": gf2_bit_products(k, k, b * S),
        prefix + "decode_per_instance": gf2_bit_products(k, k, b * S),
    } if wide else {}
    for name, (kern, plain, nbytes, ops) in cases.items():
        before = sum(COUNTS.kernels.values())
        got = kern()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        per_call = sum(COUNTS.kernels.values()) - before
        want = plain()
        # compared as int32: CUDA has no uint16 comparison kernels
        got_t = tuple(g.to(torch.int32) for g in (got if isinstance(got, tuple) else (got,)))
        want_t = tuple(w.to(torch.int32) for w in (want if isinstance(want, tuple) else (want,)))
        equal = all(torch.equal(g, w) for g, w in zip(got_t, want_t))
        if all(g.shape == w.shape for g, w in zip(got_t, want_t)):
            err = max(
                int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                for g, w in zip(got_t, want_t)
            )
        else:
            err = float("inf")
        rec = {"equal": equal, "max_abs_err": float(err), "launches_per_call": per_call}
        if dev.type == "cuda" and (name in tc_bits or name == "merkle_forest"):
            rec["equal"] &= per_call == 1  # one launch a call
        # independent checks beyond the plain version
        if name.endswith(("_decode", "_decode_per_instance")):
            rec["equal"] &= torch.equal(got_t[0], data.to(torch.int32))
        elif name == "rs16_encode":
            host = Cpu16ErasureCoder(n, k)
            full_np = full.cpu().numpy()
            for i in (0, b - 1):
                rec["equal"] &= bool(np.array_equal(host.encode(data_np[i]), full_np[i]))
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
            if name in tc_bits:
                rec["int_bound_ms"] = rec["bound_ms"]
                rec["tc_bound_ms"], rec["tc_bound_by"] = tc_bound(nbytes, tc_bits[name], b1_rate)
                rec["bit_products"] = tc_bits[name]
        line = (
            f"kernel {name} n={n} f={f} B={b} k={k} L={L}: "
            f"equal={rec['equal']} launches_per_call={per_call}"
        )
        if timed:
            line += (
                f" kernel_ms={rec['kernel_ms']} plain_ms={rec['plain_ms']}"
                f" bound_ms={rec['bound_ms']} ({rec['bound_by']})"
            )
            if name in tc_bits:
                line += (
                    f" tc_bound_ms={rec['tc_bound_ms']} ({rec['tc_bound_by']}, "
                    f"{rec['bit_products']} bit products at {b1_rate} a second)"
                )
        print(line, flush=True)
        out[name] = rec
    return out


def edge_phase(torch, dev, rng) -> dict:
    """Untimed parity on the paths of K11 and K5 that no epoch's shapes
    take: K11 with k past one lifted span of 176 symbols (N=640/f=213,
    k=214: two spans, lifted again for every tile), with an odd symbol
    count (no paired loads or stores) and with x one symbol off a 4-byte
    boundary (no paired loads at an even count); the forest with rows
    staged by byte loads (a length, or a start, off 16 bytes) and with
    rows past the 64 KB staging budget, hashed from global memory.
    Encode, shared and per-instance decode must equal their plain
    versions and give back the data; each forest its plain version and
    ``hashlib_root``; each call one launch.  Returns {case: record}."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.ops import gf65536 as gf
    from cleisthenes_tpu_torch.ops import rs16_cuda as rs16
    from cleisthenes_tpu_torch.ops import sha256_cuda as sh

    def put(a, offset=False):
        """``a`` on ``dev``, one element past an aligned start if ``offset``."""
        a = np.ascontiguousarray(a)
        if not offset:
            return torch.from_numpy(a).to(dev)
        buf = torch.from_numpy(np.concatenate([np.zeros(1, a.dtype), a.ravel()])).to(dev)
        return buf[1:].view(a.shape)

    out = {}

    def held(name, kern, plain, check):
        before = sum(COUNTS.kernels.values())
        got = kern()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        per_call = sum(COUNTS.kernels.values()) - before
        want = plain()
        equal = (torch.equal(got.to(torch.int32), want.to(torch.int32))
                 and (per_call == 1 or dev.type == "cpu") and check(got))
        out[name] = {"equal": equal, "launches_per_call": per_call}
        print(f"edge {name} {tuple(got.shape)}: equal={equal} launches_per_call={per_call}",
              flush=True)
        return got

    for tag, n, k, b, S, off in (("two_spans", 640, 214, 3, 40, False),
                                 ("two_spans_odd_S", 640, 214, 2, 37, False),
                                 ("odd_S", 300, 102, 3, 33, False),
                                 ("x_offset", 512, 172, 2, 64, True)):
        a = gf.systematic_rs_matrix(n, k)
        enc = put(a)
        rs16.mark_systematic(enc, a)
        x_np = rng.integers(0, gf.ORDER, (b, k, S)).astype(np.uint16)
        x = put(x_np, off)
        x32 = torch.from_numpy(x_np.astype(np.int32)).to(dev)
        full = held(f"rs16_encode@{tag}", lambda: rs16.rs16_encode(enc, x),
                    lambda: rs16.gf65536_apply_plain(enc, x),
                    lambda got: torch.equal(got.to(torch.int32)[:, :k], x32))
        full_np = full.cpu().numpy()
        idx = sorted(rng.choice(n, k, replace=False).tolist())
        dec, shards = put(gf.gf_mat_inv(a[idx])), put(full_np[:, idx], off)
        held(f"rs16_decode@{tag}", lambda: rs16.rs16_decode(dec, shards),
             lambda: rs16.gf65536_apply_plain(dec, shards),
             lambda got: torch.equal(got.to(torch.int32), x32))
        pats = [sorted(rng.choice(n, k, replace=False).tolist()) for _ in range(b)]
        decs = put(np.stack([gf.gf_mat_inv(a[q]) for q in pats]))
        shards_pi = put(np.stack([full_np[i, q] for i, q in enumerate(pats)]), off)
        held(f"rs16_decode_per_instance@{tag}", lambda: rs16.rs16_decode(decs, shards_pi),
             lambda: rs16.gf65536_apply_plain(decs, shards_pi),
             lambda got: torch.equal(got.to(torch.int32), x32))
    for tag, b, n, L, off in (("byte_loads", 3, 7, 1001, False),
                              ("start_offset", 2, 9, 1024, True),
                              ("global_rows", 2, 3, 65601, False)):
        shards_np = rng.integers(0, 256, (b, n, L), dtype=np.uint8)
        shards = put(shards_np, off)
        held(f"merkle_forest@{tag}", lambda: sh.build_forest(shards),
             lambda: sh.build_forest_plain(shards),
             lambda got: all(got[i, -1].cpu().numpy().tobytes() == hashlib_root(shards_np[i])
                             for i in range(b)))
    return out


def _digits(np, exps, w: int):
    """(B, nb) big-endian exponent bytes -> (B, ceil(8 nb / w)) digits in
    base 2^w, most significant first."""
    bits = np.unpackbits(exps, axis=1)
    bits = np.pad(bits, ((0, 0), ((-bits.shape[1]) % w, 0)))
    return bits.reshape(bits.shape[0], -1, w) @ (1 << np.arange(w - 1, -1, -1))


def _tail(np, nz):
    """Per row: digit positions from the first nonzero one to the end."""
    return np.where(nz.any(1), nz.shape[1] - nz.argmax(1), 0)


def least_pow(np, exps):
    """Per row, the fewest Montgomery products of b^e by a fixed w-bit
    window, w = 1..7 (w = 1 is the binary method): into the domain, the
    table b^2..b^(2^w - 1), w squarings per digit after the top one, a
    multiply per further nonzero digit, out of the domain; none for
    e = 0."""
    def window(w):
        nz = _digits(np, exps, w) != 0
        nd = _tail(np, nz)
        return np.where(nd > 0, 2 + (2**w - 2) + w * (nd - 1) + nz.sum(1) - 1, 0)

    return np.minimum.reduce([window(w) for w in range(1, 8)])


def least_dual(np, e1, e2):
    """Per row, the fewest Montgomery products of u1^e1 u2^e2 by w-bit
    windows over both exponents at once (one shared chain of squarings):
    a joint table of every u1^i u2^j (w = 1..3; w = 1 is Shamir's trick)
    and a multiply per position where either digit is nonzero, or a
    table per base (w = 1..7) and a multiply per nonzero digit of each;
    both bases into the domain, the result out.  A row whose other
    exponent is 0 is one pow (``least_pow``)."""
    def window(w, joint):
        n1, n2 = _digits(np, e1, w) != 0, _digits(np, e2, w) != 0
        nd = _tail(np, n1 | n2)
        if joint:
            table, mults = 2 * (2**w - 2) + (2**w - 1) ** 2, (n1 | n2).sum(1)
        else:
            table, mults = 2 * (2**w - 2), n1.sum(1) + n2.sum(1)
        return np.where(nd > 0, 3 + table + w * (nd - 1) + mults - 1, 0)

    big = np.iinfo(np.int64).max
    return np.minimum.reduce(
        [window(w, True) for w in range(1, 4)]
        + [window(w, False) for w in range(1, 8)]
        + [np.where(e2.any(1), big, least_pow(np, e1)),
           np.where(e1.any(1), big, least_pow(np, e2))]
    )


def pow_products(np, base, exp) -> int:
    """Montgomery products K7's function needs for these inputs:
    ``least_pow``, plus one where a 33rd byte folds into the domain."""
    n = least_pow(np, exp)
    return int((n + np.where(n > 0, base[:, 32] != 0, 0)).sum())


def dual_products(np, u1, e1, u2, e2) -> int:
    """... and K8's: ``least_dual``, plus a product per 33rd-byte fold."""
    n = least_dual(np, e1, e2)
    fold = (u1[:, 32] != 0).astype(np.int64) + (u2[:, 32] != 0)
    return int((n + np.where(n > 0, fold, 0)).sum())


def least_comb(np, bases, exps, rows) -> int:
    """The fewest Montgomery products of a fixed-base comb for these
    inputs, its width w = 2..8 chosen per base: per base, into the domain
    (one more product where a 33rd byte folds), the chain's w (r - 1)
    squarings and the table's r (2^w - 2) products, for r = ceil(b / w)
    rows of the base's widest exponent of b bits; per exponent, a multiply
    per nonzero w-bit digit after the first and one out of the domain."""
    n_b, m = bases.shape[0], exps.shape[0]
    nzb = exps != 0
    first = np.where(nzb.any(1), nzb.argmax(1), 32)
    top = exps[np.arange(m), np.minimum(first, 31)].astype(np.int64)
    ebits = np.where(first < 32, 8 * (31 - first) + np.floor(np.log2(np.maximum(top, 1))).astype(np.int64) + 1, 0)
    bbits = np.zeros(n_b, np.int64)
    np.maximum.at(bbits, rows, ebits)
    into = 1 + (bases[:, 32] != 0)
    best = None
    for w in range(2, 9):
        per_exp = np.zeros(m, np.int64)
        for lo in range(0, m, 1 << 17):  # bounded memory at the N=512 shapes
            bits = np.unpackbits(exps[lo : lo + (1 << 17)], axis=1)
            bits = np.pad(bits, ((0, 0), ((-256) % w, 0)))
            nz = bits.reshape(bits.shape[0], -1, w).any(2).sum(1)
            per_exp[lo : lo + len(nz)] = np.maximum(nz - 1, 0) + 1
        r = np.maximum(-(-bbits // w), 1)
        cost = into + w * (r - 1) + r * (2**w - 2) + np.bincount(rows, per_exp, n_b)
        best = cost if best is None else np.minimum(best, cost)
    return int(best.sum())


# the 256-bit epochs' round-0 modexp calls (tpke.py issue_shares_batch and
# verify_and_combine_share_groups): the comb's issue wave — g with G
# exponents, B more bases with E exponents each — and the CP-verify/combine
# dual pow of D rows, half of them Lagrange rows; key: (G, B, E, D)
MODEXP_SHAPES = {"n128": (32768, 256, 256, 22016), "n512": (524288, 1024, 1024, 350208)}
# untimed ragged batches of both: exponents over three bases (the last with
# one exponent) and dual-pow rows
MODEXP_RAGGED = (1, 33, 127, 129)


def comb_inputs(rnd, p: int, n_g: int, n_b: int, g_b: int, single: bool = False):
    """(bases, exponents, rows) of a comb call as the engine sends it, a
    table per distinct base and a row index per exponent: g (4) with n_g
    exponents, then the edge bases (0, 1, p - 1, p + 5, 2^264 - 1) and
    random ones up to n_b more with g_b exponents each, and with
    ``single`` one more base with one exponent; the first exponents are
    the edge exponents (0, 1, q, 2^256 - 1, 3)."""
    q = (p - 1) // 2
    edge_b = [0, 1, p - 1, p + 5, 2**264 - 1]
    bases = [4] + (edge_b + [rnd.randrange(p) for _ in range(n_b)])[:n_b]
    rows = [0] * n_g + [1 + i // g_b for i in range(n_b * g_b)]
    if single:
        rows.append(len(bases))
        bases.append(rnd.randrange(p))
    m = len(rows)
    exps = ([0, 1, q, 2**256 - 1, 3] + [rnd.randrange(q) for _ in range(m)])[:m]
    return bases, exps, rows


def dual_inputs(rnd, p: int, n: int):
    """(u1, e1, u2, e2) of n dual-pow rows: the edge rows first (bases 0,
    1, p - 1, p + 5, 2^264 - 1; exponents 0, 1, q, 2^256 - 1, 3), CP rows,
    then as many Lagrange rows (u2 = 1, e2 = 0), as the engine sends them."""
    q = (p - 1) // 2
    half = n // 2
    u1 = ([0, 1, p - 1, p + 5, 2**264 - 1] + [rnd.randrange(p) for _ in range(n)])[:n]
    e1 = ([0, 1, q, 2**256 - 1, 3] + [rnd.randrange(q) for _ in range(n)])[:n]
    u2 = [rnd.randrange(p) for _ in range(half)] + [1] * (n - half)
    e2 = [rnd.randrange(q) for _ in range(half)] + [0] * (n - half)
    return u1, e1, u2, e2


def modexp_phase(torch, p: int, dev, timed: bool, rnd) -> dict:
    """The modexp entry points on ``dev`` in the group mod ``p``, each held
    against its plain version and against Python's ``pow`` on a sample.
    When ``timed``: the comb (K9) and the dual pow (K8) at both epochs'
    shapes (``MODEXP_SHAPES``; keys ``pow_grouped``, ``dual_pow`` for
    N=128 and ``<entry>@n512``), the generic pow (5,504 items) and the
    Montgomery product (16,384), then both K8 and K9 untimed on the ragged
    batches (``<entry>@B<n>``); else small, parity only.  Returns {entry
    point: record}."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.csrc.sass_ops import MONT_OPS
    from cleisthenes_tpu_torch.ops import modexp_cuda as mx
    from cleisthenes_tpu_torch.ops.modmath import (
        bytes33_to_ints, exps_to_bytes, ints_to_bytes33,
    )

    q = (p - 1) // 2
    spec = mx.mont_spec(p)
    r_inv = pow(2**256, -1, p)

    def put(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    def as_ints(a):
        return [int.from_bytes(r.tobytes(), "big") for r in a]

    def comb_case(bases, exps, rows):
        arrs = (ints_to_bytes33([b % p for b in bases]), exps_to_bytes(exps),
                np.array(rows, dtype=np.int32))
        t = tuple(put(a) for a in arrs)
        return (
            lambda: mx.pow_fused_grouped(*t, spec),
            lambda: mx.pow_fused_grouped_plain(*t, spec),
            arrs[0].size + arrs[1].size + arrs[2].nbytes + len(rows) * 33,
            lambda: least_comb(np, arrs[0], arrs[1], arrs[2]),
            lambda i: pow(bases[rows[i]], exps[i], p),
        )

    def dual_case(u1, e1, u2, e2):
        arrs = (ints_to_bytes33(u1), exps_to_bytes(e1), ints_to_bytes33(u2), exps_to_bytes(e2))
        t = tuple(put(a) for a in arrs)
        return (
            lambda: mx.dual_pow_fused(*t, spec),
            lambda: mx.dual_pow_fused_plain(*t, spec),
            len(u1) * (3 * 33 + 2 * 32),
            lambda: dual_products(np, *arrs),
            lambda i: pow(u1[i], e1[i], p) * pow(u2[i], e2[i], p) % p,
        )

    cases = {}  # name: (kernel, plain, bytes, products, pow of item i, plain reps)
    shapes = MODEXP_SHAPES.items() if timed else [("small", (1100, 16, 70, 1024))]
    for tag, (n_g, n_b, g_b, n_dual) in shapes:
        suffix = "" if tag in ("n128", "small") else f"@{tag}"
        reps = 1 if tag == "n512" else 3
        cases["pow_grouped" + suffix] = comb_case(*comb_inputs(rnd, p, n_g, n_b, g_b)) + (reps,)
        cases["dual_pow" + suffix] = dual_case(*dual_inputs(rnd, p, n_dual)) + (reps,)
        if suffix:
            continue
        n_pow, n_mont = (5504, 16384) if timed else (1024, 1024)
        edge_b, edge_e = [0, 1, p - 1, p + 5, 2**264 - 1], [0, 1, q, 2**256 - 1, 3]
        pb = edge_b + [rnd.randrange(p) for _ in range(n_pow - 5)]
        pe = edge_e + [rnd.randrange(q) for _ in range(n_pow - 5)]
        pow_np = (ints_to_bytes33(pb), exps_to_bytes(pe))
        pw = tuple(put(a) for a in pow_np)
        cases["pow"] = (
            lambda: mx.pow_fused(*pw, spec),
            lambda: mx.pow_fused_plain(*pw, spec),
            n_pow * (33 + 32 + 33), lambda: pow_products(np, *pow_np),
            lambda i: pow(pb[i], pe[i], p), 3,
        )
        xs = [rnd.randrange(p) for _ in range(n_mont)]
        ys = [rnd.randrange(p) for _ in range(n_mont)]
        mm_ = (put(ints_to_bytes33(xs)), put(ints_to_bytes33(ys)))
        cases["mont_mul"] = (
            lambda: mx.mont_mul_batch(*mm_, spec),
            lambda: mx.mont_mul_batch_plain(*mm_, spec),
            n_mont * 3 * 33, lambda: n_mont,
            lambda i: xs[i] * ys[i] * r_inv % p, 3,
        )
    if timed:
        for n in MODEXP_RAGGED:
            # n = 1: g alone with one exponent; else g, one more base and
            # a base with a single exponent
            rest = n - 1
            comb = comb_inputs(rnd, p, rest - rest // 3, 1, rest // 3, True) if n > 1 else \
                comb_inputs(rnd, p, 1, 0, 0)
            cases[f"pow_grouped@B{n}"] = comb_case(*comb) + (0,)
            cases[f"dual_pow@B{n}"] = dual_case(*dual_inputs(rnd, p, n)) + (0,)

    out = {}
    for name, (kern, plain, nbytes, products, want, reps) in cases.items():
        before = sum(COUNTS.kernels.values())
        got = kern()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        per_call = sum(COUNTS.kernels.values()) - before
        plain_out = plain()
        equal = torch.equal(got, plain_out)
        err = int((got.to(torch.int64) - plain_out.to(torch.int64)).abs().max())
        res = bytes33_to_ints(got.cpu().numpy().reshape(-1, 33))
        n = len(res)
        idx = sorted(set(range(min(n, 6))) | set(range(max(0, n - 3), n))
                     | set(rnd.sample(range(n), min(n, 40))))
        sample_ok = all(res[i] == want(i) for i in idx)
        rec = {"equal": equal and sample_ok, "max_abs_err": float(err),
               "launches_per_call": per_call}
        line = (
            f"kernel {name} p={hex(p)[:10]}.. shape={tuple(got.shape)}: "
            f"equal={rec['equal']} launches_per_call={per_call}"
        )
        if timed and reps:
            n_prod = products()
            rec["kernel_ms"] = time_ms(torch, kern, 20)
            rec["plain_ms"] = time_ms(torch, plain, reps)
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, n_prod * MONT_OPS)
            rec["products"] = n_prod
            line += (
                f" kernel_ms={rec['kernel_ms']} plain_ms={rec['plain_ms']} (median of {reps})"
                f" bound_ms={rec['bound_ms']} ({rec['bound_by']}, {n_prod} products)"
                f" x_bound={rec['kernel_ms'] / rec['bound_ms']}"
            )
        print(line, flush=True)
        out[name] = rec
    return out


def wide_rows(rnd, p: int, n: int, lagrange_half: bool):
    """(u1, e1, u2, e2) lists of n dual-pow rows mod p (the pow takes u1,
    e1): the edge rows first — bases 0, 1 and p - 1; exponents 0, 1, q
    and all-ones; e2 = 0 beside e1 != 0 with u2 != 1, a Lagrange row
    (u2 = 1, e2 = 0), e1 = 0 beside e2 != 0 — then random rows, the
    second half of them Lagrange rows when ``lagrange_half``."""
    from cleisthenes_tpu_torch.ops import modexp_cuda as mx

    q = (p - 1) // 2
    ones = (1 << (8 * mx.family_bytes(p))) - 1
    edges = [
        (0, 0, p - 1, ones), (1, 1, 0, q), (p - 1, q, 1, 0),
        (rnd.randrange(p), ones, rnd.randrange(2, p), 0), (0, q, 5, 1),
        (p - 1, ones, p - 1, ones), (1, 0, rnd.randrange(p), q),
    ][:n]
    half = n // 2 if lagrange_half else n
    rows = edges + [
        (rnd.randrange(p), rnd.randrange(q))
        + ((rnd.randrange(p), rnd.randrange(q)) if i < half else (1, 0))
        for i in range(len(edges), n)
    ]
    return tuple(list(c) for c in zip(*rows))


# the GROUP384 epoch's K12 calls: round 0's issue wave (g with EPOCH_G
# exponents, EPOCH_BASES more bases with EPOCH_PER_BASE each) flattened into
# one wide pow, and the CP-verify/combine dual pow of EPOCH_DUAL rows
EPOCH_G, EPOCH_BASES, EPOCH_PER_BASE, EPOCH_DUAL = 32768, 256, 256, 22016
# untimed ragged batches per wide group: not a multiple of a team, a warp or
# a block of any family's plan
WIDE_RAGGED = {384: (1, 33, 2047, 98303), 768: (1, 33, 511), 2048: (1, 33, 127)}


def epoch_pow_rows(rnd, p: int):
    """(bases, exponents) of the GROUP384 epoch's round-0 wide pow: the
    edge rows of ``wide_rows`` in place of g's first exponents."""
    q = (p - 1) // 2
    bases = [4] + [rnd.randrange(p) for _ in range(EPOCH_BASES)]
    u1, e1, _u2, _e2 = wide_rows(rnd, p, 7, False)
    flat_b = u1 + [bases[0]] * (EPOCH_G - 7) + [
        b for b in bases[1:] for _ in range(EPOCH_PER_BASE)
    ]
    return flat_b, e1 + [rnd.randrange(q) for _ in range(len(flat_b) - 7)]


def wide_phase(torch, dev, rnd) -> dict:
    """The K12 entry points, pow and dual pow, in every wide family, each
    held byte for byte against its plain version and against Python's
    ``pow`` on the edge rows and a sample:

    - timed at ``bench.py``'s shapes (``WIDE_GROUPS``: the 384-bit
      GROUP384 prime at batch 2048, the 768-bit RFC 2409 Oakley group 1
      at 512, the 2048-bit RFC 3526 MODP-14 group at 128): keys
      ``<entry>@<bits>``;
    - timed at the GROUP384 epoch's own calls: round 0's issue wave
      flattened into one wide pow (98,304 exponents over 257 bases: g
      with 32,768, 256 bases with 256 each) and the CP-verify/combine
      dual pow (22,016 rows, half of them Lagrange rows u2 = 1, e2 = 0):
      keys ``<entry>@384_epoch``;
    - untimed on the ragged batches of ``WIDE_RAGGED``: keys
      ``<entry>@<bits>_B<n>``.

    The bounds count ``least_pow``/``least_dual`` products times
    ``WIDE_BOUND_OPS``.  Returns {key: record}."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.csrc.sass_ops import WIDE_BOUND_OPS
    from cleisthenes_tpu_torch.ops import modexp_cuda as mx

    jobs = []  # (key, bits, p, rows, timed, reps)
    for bits, p, batch in WIDE_GROUPS:
        jobs.append((f"{bits}", bits, p, wide_rows(rnd, p, batch, True), True,
                     5 if bits == 2048 else 20))
        for n in WIDE_RAGGED[bits]:
            jobs.append((f"{bits}_B{n}", bits, p, wide_rows(rnd, p, n, True), False, 0))
        if bits == 384:
            jobs.append(("384_epoch", bits, p, epoch_pow_rows(rnd, p), True, 20))
            jobs.append(("384_epoch", bits, p, wide_rows(rnd, p, EPOCH_DUAL, True), True, 20))
    out = {}
    for tag, bits, p, rows, timed, reps in jobs:
        vb = mx.family_bytes(p)
        spec = mx.wide_spec(p, vb)

        def le(xs, _vb=vb):
            return np.frombuffer(b"".join(x.to_bytes(_vb, "little") for x in xs), np.uint8).reshape(-1, _vb)

        def be(xs, _vb=vb):
            return np.frombuffer(b"".join(x.to_bytes(_vb, "big") for x in xs), np.uint8).reshape(-1, _vb)

        arrs = [f(x) for f, x in zip((le, be, le, be), rows)]
        t = [torch.from_numpy(a.copy()).to(dev) for a in arrs]
        batch = len(rows[0])
        sample = sorted(set(range(min(7, batch))) | set(range(max(0, batch - 3), batch))
                        | set(rnd.sample(range(batch), min(batch, 22))))
        cases = {
            "wide_pow_fused": (
                lambda: mx.wide_pow_fused(t[0], t[1], spec),
                lambda: mx.pow_fused_plain(t[0], t[1], spec),
                lambda res: all(res[i] == pow(rows[0][i], rows[1][i], p) for i in sample),
                batch * 3 * vb, lambda: int(least_pow(np, arrs[1]).sum()),
            ),
        }
        if len(rows) == 4:
            cases["wide_dual_pow_fused"] = (
                lambda: mx.wide_dual_pow_fused(*t, spec),
                lambda: mx.dual_pow_fused_plain(*t, spec),
                lambda res: all(
                    res[i] == pow(rows[0][i], rows[1][i], p) * pow(rows[2][i], rows[3][i], p) % p
                    for i in sample
                ),
                batch * 5 * vb, lambda: int(least_dual(np, arrs[1], arrs[3]).sum()),
            )
            if tag == "384_epoch":
                del cases["wide_pow_fused"]  # the epoch's pow is the job before
        for name, (kern, plain, sample_ok, nbytes, products) in cases.items():
            before = sum(COUNTS.kernels.values())
            got = kern()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            per_call = sum(COUNTS.kernels.values()) - before
            want = plain()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            res = [int.from_bytes(r.tobytes(), "little") for r in got.cpu().numpy()]
            rec = {
                "equal": torch.equal(got, want) and sample_ok(res),
                "max_abs_err": float(err),
                "launches_per_call": per_call,
            }
            line = (
                f"kernel {name} bits={bits} B={batch} words={spec.nw} "
                f"shape={tag}: equal={rec['equal']} launches_per_call={per_call}"
            )
            if timed:
                n_prod = products()
                rec["kernel_ms"] = time_ms(torch, kern, reps)
                rec["plain_ms"] = time_ms(torch, plain, 3)
                rec["bound_ms"], rec["bound_by"] = bound(nbytes, n_prod * WIDE_BOUND_OPS[spec.nw])
                rec["products"] = n_prod
                line += (
                    f" kernel_ms={rec['kernel_ms']} plain_ms={rec['plain_ms']} "
                    f"bound_ms={rec['bound_ms']} ({rec['bound_by']}, {n_prod} products) "
                    f"x_bound={rec['kernel_ms'] / rec['bound_ms']}"
                )
            print(line, flush=True)
            out[f"{name}@{tag}"] = rec
    return out


def engine_split(engines, before) -> dict:
    """Splits ``bba_s`` by the 'cuda' modexp engines' own ``stats``
    since ``before``: seconds inside their batch calls (``engine_s``),
    of which ``device_s`` went from upload to the result's download
    (copies, kernel and the wait on it) and the rest to the host's
    int<->bytes packing; the remainder of ``bba_s`` is the protocol's
    host Python.  The host engine's calls (the propose wave's
    encryptions, subgroup checks) are not counted."""
    out = {"engine_calls": 0, "engine_s": 0.0, "device_s": 0.0}
    for eng, old in zip(engines, before):
        out["engine_calls"] += eng.stats["calls"] - old["calls"]
        out["engine_s"] += eng.stats["engine_s"] - old["engine_s"]
        out["device_s"] += eng.stats["device_s"] - old["device_s"]
    out["packing_s"] = out["engine_s"] - out["device_s"]
    return out


def main_path(torch, n: int, batch: int, epochs: int, waves: str, sites,
              absent=(), **overrides):
    """One path through the port's user entry point, with its defaults
    unless ``overrides`` (``group``; a CPU rehearsal passes
    device='cpu'): every transaction must commit once, every entry point
    of ``sites`` must launch and none of ``absent``, and on the card
    every modexp engine must be the device's (no fallback to the host).
    Returns (launch counts, the cluster)."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.ops.modmath import get_engine_degraded
    from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster

    native = native_modpow_path()
    print(f"native modexp: {native}", flush=True)
    t0 = time.perf_counter()
    cluster = LockstepCluster(n=n, batch_size=batch, key_seed=KEY_SEED, **overrides)
    print(
        f"main_path: LockstepCluster(n={n}, batch_size={batch}, "
        f"key_seed={KEY_SEED}) backend={cluster.config.crypto_backend} "
        f"device={cluster.config.device} f={cluster.config.f} "
        f"group_bits={cluster.tpke.group.p.bit_length()} "
        f"codec={type(cluster.crypto.erasure).__name__} "
        f"setup_s={time.perf_counter() - t0}",
        flush=True,
    )
    total = (batch // n) * n * epochs
    txs = np.random.default_rng(13).integers(0, 256, (total, TX_BYTES), dtype=np.uint8)
    submitted = [row.tobytes() for row in txs]
    for tx in submitted:
        cluster.submit(tx)
    on_card = torch.device(cluster.config.device).type == "cuda"
    engines = [
        get_engine_degraded(cluster.crypto.engine_backend, gp, cluster.crypto.device)
        for gp in {cluster.tpke.group, cluster.coin.group}
    ]
    if on_card and any(eng.backend != "cuda" for eng in engines):
        raise AssertionError("a modexp engine of the path is not the card's")
    COUNTS.reset()
    epoch_s = []
    for e in range(epochs):
        before = [dict(eng.stats) for eng in engines]
        s = cluster.run_epoch()
        epoch_s.append(s["epoch_s"])
        keys = ("propose_s", "rbc_encode_s", "rbc_verify_s", "rbc_decode_s",
                "bba_s", "decrypt_s", "commit_s", "epoch_s", "bba_rounds")
        split = engine_split(engines, before)
        split["bba_host_python_s"] = s["bba_s"] - split["engine_s"]
        print(
            f"epoch {e}: " + " ".join(f"{k_}={s[k_]}" for k_ in keys)
            + "".join(f" {k_}={v}" for k_, v in split.items()),
            flush=True,
        )
    if on_card:
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
    for site in sites:
        if on_card and launches["sites"].get(site, 0) <= 0:
            raise AssertionError(f"main path never launched {site}: {launches}")
    for site in (*absent, *OFF_PATH):
        if launches["sites"].get(site, 0):
            raise AssertionError(f"main path launched {site}: {launches}")
    print(
        f"main_path: txs={len(submitted)} committed_once={len(committed)} "
        f"epochs={epochs} epoch_p50_s={statistics.median(epoch_s)} "
        f"tx_per_s={len(committed) / sum(epoch_s)}",
        flush=True,
    )
    print("waves: " + waves, flush=True)
    print("launches_main_path " + json.dumps(launches, sort_keys=True), flush=True)
    return launches, cluster


def epoch_dec_sets(cluster, batch: int) -> list:
    """One more epoch of fresh transactions, after the main path's, with
    the fused verify/combine call wrapped to keep the decryption-share
    sets (threshold shares per proposer) it combines; returns them."""
    import numpy as np

    from cleisthenes_tpu_torch.protocol import spmd

    sets = []
    real = spmd.verify_and_combine_share_groups

    def keep(*args, **kwargs):
        sets.extend(kwargs.get("combine_only_sets", ()))
        return real(*args, **kwargs)

    txs = np.random.default_rng(14).integers(0, 256, (batch, TX_BYTES), dtype=np.uint8)
    for row in txs:
        cluster.submit(row.tobytes())
    spmd.verify_and_combine_share_groups = keep
    try:
        cluster.run_epoch()
    finally:
        spmd.verify_and_combine_share_groups = real
    return sets


def decrypt_combine_phase(torch, cluster, dev) -> dict:
    """The unfused decrypt branch (protocol/spmd.py, distinct
    thresholds): an extra epoch's decryption-share sets combined through
    ``combine_shares_batch(..., backend='cuda')``, one generic-pow (K7)
    dispatch, after clearing the combine memo that the epoch's fused
    dual-pow dispatch filled.  Every value must equal that memo entry
    and the host engine's combine."""
    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.ops import tpke

    sets = epoch_dec_sets(cluster, cluster.config.batch_size)
    thr = cluster.tpke.pub.threshold
    group = cluster.tpke.group
    keys = [
        (group, thr, tuple((sh.index, sh.d) for sh in sorted(sub, key=lambda x: x.index)[:thr]))
        for sub in sets
    ]
    memo = [tpke._COMBINE_MEMO.get(k) for k in keys]
    tpke._COMBINE_MEMO.clear()
    COUNTS.reset()
    t0 = time.perf_counter()
    got = tpke.combine_shares_batch(sets, thr, group=group, backend="cuda", device=dev)
    secs = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {"kernels": dict(COUNTS.kernels), "sites": dict(COUNTS.sites)}
    tpke._COMBINE_MEMO.clear()
    host = tpke.combine_shares_batch(sets, thr, group=group, backend="cpu")
    found = sum(v is not None for v in memo)
    ok = (
        len(got) == len(sets) == found
        and got == memo == host
        and (dev.type == "cpu" or launches["sites"].get("pow", 0) > 0)
    )
    print(
        f"decrypt_combine: sets={len(sets)} threshold={thr} terms={len(sets) * thr} "
        f"memo_hits_before={found} equal_to_memo={got == memo} equal_to_host={got == host} "
        f"call_s={secs} launches={json.dumps(launches, sort_keys=True)}",
        flush=True,
    )
    if not ok:
        raise AssertionError("decrypt combine on the card disagrees or never launched pow")
    return launches


def _merged_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for st, en in sorted(intervals):
        if cur_e is None or st > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def profile_split(events, window) -> dict:
    """From the device's profiler events (name, start_us, end_us): device
    microseconds per kernel name and per memcpy direction, and the share
    of ``window`` (start_us, end_us) in which the device was busy."""
    kernels, copies, spans = {}, {}, []
    for name, st, en in events:
        if en <= window[0] or st >= window[1]:
            continue
        spans.append((max(st, window[0]), min(en, window[1])))
        if name.startswith("Memcpy"):
            key = next((d for d in ("HtoD", "DtoH", "DtoD") if d in name), name)
            copies[key] = copies.get(key, 0.0) + en - st
        else:
            kernels[name] = kernels.get(name, 0.0) + en - st
    busy = _merged_us(spans)
    return {"kernels_us": kernels, "copies_us": copies, "busy_us": busy,
            "window_us": window[1] - window[0],
            "busy_share": busy / (window[1] - window[0]) if window[1] > window[0] else 0.0}


def profile_phase(torch, n: int, batch: int, **overrides) -> dict:
    """One epoch of a fresh ``LockstepCluster(n, batch)`` (defaults unless
    ``overrides``) under ``torch.profiler``: prints the device time per
    kernel and per memcpy direction and the share of the epoch the device
    was busy.  Every transaction must commit once.  If the profiler gives
    no device events it says so and returns an empty split."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function

    from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster

    cluster = LockstepCluster(n=n, batch_size=batch, key_seed=KEY_SEED, **overrides)
    txs = [row.tobytes() for row in
           np.random.default_rng(15).integers(0, 256, (batch, TX_BYTES), dtype=np.uint8)]
    before = len(cluster.committed_batches)
    for tx in txs:
        cluster.submit(tx)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_epoch"):
            s = cluster.run_epoch()
        if torch.device(cluster.config.device).type == "cuda":
            torch.cuda.synchronize()
    committed = [tx for b_ in cluster.committed_batches[before:] for tx in b_.tx_list()]
    if sorted(committed) != sorted(txs) or cluster.pending_tx_count():
        raise AssertionError(f"profiled epoch committed {len(committed)} of {len(txs)} txs")
    evs = prof.events()

    def on_device(e) -> bool:
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    # the annotation's host range is the window; its device-side twin,
    # which spans the epoch on the card's timeline, is not device work
    window = next(((e.time_range.start, e.time_range.end) for e in evs
                   if e.name == "chip_smoke_epoch" and not on_device(e)), None)
    dev_evs = [(e.name, e.time_range.start, e.time_range.end) for e in evs
               if on_device(e) and e.name != "chip_smoke_epoch"]
    if window is None or not dev_evs:
        print(f"profile: no device events from the profiler (events={len(evs)}); "
              f"epoch_s={s['epoch_s']}", flush=True)
        return {}
    split = profile_split(dev_evs, window)
    for name, us in sorted(split["kernels_us"].items(), key=lambda kv: -kv[1]):
        print(f"profile kernel_us={us} {name}", flush=True)
    for name, us in sorted(split["copies_us"].items()):
        print(f"profile memcpy {name} us={us}", flush=True)
    print(
        f"profile: epoch_s={s['epoch_s']} window_us={split['window_us']} "
        f"device_busy_us={split['busy_us']} device_busy_share={split['busy_share']} "
        f"kernels_us={sum(split['kernels_us'].values())} "
        f"memcpy_us={sum(split['copies_us'].values())} txs={len(committed)}",
        flush=True,
    )
    return split


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
    # (entry point, source, TPU kernel replaced); the launch counts of
    # pow come from the decrypt-combine phase, of gf65536_apply from the
    # N=512 path, of the wide kernels from the GROUP384 path, of the rest
    # (OFF_PATH's too: 0) from the N=128 path
    ("rs_encode", "cleisthenes_tpu_torch/csrc/gf256.cu", "cleisthenes_tpu/ops/rs_xla.py:59"),
    ("rs_decode", "cleisthenes_tpu_torch/csrc/gf256.cu", "cleisthenes_tpu/ops/rs_xla.py:65"),
    ("decode_recheck", "cleisthenes_tpu_torch/ops/rs_cuda.py", "cleisthenes_tpu/ops/rs_xla.py:80"),
    ("sha256_rows", "cleisthenes_tpu_torch/csrc/sha256.cu", "cleisthenes_tpu/ops/sha256_xla.py:127"),
    ("merkle_forest", "cleisthenes_tpu_torch/csrc/sha256.cu", "cleisthenes_tpu/ops/sha256_xla.py:157"),
    ("merkle_verify", "cleisthenes_tpu_torch/csrc/sha256.cu", "cleisthenes_tpu/ops/sha256_xla.py:206"),
    ("pow", "cleisthenes_tpu_torch/csrc/modexp.cu", "cleisthenes_tpu/ops/modmath.py:551"),
    ("dual_pow", "cleisthenes_tpu_torch/csrc/modexp.cu", "cleisthenes_tpu/ops/modmath.py:592"),
    ("pow_grouped", "cleisthenes_tpu_torch/csrc/modexp.cu", "cleisthenes_tpu/ops/modmath.py:639"),
    ("mont_mul", "cleisthenes_tpu_torch/csrc/modexp.cu", "cleisthenes_tpu/ops/modmath.py:504"),
    ("gf65536_apply", "cleisthenes_tpu_torch/csrc/gf65536.cu",
     "cleisthenes_tpu/ops/rs16_xla_kernels.py:47"),
    ("wide_pow_fused", "cleisthenes_tpu_torch/csrc/modexp_wide.cu",
     "cleisthenes_tpu/ops/modmath.py:351"),
    ("wide_dual_pow_fused", "cleisthenes_tpu_torch/csrc/modexp_wide.cu",
     "cleisthenes_tpu/ops/modmath.py:378"),
)

# entry points that no epoch path launches, with the reason: every path
# must leave them at 0 (``main_path``), and their kernel-phase calls,
# which hold them to their plain versions, must have launched them
OFF_PATH = {
    "mont_mul": "its only callers are the tests: every modexp kernel runs its "
                "Montgomery products inside its own launch",
    "sha256_rows": "the reference runs sha256_batch only inside build_forest and "
                   "verify_branches, whose work merkle_forest and merkle_verify "
                   "now do whole; the protocol's other rows hash on the host "
                   "(ops/hashrows.py)",
}

WAVES_128 = (
    "propose (N TPKE encryptions) on the host's native Montgomery kernel; "
    "RBC (RS encode, Merkle forest, N^2 branch verify, fused decode-recheck) "
    "on the port's CUDA kernels; BBA coin and decryption-share issue on the "
    "CUDA comb (pow_grouped), CP verify with the fused Lagrange and decrypt "
    "combines on the CUDA dual pow (dual_pow); decrypt tail (memo hits, tag "
    "checks) and commit on the host"
)
WAVES_512 = (
    "propose on the host's native Montgomery kernel; RBC on the GF(2^16) "
    "codec (rs16_encode, and delivery as rs16_decode + rs16_encode + Merkle "
    "forest in three calls), the 512-leaf forest and the N^2 branch verify "
    "(D=9) on the port's CUDA kernels; BBA and decryption shares on the comb "
    "and the dual pow; decrypt tail and commit on the host"
)
WAVES_384 = (
    "propose in GROUP384 on the host (Python pow: the native kernel is "
    "256-bit only); RBC on the GF(2^8) kernels; BBA coin and decryption-share "
    "issue on the 384-bit wide pow (wide_pow, a grouped call flattened: the "
    "comb is 256-bit only), CP verify and the fused combines on the wide dual "
    "pow (wide_dual_pow); decrypt tail and commit on the host"
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

    from cleisthenes_tpu_torch.csrc import build, mma_probe

    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        probe = pool.submit(mma_probe.build_probe)  # its nvcc beside the kernels'
        paths = build.build_all()
        probe.result()
    for name in paths:
        build.load(name)
    print(
        f"build: {len(paths)} libraries from csrc/*.cu and the mma probe in "
        f"{time.perf_counter() - t0} s (nvcc {build.nvcc_path()})",
        flush=True,
    )
    from cleisthenes_tpu_torch.ops.modmath import GROUP384
    from cleisthenes_tpu_torch.ops.modmath import P as P_DEFAULT

    rates = mma_probe.mma_rates(torch)
    b1_rate = b1_yardstick(rates["b1_m16n8k256_and_popc"], rates["s8_m16n8k32"])
    print(f"mma rates (bit products a second, measured): {json.dumps(rates)}", flush=True)
    print(f"b1 yardstick (the b1 reading x published s8 {S8_PUBLISHED_MACS_PER_S} / "
          f"measured s8): {b1_rate}", flush=True)
    t_start = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(2026)
    rnd = random.Random(2026)
    phases = {
        "n128": kernel_phase(torch, N, F, BATCH, dev, True, rng),
        "n100": kernel_phase(torch, 100, 33, BATCH, dev, False, rng),
        "modexp": modexp_phase(torch, P_DEFAULT, dev, True, rnd),
        "modexp_p2": modexp_phase(torch, P2, dev, False, rnd),
        "n512": kernel_phase(torch, 512, 170, 4096, dev, True, rng, b1_rate),
        "n300": kernel_phase(torch, 300, 99, 4096, dev, False, rng, b1_rate),
        "edges": edge_phase(torch, dev, rng),
        "wide": wide_phase(torch, dev, rnd),
    }
    bad = [
        f"{name}@{where}"
        for where, recs in phases.items()
        for name, rec in recs.items()
        if not rec["equal"]
    ]
    print(
        "parity " + json.dumps(
            {f"{name}@{where}": rec["equal"] for where, recs in phases.items()
             for name, rec in recs.items()}
        ),
        flush=True,
    )
    if bad:
        print(f"chip_smoke: kernel disagrees with its plain version: {bad}", file=sys.stderr)
        return 1
    print(f"kernel phases done at {time.perf_counter() - t_start} s", flush=True)
    launches, cluster = main_path(
        torch, N, BATCH, EPOCHS, WAVES_128,
        sites=("rs_encode", "merkle_forest", "merkle_verify", "decode_recheck",
               "pow_grouped", "dual_pow"),
    )
    dec_launches = decrypt_combine_phase(torch, cluster, dev)
    del cluster
    launches_512, _ = main_path(
        torch, 512, 4096, EPOCHS, WAVES_512,
        sites=("rs16_encode", "rs16_decode", "merkle_forest", "merkle_verify",
               "pow_grouped", "dual_pow"),
    )
    launches_384, _ = main_path(
        torch, N, BATCH, EPOCHS, WAVES_384, group=GROUP384,
        sites=("rs_encode", "merkle_forest", "merkle_verify", "decode_recheck",
               "wide_pow", "wide_dual_pow"),
        absent=("pow_grouped", "dual_pow", "pow"),
    )
    # last, so that its epoch shifts nothing the timed paths share (the
    # combine memo's fill, the profiler's host objects)
    profile_phase(torch, 512, 4096)
    counts = dict(launches["sites"])
    counts["pow"] = dec_launches["sites"].get("pow", 0)
    counts["gf65536_apply"] = launches_512["kernels"].get("gf65536_apply", 0)
    for name in ("wide_pow_fused", "wide_dual_pow_fused"):
        counts[name] = launches_384["kernels"].get(name, 0)
    records = dict(phases["n128"])
    records.update(phases["modexp"])
    records["gf65536_apply"] = dict(phases["n512"]["rs16_encode"])
    k11 = records["gf65536_apply"]
    if k11["tc_bound_ms"] < k11["int_bound_ms"]:
        k11["bound_ms"], k11["bound_by"] = k11["tc_bound_ms"], k11["tc_bound_by"]
    for name in ("wide_pow_fused", "wide_dual_pow_fused"):
        records[name] = phases["wide"][f"{name}@384_epoch"]
    kernels = []
    for name, source, replaces in KERNELS:
        rec = records[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": counts.get(name, 0),
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": None,
        })
        if name in OFF_PATH:
            kernels[-1]["kernel_phase_launches"] = rec["launches_per_call"]
            kernels[-1]["off_path"] = OFF_PATH[name]
        if name == "gf65536_apply":
            kernels[-1]["bounds"] = {"int_ops_ms": rec["int_bound_ms"],
                                     "tensor_core_ms": rec["tc_bound_ms"]}
        elif name == "merkle_forest":
            n512 = phases["n512"]["merkle_forest"]
            kernels[-1]["bounds"] = {"n128_ms": rec["bound_ms"], "n512_ms": n512["bound_ms"]}
            kernels[-1]["ms_n512"] = n512["kernel_ms"]
    missing = [k_["name"] for k_ in kernels if k_["launches"] <= 0 and k_["name"] not in OFF_PATH]
    if missing:
        print(f"chip_smoke: main path never launched {missing}", file=sys.stderr)
        return 1
    unheld = [k_["name"] for k_ in kernels
              if k_["name"] in OFF_PATH and k_["kernel_phase_launches"] <= 0]
    if unheld:
        print(f"chip_smoke: the kernel phase never launched {unheld}", file=sys.stderr)
        return 1
    print(f"total_s={time.perf_counter() - t_start} (after the build)", flush=True)
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
