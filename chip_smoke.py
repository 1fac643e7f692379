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
   per-instance RS decode (after a decode by the identity, which pins
   the bit order of the codec's tensor-core fragments), ``sha256_rows``,
   the Merkle forest, the branch verify and the fused decode-recheck —
   on the card at the N=128/f=42 shapes of a real epoch and on an
   N=100/f=33 roster (whose forest pads leaves with the empty-leaf
   digest), each held byte for byte against its plain PyTorch version on
   the same inputs, with samples held against ``hashlib``, the GF(2^8)
   codec's calls with their bit products and tensor-core bound; the
   modexp entry points — the
   comb at both epochs' round-0 shapes (N=128: 257 bases, g with
   32,768 exponents and 256 bases with 256 each; N=512: 1,025 bases, g
   with 524,288 and 1,024 with 1,024 each; one table per base as the
   engine sends them), the dual pow at both (22,016 and 350,208 rows,
   half of them Lagrange rows u2=1, e2=0), both also untimed on ragged
   batches (1, 33, 127, 129 rows; a base with a single exponent), the
   generic pow (5,504 items, the decrypt-combine shape; untimed also at
   both of its plans' boundary, on all-zero, all-short and
   length-ordered exponents and on ragged batches of 1, 31, 33 and 4,099
   rows: ``pow_edge_rows``) and the Montgomery product (16,384) — held
   against their plain versions (timed once after a warm-up at N=512)
   and against Python's ``pow`` on a sample, in the default group and,
   parity only, in a second 256-bit group; the
   GF(2^16) codec (K11) at the N=512/f=170 epoch's shapes (B=512,
   k=172, n=512, 64 symbols: first a decode by the identity, which pins
   the bit order of the tensor-core fragments, then encode, shared and
   per-instance decode, with the 512-leaf forest and the D=9 branch
   verify) and, parity only, at N=300/f=99, encode held also against the
   host ``Cpu16ErasureCoder``, every codec call, forest and verify held
   to one launch a call (K3 to three); untimed, the paths that no epoch
   takes (``edge_phase``: the GF(2^8) codec at k = 1, 31, 32, 33, 44 and
   200, an odd parity row count, odd L and x off a 4-byte boundary; K11
   past one lifted span, at an odd symbol count and off a 4-byte
   boundary; forests of rows staged by byte loads and of rows past the
   64 KB staging budget; the branch verify at D=0, on 1,001-byte leaves
   off alignment, on >64 KB leaves, at N=100's 10,000 branches and with
   index bits above 31, one leaf, sibling and index tampered a warp);
   and the wide pow and dual pow (K12) in the
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
   fixed-window method needs for the run's exponents, each product's
   instructions split by pipe, ``mont_bound``; for the comb, the
   fewest a comb of any width 2..8 per base needs, ``least_comb``; for
   the GF codecs also the tensor-core bound, their bit products at the
   b1 yardstick against their bytes);
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
5. after the three paths, the DKG path (ops/dkg.py) and the share
   phase, each with the launch counts set to zero just before and read
   just after: ``run_dkg(n=32, threshold=11)`` on the card with all four
   fault knobs on distinct dealers and receivers, and
   ``run_dkg(n=16, threshold=6, group=GROUP384)``, each equal integer for
   integer to the same run on the 'cpu' backend, K7's generic pow (resp.
   K12's wide pow) launched; the N=128 roster's per-node steps at full
   size (t = 43): the roster-wide ``verify_pedersen_shares`` (737,280
   rows), ``verify_dealer_shares`` (720,896) and one node's ``finalize``
   (704,512), one K7 launch each, their verdicts (one tampered share a
   check) and key held to the host, each split into packing, device leg
   and host Python, K7 held to its plain version and to ``pow`` on a
   sample and timed on each call's inputs (entry by CUDA events, alone by
   a CUDA graph replay, its plain version, its bound, its plan and the
   products of its schedule) and printed as one ``dkg_roster`` JSON line;
   then ``share_phase``:
   f + 1 nodes' ``Tpke.dec_share_batch`` over 128 ciphertexts and f + 1
   issuers' ``CommonCoin.share_batch`` over 128 coins (K9), and
   ``verify_dec_shares`` / ``verify_shares_batch`` (K8) with one tampered
   share, against the 'cpu' arm's shares, verdicts, plaintext and coin
   bits;
6. the seconds the run took after the build, the ``{"kernels": [...]}``
   JSON line (K1-K12; ``OFF_PATH``'s kernels, mont_mul and sha256_rows,
   which no path launches, carry the paths' 0 with their kernel-phase
   launches and the reason beside it; K1's, K2's, K3's and K11's entries
   carry both their bounds, K5's and K6's their N=512 time and bound;
   K7's carries the finalize call's times, bound and plan, its launches
   on the decrypt-combine and DKG paths, and the 5,504-item record
   beside),
   the card line again, and last
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
# clock (half its 128 FP32 lanes), so 132 SMs x 64 x 1.98 GHz; its four
# sub-partitions issue one warp instruction a clock each, whatever the
# pipe (IMADs go to the FMA pipe), so 132 x 4 x 32 x 1.98 GHz in all.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_OPS_PER_S = 132 * 4 * 32 * 1.98e9
# the FMA pipe's integer multiplies (IMAD, IMAD.WIDE, IMAD.HI): 64 results
# a clock an SM for "32-bit integer multiply, multiply-add, extended-
# precision multiply-add" at compute capability 9.0 (the CUDA C++
# Programming Guide's arithmetic-instruction throughput table)
FMA_INT_OPS_PER_S = 132 * 64 * 1.98e9
# dense INT8 tensor-core peak of the same data sheet, 1,979 TOPS, at two
# operations a multiply-accumulate (K11's b1 yardstick scales by it)
S8_PUBLISHED_MACS_PER_S = 1979e12 / 2
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


def bound(nbytes: int, ops: int, issued: int = 0, fma: int = 0):
    """(bound_ms, bound_by) from bytes moved against int32 operations:
    ``ops`` on the INT32 lanes and, where their pipes are known,
    ``fma`` integer multiplies on the FMA pipe and ``issued`` (all of
    them) at the issue rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / INT32_OPS_PER_S, fma / FMA_INT_OPS_PER_S, issued / ISSUE_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def mont_bound(nbytes: int, products: int):
    """(bound_ms, bound_by) of ``products`` 256-bit Montgomery products on
    ``nbytes`` of I/O, each product's instructions split by pipe as
    ``sass_ops.MONT_PIPE_OPS`` counts them in the SASS (INT32 pipe, FMA
    pipe, issued)."""
    from cleisthenes_tpu_torch.csrc.sass_ops import MONT_PIPE_OPS

    i32, fma, issued = (products * c for c in MONT_PIPE_OPS)
    return bound(nbytes, i32, issued, fma)


def mont_bound_one_pipe(nbytes: int, products: int):
    """The same bound as the 256-bit kernels were held to before the split
    by pipe: every ALU instruction (``MONT_OPS``) at the INT32 rate."""
    from cleisthenes_tpu_torch.csrc.sass_ops import MONT_OPS

    return bound(nbytes, products * MONT_OPS)[0]


def sha_ops(n_blocks: int, n_nodes: int):
    """(INT32-pipe, issued) instructions of ``n_blocks`` SHA-256
    compressions and ``n_nodes`` Merkle node hashes, as sm_90a runs them:
    ``sass_ops``' ``SHA_BLOCK_OPS`` and ``SHA_NODE_OPS``, counted in the
    SASS (14 a round: 6 SHF, 4 LOP3 for the Sigmas, Ch and Maj, 4 adds;
    10 a schedule word; 8 final adds; part of the adds are IMADs on the
    FMA pipe)."""
    from cleisthenes_tpu_torch.csrc.sass_ops import SHA_BLOCK_OPS, SHA_NODE_OPS

    return tuple(n_blocks * b + n_nodes * nd for b, nd in zip(SHA_BLOCK_OPS, SHA_NODE_OPS))


def gf2_bit_products(m: int, k: int, cols: int, e: int = 16) -> int:
    """Bit products of a GF(2^e) matrix application as a lifted GF(2)
    product (K11: e = 16; K1/K2: e = 8): e m lifted rows x e k lifted
    columns x cols symbol columns (the zeros the kernels pad k with are
    not work the function needs)."""
    return e * m * e * k * cols


def b1_yardstick(b1_rate: float, s8_rate: float) -> float:
    """The binary tensor cores' peak, in bit products a second, from the
    ``mma.sync`` readings of ``mma_probe.mma_rates``: NVIDIA publishes no
    b1 rate, and the probe reads s8 below NVIDIA's published dense s8
    peak (``S8_PUBLISHED_MACS_PER_S``: on Hopper only wgmma reaches it),
    so the b1 reading scaled by that gap, or the reading itself if the
    gap ever closes."""
    return max(b1_rate, b1_rate * S8_PUBLISHED_MACS_PER_S / s8_rate)


def tc_bound(nbytes: int, bit_products: int, b1_rate: float, int_ops: int = 0,
             issued: int = 0):
    """(bound_ms, bound_by) of a GF codec kernel on the binary tensor
    cores: bytes at the HBM rate against bit products at ``b1_rate`` (bit
    products a second, ``b1_yardstick``) and, for K3's forest, int32
    operations beside them (``int_ops`` on the INT32 lanes, ``issued`` at
    the issue rate, as ``bound`` counts them)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(bit_products / b1_rate, int_ops / INT32_OPS_PER_S, issued / ISSUE_OPS_PER_S)
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


def graph_ms(torch, fn, reps: int, side=None) -> float:
    """ms a launch of ``fn`` without the host's launch cost: ``reps`` calls
    captured in a CUDA graph on the stream ``side`` (a new one by
    default), timed by CUDA events around a replay after a warm one."""
    if side is None:
        side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(side):
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / reps


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


def tree_branches(np, forest_np, n: int):
    """(branches (B n, D, 32), indices (B n,) int64) of every leaf of the
    B trees of n leaves in ``forest_np`` (B, 2p - 1, 32), as
    protocol/spmd.py assembles the N^2 ECHO branches."""
    b = forest_np.shape[0]
    p = (forest_np.shape[1] + 1) // 2
    depth = p.bit_length() - 1
    offs = [0]
    for lvl in range(depth):
        offs.append(offs[-1] + (p >> lvl))
    j = np.arange(n)
    br = np.zeros((b, n, depth, 32), np.uint8)
    for d in range(depth):
        br[:, :, d] = forest_np[:, offs[d] + ((j >> d) ^ 1)]
    return br.reshape(b * n, depth, 32), np.tile(j, b).astype(np.int64)


def tamper_per_warp(np, leaves, br, idx):
    """In every group of 32 branches (a warp's, in the kernel), flip a
    byte of one leaf, of one sibling and a low bit of one index, in
    place; returns the expected (B,) verdicts (an index flip changes
    nothing at depth 0)."""
    rows, depth = br.shape[0], br.shape[1]
    expect = np.ones(rows, dtype=bool)
    for w in range(0, rows, 32):
        leaf, sib, ix = w + 1, w + 7, w + 13
        if leaf < rows and leaves.shape[1]:
            leaves[leaf, (w // 32) % leaves.shape[1]] ^= 0x20
            expect[leaf] = False
        if sib < rows and depth:
            br[sib, (w // 32) % depth, 31 - (w // 32) % 32] ^= 0x04
            expect[sib] = False
        if ix < rows:
            idx[ix] ^= 1 << ((w // 32) % depth if depth else 5)
            expect[ix] &= depth == 0
    return expect


def payload_len(n: int, batch: int) -> int:
    """Bytes of one proposer's serialized TPKE ciphertext in the epoch:
    c1 (32) + length (4) + the serialized tx list + tag (32)."""
    from cleisthenes_tpu_torch.protocol.keys import serialize_txs

    per_node = max(batch, n) // n
    return 32 + 4 + len(serialize_txs([bytes(TX_BYTES)] * per_node)) + 32


def kernel_phase(torch, n: int, f: int, batch: int, dev, timed: bool, rng, b1_rate: float) -> dict:
    """Every entry point at one roster's epoch shapes, on ``dev``, held
    against its plain version; returns {entry point: record}.  Past 256
    validators the codec is GF(2^16) (K11 ``rs16_*`` on uint16 symbols,
    no fused decode-recheck); below, GF(2^8) (K1-K3).  Either codec first
    decodes by the identity (the bit order of its tensor-core fragments)
    and has a second bound on the binary tensor cores at ``b1_rate``
    (``tc_bound_ms``, printed with its bit products also when untimed).
    The codec's applies, the forest and the branch verify must make one
    launch a call, K3 three."""
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
    rs.mark_systematic(enc, a_np)
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
    # the N^2 ECHO branches
    br, idx_np = tree_branches(np, forest.cpu().numpy(), n)
    leaves_np = leaf_rows.cpu().numpy().copy()
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
    # the bit order of the codec's tensor-core fragments: a decode by the
    # identity
    before = sum(COUNTS.kernels.values())
    got = decode(put(np.eye(k, dtype=a_np.dtype)), data)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rec = {"equal": torch.equal(got.to(torch.int32), data.to(torch.int32)),
           "max_abs_err": 0.0, "launches_per_call": sum(COUNTS.kernels.values()) - before}
    print(f"kernel {prefix}identity n={n} f={f} B={b} k={k} L={L}: equal={rec['equal']} "
          f"launches_per_call={rec['launches_per_call']}", flush=True)
    out[prefix + "identity"] = rec
    # (INT32-pipe, issued) instructions of a forest of b trees
    forest_ops = sha_ops(b * n * blocks(L1), b * (p - 1))
    cases = {
        prefix + "encode": (
            lambda: encode(enc, data),
            lambda: apply_plain(enc, data),
            b * k * L + sym * n * k + b * n * L, (mac_ops * b * (n - k) * k * S, 0),
        ),
        prefix + "decode": (
            lambda: decode(dec, shards),
            lambda: apply_plain(dec, shards),
            2 * b * k * L + sym * k * k, (mac_ops * b * k * k * S, 0),
        ),
        prefix + "decode_per_instance": (
            lambda: decode(decs, shards_pi),
            lambda: apply_plain(decs, shards_pi),
            2 * b * k * L + sym * b * k * k, (mac_ops * b * k * k * S, 0),
        ),
        "sha256_rows": (
            lambda: sh.sha256_rows(leaf_rows, 0),
            lambda: sh.sha256_rows_plain(leaf_rows, 0),
            b * n * (L + 32), sha_ops(b * n * blocks(L1), 0),
        ),
        "merkle_forest": (
            lambda: sh.build_forest(full),
            lambda: sh.build_forest_plain(full),
            b * n * L + b * (2 * p - 1) * 32, forest_ops,
        ),
        "merkle_verify": (
            lambda: sh.verify_branches(roots_rep, leaves_v, br_v, idx_v),
            lambda: sh.verify_branches_plain(roots_rep, leaves_v, br_v, idx_v),
            b * n * (32 + L + depth * 32 + 8 + 1),
            sha_ops(b * n * blocks(L1), b * n * depth),
        ),
    }
    if not wide:
        table_ops = 2 * b * k * k * L + 2 * b * (n - k) * k * L
        cases["decode_recheck"] = (
            lambda: rs.decode_recheck(dec, enc, shards),
            lambda: rs.decode_recheck_plain(dec, enc, shards),
            b * k * L + k * k + n * k + b * k * L + b * 32,
            tuple(table_ops + o for o in forest_ops),
        )
    # bit products of the codec's lifted GF(2) products (K3: its decode and
    # parity re-encode, its forest as int32 operations beside them)
    e = 16 if wide else 8
    tc_bits = {
        prefix + "encode": (gf2_bit_products(n - k, k, b * S, e), (0, 0)),
        prefix + "decode": (gf2_bit_products(k, k, b * S, e), (0, 0)),
        prefix + "decode_per_instance": (gf2_bit_products(k, k, b * S, e), (0, 0)),
    }
    if not wide:
        tc_bits["decode_recheck"] = (
            gf2_bit_products(k, k, b * S, e) + gf2_bit_products(n - k, k, b * S, e), forest_ops)
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
        if dev.type == "cuda":  # one launch a call; K3: decode, re-encode, forest
            rec["equal"] &= per_call == (3 if name == "decode_recheck" else 1)
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
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, *ops)
        if name in tc_bits:
            bits, int_ops = tc_bits[name]
            rec["int_bound_ms"] = rec["bound_ms"]
            rec["tc_bound_ms"], rec["tc_bound_by"] = tc_bound(nbytes, bits, b1_rate, *int_ops)
            rec["bit_products"] = bits
        if timed:
            rec["kernel_ms"] = time_ms(torch, kern, 20)
            rec["plain_ms"] = time_ms(torch, plain, 3)
        line = (
            f"kernel {name} n={n} f={f} B={b} k={k} L={L}: "
            f"equal={rec['equal']} launches_per_call={per_call}"
        )
        if timed:
            line += f" kernel_ms={rec['kernel_ms']} plain_ms={rec['plain_ms']}"
        line += f" bound_ms={rec['bound_ms']} ({rec['bound_by']})"
        if name in tc_bits:
            line += (
                f" tc_bound_ms={rec['tc_bound_ms']} ({rec['tc_bound_by']}, "
                f"{rec['bit_products']} bit products at {b1_rate} a second)"
            )
        print(line, flush=True)
        out[name] = rec
    return out


def edge_phase(torch, dev, rng) -> dict:
    """Untimed parity on the paths of the codecs, the forest and the
    branch verify that no epoch's shapes take.

    - GF(2^8) (K1/K2, ``GF256_EDGES``): k on both sides of the 32-byte
      k256 step and far past it (1, 31, 32, 33, 44, 200), an odd parity
      row count, odd and tile-ragged L, x one byte off a 4-byte boundary;
    - K11: k past one lifted span of 176 symbols (N=640/f=213, k=214: two
      spans, lifted again for every tile), with an odd symbol count (no
      paired loads or stores) and with x one symbol off a 4-byte boundary
      (no paired loads at an even count);
    - the forest with rows staged by byte loads (a length, or a start, off
      16 bytes) and with rows past the 64 KB staging budget, hashed from
      global memory;
    - K6 (``VERIFY_EDGES``): one-leaf trees (D=0), 1,001-byte leaves one
      byte off (byte-load staging) with siblings and roots off 16 bytes,
      the >64 KB leaves of the forest case (the global path), a ragged B
      (N=100: 10,000 branches) and indices with bits above 31 set (the
      kernel reads their low 32 bits); every case with one tampered leaf,
      sibling and index in each warp's 32 branches.

    Encode, shared and per-instance decode (a distinct erasure pattern
    per instance) must equal their plain versions and give back the data;
    each forest its plain version and ``hashlib_root``; each verify its
    plain version and the tampering's verdicts; each call one launch.
    Returns {case: record}."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.ops import gf256, gf65536 as gf
    from cleisthenes_tpu_torch.ops import rs16_cuda as rs16
    from cleisthenes_tpu_torch.ops import rs_cuda as rs
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
        want = plain().to(got.device)
        equal = (torch.equal(got.to(torch.int32), want.to(torch.int32))
                 and (per_call == 1 or dev.type == "cpu") and check(got))
        out[name] = {"equal": equal, "launches_per_call": per_call}
        print(f"edge {name} {tuple(got.shape)}: equal={equal} launches_per_call={per_call}",
              flush=True)
        return got

    def codec(tag, field, enc_fn, dec_fn, plain_fn, x_np, n, k, off):
        a = field.systematic_rs_matrix(n, k)
        enc = put(a)
        rs.mark_systematic(enc, a)
        b = x_np.shape[0]
        x = put(x_np, off)
        x32 = torch.from_numpy(x_np.astype(np.int32)).to(dev)
        full = held(f"{enc_fn.__name__}@{tag}", lambda: enc_fn(enc, x),
                    lambda: plain_fn(enc, x),
                    lambda got: torch.equal(got.to(torch.int32)[:, :k], x32))
        full_np = full.cpu().numpy()
        idx = sorted(rng.choice(n, k, replace=False).tolist())
        dec, shards = put(field.gf_mat_inv(a[idx])), put(full_np[:, idx], off)
        held(f"{dec_fn.__name__}@{tag}", lambda: dec_fn(dec, shards),
             lambda: plain_fn(dec, shards),
             lambda got: torch.equal(got.to(torch.int32), x32))
        pats = [sorted(rng.choice(n, k, replace=False).tolist()) for _ in range(b)]
        decs = put(np.stack([field.gf_mat_inv(a[q]) for q in pats]))
        shards_pi = put(np.stack([full_np[i, q] for i, q in enumerate(pats)]), off)
        held(f"{dec_fn.__name__}_per_instance@{tag}", lambda: dec_fn(decs, shards_pi),
             lambda: plain_fn(decs, shards_pi),
             lambda got: torch.equal(got.to(torch.int32), x32))

    for tag, n, k, b, L, off in GF256_EDGES:
        codec(tag, gf256, rs.rs_encode, rs.rs_decode, rs.gf256_apply_plain,
              rng.integers(0, 256, (b, k, L), dtype=np.uint8), n, k, off)
    for tag, n, k, b, S, off in (("two_spans", 640, 214, 3, 40, False),
                                 ("two_spans_odd_S", 640, 214, 2, 37, False),
                                 ("odd_S", 300, 102, 3, 33, False),
                                 ("x_offset", 512, 172, 2, 64, True)):
        codec(tag, gf, rs16.rs16_encode, rs16.rs16_decode, rs16.gf65536_apply_plain,
              rng.integers(0, gf.ORDER, (b, k, S)).astype(np.uint16), n, k, off)
    trees = {}
    for tag, b, n, L, off in (("byte_loads", 3, 7, 1001, False),
                              ("start_offset", 2, 9, 1024, True),
                              ("global_rows", 2, 3, 65601, False)):
        shards_np = rng.integers(0, 256, (b, n, L), dtype=np.uint8)
        shards = put(shards_np, off)
        trees[tag] = shards_np, held(
            f"merkle_forest@{tag}", lambda: sh.build_forest(shards),
            lambda: sh.build_forest_plain(shards),
            lambda got: all(got[i, -1].cpu().numpy().tobytes() == hashlib_root(shards_np[i])
                            for i in range(b)))
    for tag, b, n, L, off, high in VERIFY_EDGES:
        if tag == "global_leaves":  # the forest case's trees of 65,601-byte rows
            shards_np, forest = trees["global_rows"]
        else:
            shards_np = rng.integers(0, 256, (b, n, L), dtype=np.uint8)
            forest = sh.build_forest(put(shards_np))
        forest_np = forest.cpu().numpy()
        br, idx = tree_branches(np, forest_np, n)
        leaves_np = shards_np.reshape(b * n, -1).copy()
        if high:
            idx |= (np.arange(b * n, dtype=np.int64) % 0x7FFFFFFF + 1) << 32
        expect = tamper_per_warp(np, leaves_np, br, idx)
        args = (put(np.repeat(forest_np[:, -1], n, 0), off), put(leaves_np, off),
                put(br, off), put(idx))
        # the plain version of the >64 KB leaves on the host: 1,026 blocks
        # of tiny tensor ops run faster there than as launches on the card
        plain_args = tuple(t.cpu() for t in args) if tag == "global_leaves" else args
        held(f"merkle_verify@{tag}", lambda: sh.verify_branches(*args),
             lambda: sh.verify_branches_plain(*plain_args),
             lambda got: bool(np.array_equal(got.cpu().numpy(), expect)))
    return out


# GF(2^8) edge cases (tag, n, k, instances, L, x off a 4-byte boundary)
GF256_EDGES = (
    ("k1", 3, 1, 4, 37, False),
    ("k31", 93, 31, 3, 300, False),
    ("k32_x_offset", 96, 32, 3, 128, True),
    ("k33_odd_parity", 100, 33, 3, 1001, False),
    ("k44_odd_L", 128, 44, 5, 127, True),
    ("k200", 256, 200, 2, 64, False),
)
# K6 edge cases (tag, trees, leaves a tree, L, inputs off alignment, index
# bits above 31)
VERIFY_EDGES = (
    ("depth0", 37, 1, 45, False, False),
    ("odd_L_offset", 9, 8, 1001, True, False),
    ("global_leaves", 2, 3, 65601, False, False),
    ("ragged_n100", 100, 100, 119, False, False),
    ("high_index_bits", 4, 64, 128, False, True),
)


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


def exp_bit_lengths(np, exps):
    """(B,) int64 bit lengths of (B, 32) big-endian exponent rows."""
    m = exps.shape[0]
    nz = exps != 0
    first = np.where(nz.any(1), nz.argmax(1), 32)
    top = exps[np.arange(m), np.minimum(first, 31)].astype(np.int64)
    return np.where(first < 32, 8 * (31 - first) + np.floor(np.log2(np.maximum(top, 1))).astype(np.int64) + 1, 0)


def pow_window(bits: int, wmax: int) -> int:
    """K7's window for a warp whose longest exponent has ``bits`` bits
    (csrc/modexp.cu ``pow_window``): the w in 1..wmax with the fewest of
    the table's 2^w - 2 products and, per digit after the top one, w
    squarings and a table product; the lesser w on a tie."""
    costs = [(2**w - 2 + (-(-bits // w) - 1) * (w + 1), w) for w in range(1, wmax + 1)]
    return min(costs)[1]


def pow_schedule(np, base, exp, wmax: int, rows_per_warp: int, order: bool = True):
    """Per row, the Montgomery products K7's schedule makes for it
    (csrc/modexp.cu ``pow_kernel``): the rows ordered by exponent bit
    length, longest first (stable; the kernel's order within a length is
    the scatter's, which moves only the zero-digit skips), ``rows_per_warp``
    a warp (32 / T), the last warp filled with the last row; per warp from
    its longest exponent's bits b: none for b = 0, else its window w
    (``pow_window``), into the domain (one more product where a row's 33rd
    byte folds), the table's 2^w - 2, w squarings for each digit after the
    top one and a table product where any of the warp's digits there is
    nonzero; and one out of the domain.  Returns (B,) int64 in the rows'
    own order."""
    n = exp.shape[0]
    bits = exp_bit_lengths(np, exp)
    window = [0] + [pow_window(b, wmax) for b in range(1, 257)]
    perm = np.argsort(-bits, kind="stable") if order else np.arange(n)
    pad = (-n) % rows_per_warp
    perm = np.concatenate([perm, np.full(pad, perm[-1])])
    warps = len(perm) // rows_per_warp
    out = np.zeros(len(perm), np.int64)
    step = 4096
    for lo in range(0, warps, step):
        idx = perm[lo * rows_per_warp : (lo + step) * rows_per_warp]
        m = len(idx) // rows_per_warp
        wb = bits[idx].reshape(m, rows_per_warp).max(1)
        fold = (base[idx, 32] != 0).reshape(m, rows_per_warp).any(1)
        wsel = np.array(window)[wb]
        nd = np.where(wb > 0, -(-wb // np.maximum(wsel, 1)), 0)
        mults = np.zeros(m, np.int64)
        ebits = np.unpackbits(exp[idx], axis=1)
        for w in range(1, wmax + 1):
            sel = wsel == w
            if not sel.any():
                continue
            b = np.pad(ebits, ((0, 0), ((-256) % w, 0)))
            dig = b.reshape(len(idx), -1, w).any(2)[:, ::-1]  # least significant first
            dig = dig.reshape(m, rows_per_warp, -1).any(1)
            below = np.arange(dig.shape[1])[None, :] < (nd - 1)[:, None]
            mults[sel] = (dig & below).sum(1)[sel]
        cnt = np.where(wb > 0, 1 + fold + 2**wsel - 2 + wsel * (nd - 1) + mults, 0) + 1
        out[lo * rows_per_warp : lo * rows_per_warp + len(idx)] = np.repeat(cnt, rows_per_warp)
    per_row = np.empty(n, np.int64)
    per_row[perm[:n]] = out[:n]
    return per_row


def schedule_products(np, base, exp, plan: str) -> int:
    """The products K7's schedule (``pow_schedule``) makes for these rows
    under csrc/modexp.cu's ``plan`` (ordered by length under ``PowPlan``),
    one count a row."""
    from cleisthenes_tpu_torch.csrc.sass_ops import modexp_plans
    from cleisthenes_tpu_torch.ops.modexp_cuda import POW_ORDERED

    pl = modexp_plans()[plan]
    return int(pow_schedule(np, base, exp, pl["window"], 32 // pl["team"],
                            POW_ORDERED[plan]).sum())


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
    ebits = exp_bit_lengths(np, exps)
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


# the K7 call of each of the N=128 roster's per-node DKG steps (ops/dkg.py):
# rows a (receiver, dealer) pair beyond the pair's t commitment terms
DKG_STEP_EXTRA = {"verify_pedersen_shares": 2, "verify_dealer_shares": 1, "finalize": 0}


def dkg_step_rows(np, rng, p: int, n: int, t: int, step: str):
    """(bases, exponents), (B, 33) and (B, 32) uint8 rows, of one DKG
    step's K7 call at roster (n, t) in the step's order (ops/dkg.py): for
    each evaluation point j (the receiver; ``finalize``'s m) and each of
    the n dealers, the t exponents j^k mod q (``_commit_eval_exps``) on the
    dealer's commitments, then the step's share exponents (two for
    ``verify_pedersen_shares``, one for ``verify_dealer_shares``, none for
    ``finalize``), random below 2^255; ``rng`` a numpy Generator.  Bases:
    random 256-bit stand-ins for the commitments (33rd byte zero)."""
    from cleisthenes_tpu_torch.ops.modmath import exps_to_bytes

    q = (p - 1) // 2
    extra = DKG_STEP_EXTRA[step]
    span = t + extra
    jk = []
    for j in range(1, n + 1):
        e = [1]
        for _ in range(t - 1):
            e.append(e[-1] * j % q)
        jk += e
    exps = np.empty((n, n, span, 32), np.uint8)
    exps[:, :, :t] = exps_to_bytes(jk).reshape(n, 1, t, 32)
    if extra:
        shares = rng.integers(0, 256, (n, n, extra, 32), dtype=np.uint8)
        shares[..., 0] &= 0x7F
        exps[:, :, t:] = shares
    bases = np.zeros((n * n * span, 33), np.uint8)
    bases[:, :32] = rng.integers(0, 256, (n * n * span, 32), dtype=np.uint8)
    return bases, exps.reshape(-1, 32)


def sms_of(torch, dev) -> int:
    """The SM count of ``dev`` (an H100's 132 for the CPU, whose runs
    only rehearse the card's plan boundary)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132


def pow_edge_rows(np, rnd, p: int, sms: int) -> dict:
    """K7's untimed batches, each {name: (bases, exponents)} as (B, 33) and
    (B, 32) uint8 rows that start with the edge rows (bases 0, 1, p - 1,
    p + 5, 2^264 - 1; exponents 0, 1, q, 2^256 - 1): both plans' boundary
    (the largest call ``PowSmallPlan`` takes on ``sms`` SMs, and one row
    more), every exponent zero, every exponent short (below 2^12), rows
    already in length order (``finalize``'s at n=48, t=16, longest first)
    and ragged counts (1, 31, 33, 4,099: no multiple of a warp, a block or
    a team)."""
    from cleisthenes_tpu_torch.ops import modexp_cuda as mx
    from cleisthenes_tpu_torch.ops.modmath import exps_to_bytes, ints_to_bytes33

    q = (p - 1) // 2
    edge_b, edge_e = [0, 1, p - 1, p + 5, 2**264 - 1], [0, 1, q, 2**256 - 1]

    def rows(n, exp_of, edge=True):
        bs = (edge_b + [rnd.randrange(p) for _ in range(n)])[:n]
        es = ((edge_e if edge else []) + [exp_of() for _ in range(n)])[:n]
        return ints_to_bytes33(bs), exps_to_bytes(es)

    small = sms * mx.POW_SMALL_ROWS_PER_SM
    out = {
        "small_plan_last": rows(small, lambda: rnd.randrange(q)),
        "many_plan_first": rows(small + 1, lambda: rnd.randrange(q)),
        "all_zero": rows(4099, lambda: 0, edge=False),
        "all_short": rows(20000, lambda: rnd.randrange(1, 1 << 12), edge=False),
    }
    b_np, e_np = dkg_step_rows(np, np.random.default_rng(rnd.randrange(2**32)), p, 48, 16,
                               "finalize")
    keep = np.argsort(-exp_bit_lengths(np, e_np), kind="stable")
    out["length_ordered"] = (b_np[keep], e_np[keep])
    for n in (1, 31, 33, 4099):
        out[f"B{n}"] = rows(n, lambda: rnd.randrange(q))
    return out


def modexp_phase(torch, p: int, dev, timed: bool, rnd) -> dict:
    """The modexp entry points on ``dev`` in the group mod ``p``, each held
    against its plain version and against Python's ``pow`` on a sample.
    When ``timed``: the comb (K9) and the dual pow (K8) at both epochs'
    shapes (``MODEXP_SHAPES``; keys ``pow_grouped``, ``dual_pow`` for
    N=128 and ``<entry>@n512``), the generic pow (K7, 5,504 items: the
    decrypt-combine shape) and the Montgomery product (16,384), then both
    K8 and K9 untimed on the ragged batches (``<entry>@B<n>``) and K7 on
    ``pow_edge_rows``' batches (``pow@<name>``); else small, parity only.
    Bounds split each product's instructions by pipe (``mont_bound``).
    Returns {entry point: record}."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc.build import COUNTS
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

    def pow_case(b_np, e_np):
        t = (put(b_np), put(e_np))
        return (
            lambda: mx.pow_fused(*t, spec),
            lambda: mx.pow_fused_plain(*t, spec),
            len(b_np) * (33 + 32 + 33), lambda: pow_products(np, b_np, e_np),
            lambda i: pow(int.from_bytes(b_np[i].tobytes(), "little"),
                          int.from_bytes(e_np[i].tobytes(), "big"), p),
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
        for name, rows in pow_edge_rows(np, rnd, p, sms_of(torch, dev)).items():
            cases[f"pow@{name}"] = pow_case(*rows) + (0,)

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
        if name == "pow" or name.startswith("pow@"):
            rec["plan"] = mx.pow_plan(n, sms_of(torch, dev))
        line = (
            f"kernel {name} p={hex(p)[:10]}.. shape={tuple(got.shape)}: "
            f"equal={rec['equal']} launches_per_call={per_call}"
            + (f" plan={rec['plan']}" if "plan" in rec else "")
        )
        if timed and reps:
            n_prod = products()
            if name == "pow":  # the decrypt-combine shape
                rec["schedule_products"] = schedule_products(np, *pow_np, rec["plan"])
            rec["kernel_ms"] = time_ms(torch, kern, 20)
            rec["plain_ms"] = time_ms(torch, plain, reps)
            rec["bound_ms"], rec["bound_by"] = mont_bound(nbytes, n_prod)
            rec["bound_one_pipe_ms"] = mont_bound_one_pipe(nbytes, n_prod)
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


def launch_counts() -> dict:
    """The launch counts since the last ``COUNTS.reset()``, by C entry
    point and by entry-point site."""
    from cleisthenes_tpu_torch.csrc.build import COUNTS

    return {"kernels": dict(COUNTS.kernels), "sites": dict(COUNTS.sites)}


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
    launches = launch_counts()
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
    launches = launch_counts()
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


# The DKG path (ops/dkg.py): the whole GJKR protocol, 256-bit and GROUP384,
# each run with all four fault knobs on distinct dealers or receivers;
# key: (n, threshold, group name, knobs, kernel that must launch)
DKG_SEED = 2026
DKG_RUNS = {
    "g256": (32, 11, "DEFAULT_GROUP", {"corrupt_dealers": [3], "false_accusers": [7],
                                       "phase2_cheaters": [11], "phase2_short_openers": [19]},
             "pow_fused"),
    "g384": (16, 6, "GROUP384", {"corrupt_dealers": [2], "false_accusers": [5],
                                 "phase2_cheaters": [9], "phase2_short_openers": [13]},
             "wide_pow_fused"),
}
# the BASELINE config-4 roster's per-node DKG steps: N=128, t = f + 1 = 43
DKG_ROSTER = (128, 43)
# the share phase's roster: the same, and the ciphertexts (and coins) of an epoch
SHARE_ROSTER = (128, 43, 128)


def dkg_ints(result):
    """(pub, shares, qualified) of a DKG as plain integers."""
    pub, shares, qualified = result
    return (
        (pub.n, pub.threshold, pub.master, tuple(pub.verification_keys), pub.group),
        [(s.index, s.value) for s in shares],
        list(qualified),
    )


def dkg_run_phase(torch, dev, runs=DKG_RUNS) -> dict:
    """The whole protocol (``run_dkg``) on ``dev``, then on the port's
    'cpu' backend (the native host modexp; Python's ``pow`` in GROUP384),
    at the same seed: (pub, shares, qualified) must be equal integer for
    integer, the corrupt dealer alone disqualified, the run's kernel
    (K7's generic pow, or K12's wide pow) launched and no ``OFF_PATH``
    entry point.  Returns {run: launch counts}."""
    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.ops import dkg, modmath

    out = {}
    for tag, (n, t, group_name, knobs, kernel) in runs.items():
        group = getattr(modmath, group_name)
        COUNTS.reset()
        t0 = time.perf_counter()
        card = dkg.run_dkg(n=n, threshold=t, group=group, seed=DKG_SEED,
                           backend="cuda", device=dev, **knobs)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = launch_counts()
        t0 = time.perf_counter()
        host = dkg.run_dkg(n=n, threshold=t, group=group, seed=DKG_SEED,
                           backend="cpu", **knobs)
        host_s = time.perf_counter() - t0
        equal = dkg_ints(card) == dkg_ints(host)
        qualified_ok = card[2] == [i for i in range(1, n + 1) if i not in knobs["corrupt_dealers"]]
        launched = launches["kernels"].get(kernel, 0)
        stray = [s for s in OFF_PATH if launches["sites"].get(s, 0)]
        print(
            f"dkg_run {tag}: run_dkg(n={n}, threshold={t}, group_bits={group.p.bit_length()}, "
            f"seed={DKG_SEED}, {', '.join(f'{k}={v}' for k, v in knobs.items())}) "
            f"qualified={len(card[2])} equal_to_cpu={equal} card_s={card_s} cpu_s={host_s} "
            f"{kernel}_launches={launched} launches={json.dumps(launches, sort_keys=True)}",
            flush=True,
        )
        if not (equal and qualified_ok and (dev.type == "cpu" or launched > 0) and not stray):
            raise AssertionError(f"dkg run {tag}: equal={equal} qualified_ok={qualified_ok} "
                                 f"{kernel}={launched} off-path launches {stray}")
        out[tag] = launches
    return out


def dkg_roster_phase(torch, dev, roster=DKG_ROSTER) -> dict:
    """The N=128 roster's per-node DKG steps at full size, on ``dev``: the
    roster-wide phase-one check ``verify_pedersen_shares`` (N^2 share
    pairs, t + 2 rows each), the phase-two ``verify_dealer_shares`` (t + 1
    rows each) and one node's ``finalize`` (N x N x t rows), each one
    ``pow_batch``, one K7 launch.  Each step is timed by the host clock
    and split by the engine's ``stats`` into packing, the device leg
    (upload, kernel, download) and the host's Python around the call
    (items and products).  On the card K7's inputs are kept from each
    call by a hook on the engine's ``_dispatch``, and its entry (CUDA events), kernel alone (a CUDA graph replay) and
    plain version timed on them and held equal.  Every honest verdict
    must be True and the one tampered share of each check False, the
    node's share must match its verification key, and ``finalize``'s key
    must equal the same call on the 'cpu' engine.  Returns the steps'
    records."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.ops import dkg
    from cleisthenes_tpu_torch.ops import modexp_cuda as mx
    from cleisthenes_tpu_torch.ops.modmath import DEFAULT_GROUP, get_engine

    n, t = roster
    gp = DEFAULT_GROUP
    eng = get_engine("cuda", gp, dev)
    t0 = time.perf_counter()
    dealers = [dkg.PedersenDealing(i, n, t, gp, seed=DKG_SEED) for i in range(1, n + 1)]
    ped = {d.dealer_index: d.pedersen_commitments("cuda", dev) for d in dealers}
    feld = {d.dealer_index: d.commitments("cuda", dev) for d in dealers}
    pairs = {(j, d.dealer_index): d.share_pair_for(j) for j in range(1, n + 1) for d in dealers}
    print(f"dkg_roster: n={n} threshold={t}: dealings, commitments and {len(pairs)} share "
          f"pairs set up in {time.perf_counter() - t0} s", flush=True)
    me = 1
    ped_items = [(ped[i], j, *pairs[j, i]) for j in range(1, n + 1) for i in range(1, n + 1)]
    feld_items = [(feld[i], j, pairs[j, i][0]) for j in range(1, n + 1) for i in range(1, n + 1)]
    # one tampered share a check, away from the batch's ends
    bad_ped, bad_feld = len(ped_items) // 3, 2 * len(feld_items) // 3
    c, j, s, s2 = ped_items[bad_ped]
    ped_items[bad_ped] = (c, j, (s + 1) % gp.q, s2)
    c, j, s = feld_items[bad_feld]
    feld_items[bad_feld] = (c, j, (s + 1) % gp.q)
    my_shares = {i: pairs[me, i][0] for i in range(1, n + 1)}
    steps = {
        "verify_pedersen_shares": lambda: dkg.verify_pedersen_shares(ped_items, gp, "cuda", dev),
        "verify_dealer_shares": lambda: dkg.verify_dealer_shares(feld_items, gp, "cuda", dev),
        "finalize": lambda: dkg.finalize(feld, me, my_shares, n, t, gp, "cuda", dev),
    }
    dispatch = eng._dispatch
    out = {}
    for name, fn in steps.items():
        kept = []

        def keep(kernel, *arrays, kept=kept):
            kept.append((kernel, arrays))
            return dispatch(kernel, *arrays)

        before = dict(eng.stats)
        COUNTS.reset()
        eng._dispatch = keep  # this engine's calls only: its arrays, kept
        try:
            t0 = time.perf_counter()
            res = fn()
            step_s = time.perf_counter() - t0
        finally:
            del eng._dispatch
        launches = launch_counts()
        engine_s = eng.stats["engine_s"] - before["engine_s"]
        device_s = eng.stats["device_s"] - before["device_s"]
        rec = {
            "step_s": step_s, "packing_s": engine_s - device_s, "device_s": device_s,
            "host_python_s": step_s - engine_s, "rows": sum(a[0].shape[0] for _, a in kept),
            "pow_launches": launches["sites"].get("pow", 0), "launches": launches,
        }
        if name == "finalize":
            pub, share = res
            t0 = time.perf_counter()
            host_pub, _ = dkg.finalize(feld, me, my_shares, n, t, gp, "cpu")
            rec["cpu_s"] = time.perf_counter() - t0
            ok = pub == host_pub and pow(gp.g, share.value, gp.p) == pub.verification_keys[me - 1]
        else:
            bad = bad_ped if name == "verify_pedersen_shares" else bad_feld
            ok = res == [i != bad for i in range(len(res))]
        stray = [s_ for s_ in OFF_PATH if launches["sites"].get(s_, 0)]
        ok = (ok and len(kept) == 1 and kept[0][0] is mx.pow_fused and not stray
              and (dev.type == "cpu" or rec["pow_launches"] == 1))
        if ok and dev.type == "cuda":
            b_np, e_np = (np.array(a) for a in kept[0][1])
            base, exp = torch.from_numpy(b_np).to(dev), torch.from_numpy(e_np).to(dev)
            spec = eng._spec
            got = mx.pow_fused(base, exp, spec)
            plain = mx.pow_fused_plain(base, exp, spec)
            got_np = got.cpu().numpy()
            rows = b_np.shape[0]
            sample = sorted({0, rows - 1} | set(random.Random(rows).sample(range(rows), 40)))
            rec["equal"] = bool(torch.equal(got, plain)) and all(
                int.from_bytes(got_np[i].tobytes(), "little")
                == pow(int.from_bytes(b_np[i].tobytes(), "little"),
                       int.from_bytes(e_np[i].tobytes(), "big"), gp.p)
                for i in sample)
            rec["max_abs_err"] = float((got.to(torch.int64) - plain.to(torch.int64)).abs().max())
            rec["plan"] = mx.pow_plan(rows, sms_of(torch, dev))
            rec["kernel_ms"] = time_ms(torch, lambda: mx.pow_fused(base, exp, spec), 5)
            rec["alone_ms"] = graph_ms(torch, lambda: mx.pow_fused(base, exp, spec), 5)
            rec["plain_ms"] = time_ms(torch, lambda: mx.pow_fused_plain(base, exp, spec), 1)
            rec["products"] = pow_products(np, b_np, e_np)
            rec["schedule_products"] = schedule_products(np, b_np, e_np, rec["plan"])
            nbytes = rows * (33 + 32 + 33)
            rec["bound_ms"], rec["bound_by"] = mont_bound(nbytes, rec["products"])
            rec["bound_one_pipe_ms"] = mont_bound_one_pipe(nbytes, rec["products"])
            rec["x_bound"] = rec["kernel_ms"] / rec["bound_ms"]
            ok = ok and rec["equal"]
        print(f"dkg_roster {name}: ok={ok} " + " ".join(
            f"{k}={json.dumps(v, sort_keys=True) if isinstance(v, dict) else v}"
            for k, v in rec.items()), flush=True)
        if not ok:
            raise AssertionError(f"dkg roster step {name} failed: {rec}")
        out[name] = rec
    print("dkg_roster " + json.dumps({
        "n": n, "threshold": t,
        "steps": {k: {f: v for f, v in r.items() if f != "launches"} for k, r in out.items()},
        "pow_launches": sum(r["pow_launches"] for r in out.values()),
    }, sort_keys=True), flush=True)
    return out


def share_phase(torch, dev, roster=SHARE_ROSTER) -> dict:
    """The scalar and pooled share ops' batched forms on ``dev``, held to
    the 'cpu' arm on the same dealt keys: f + 1 nodes'
    ``Tpke.dec_share_batch`` over an epoch's ciphertexts (K9),
    ``verify_dec_shares`` over their shares of one ciphertext, one
    tampered (K8), and the combined plaintext; f + 1 issuers'
    ``CommonCoin.share_batch`` over an epoch's coins (K9) and
    ``verify_shares_batch`` over every coin's f + 1 shares, one tampered
    (K8), and the coin bits.  Each share's d must equal the host arm's,
    the verdicts must be the host arm's and flag the tampered share, the
    plaintext and coin bits must agree.  Returns the launch counts."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.ops import coin as coin_mod
    from cleisthenes_tpu_torch.ops import tpke

    n, t, n_ct = roster
    rng = np.random.default_rng(16)
    pub, keys = tpke.deal(n, t, seed=DKG_SEED)
    card, host = tpke.Tpke(pub, "cuda", dev), tpke.Tpke(pub, "cpu")
    msgs = [rng.integers(0, 256, 256, dtype=np.uint8).tobytes() for _ in range(n_ct)]
    cts = [card.encrypt(m) for m in msgs]
    coin_pub, coin_keys = tpke.deal(n, t, seed=DKG_SEED + 1)
    ccard = coin_mod.CommonCoin(coin_pub, "cuda", dev)
    chost = coin_mod.CommonCoin(coin_pub, "cpu")
    cids = [b"epoch0|inst%03d|round0" % i for i in range(n_ct)]
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return res

    bad = t // 2
    COUNTS.reset()
    dec = timed("dec_share_batch", lambda: [card.dec_share_batch(k, cts) for k in keys[:t]])
    shown = [row[0] for row in dec]  # f + 1 nodes' shares of the first ciphertext
    col = list(shown)
    col[bad] = col[bad]._replace(z=(col[bad].z + 1) % pub.group.q)
    verdicts = timed("verify_dec_shares", lambda: card.verify_dec_shares(cts[0], col))
    cshares = timed("coin_share_batch", lambda: [ccard.share_batch(k, cids) for k in coin_keys[:t]])
    entries = [(cid, [row[i] for row in cshares]) for i, cid in enumerate(cids)]
    first = list(entries[0][1])
    first[bad] = first[bad]._replace(z=(first[bad].z + 1) % coin_pub.group.q)
    tampered = [(cids[0], first)] + entries[1:]
    cverdicts = timed("coin_verify_shares_batch", lambda: ccard.verify_shares_batch(tampered))
    launches = launch_counts()
    plain = card.combine(cts[0], shown)
    bits = [ccard.toss(cid, shs) for cid, shs in entries[:8]]
    # the host arm: its own issue and combines (the memo cleared), its
    # verdicts on the card's shares
    tpke._COMBINE_MEMO.clear()
    host_dec = host.dec_share_batch(keys[0], cts)
    host_col = [host.dec_share(k, cts[0]) for k in keys[: t + 1]]
    host_verdicts = host.verify_dec_shares(cts[0], col)
    host_plain = host.combine(cts[0], host_col[1:])
    host_cshares = chost.share_batch(coin_keys[1], cids)
    host_cverdicts = chost.verify_shares_batch(tampered)
    host_bits = [chost.toss(cid, [chost.share(k, cid) for k in coin_keys[t - 1 : 2 * t - 1]])
                 for cid in cids[:8]]
    want = [i != bad for i in range(t)]
    checks = {
        "dec_d_equal": [s.d for s in dec[0]] == [s.d for s in host_dec]
        and [s.d for s in shown] == [s.d for s in host_col[:t]],
        "dec_verdicts": verdicts == host_verdicts == want,
        "plaintext": plain == host_plain == msgs[0],
        "coin_d_equal": [s.d for s in cshares[1]] == [s.d for s in host_cshares],
        "coin_verdicts": cverdicts == host_cverdicts and cverdicts[0] == want
        and all(all(v) for v in cverdicts[1:]),
        "coin_bits": bits == host_bits,
        "launched": dev.type == "cpu" or (launches["sites"].get("pow_grouped", 0) > 0
                                          and launches["sites"].get("dual_pow", 0) > 0),
        "off_path": not any(launches["sites"].get(s, 0) for s in OFF_PATH),
    }
    tpke._COMBINE_MEMO.clear()
    print(
        f"share_phase: n={n} threshold={t} ciphertexts={n_ct} coins={len(cids)} "
        f"seconds={json.dumps(secs)} checks={json.dumps(checks)} "
        f"launches={json.dumps(launches, sort_keys=True)}",
        flush=True,
    )
    if not all(checks.values()):
        raise AssertionError(f"share phase disagrees with the cpu arm: {checks}")
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
        "n128": kernel_phase(torch, N, F, BATCH, dev, True, rng, b1_rate),
        "n100": kernel_phase(torch, 100, 33, BATCH, dev, False, rng, b1_rate),
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
    dkg_launches = dkg_run_phase(torch, dev)
    dkg_steps = dkg_roster_phase(torch, dev)
    share_launches = share_phase(torch, dev)
    # last, so that its epoch shifts nothing the timed paths share (the
    # combine memo's fill, the profiler's host objects)
    profile_phase(torch, 512, 4096)
    counts = dict(launches["sites"])
    pow_by_path = {
        "decrypt_combine": dec_launches["sites"].get("pow", 0),
        "dkg_run_n32": dkg_launches["g256"]["sites"].get("pow", 0),
        "dkg_n128_steps": sum(r["pow_launches"] for r in dkg_steps.values()),
    }
    counts["pow"] = sum(pow_by_path.values())
    counts["gf65536_apply"] = launches_512["kernels"].get("gf65536_apply", 0)
    for name in ("wide_pow_fused", "wide_dual_pow_fused"):
        counts[name] = launches_384["kernels"].get(name, 0)
    records = {name: dict(rec) for name, rec in phases["n128"].items()}
    records.update(phases["modexp"])
    # K7 at the largest shape of its path: one node's N=128 finalize
    records["pow"] = dict(dkg_steps["finalize"], decrypt_combine_shape={
        k_: phases["modexp"]["pow"][k_]
        for k_ in ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                   "bound_one_pipe_ms", "plan")})
    records["gf65536_apply"] = dict(phases["n512"]["rs16_encode"])
    for rec in records.values():  # the codecs' bound: the lesser of their two
        if "tc_bound_ms" in rec and rec["tc_bound_ms"] < rec["int_bound_ms"]:
            rec["bound_ms"], rec["bound_by"] = rec["tc_bound_ms"], rec["tc_bound_by"]
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
        if name == "pow":
            kernels[-1].update(launches_by_path=pow_by_path, rows=rec["rows"],
                               alone_ms=rec["alone_ms"], plan=rec["plan"],
                               decrypt_combine_shape=rec["decrypt_combine_shape"])
        elif name == "wide_pow_fused":
            kernels[-1]["launches_dkg_g384"] = dkg_launches["g384"]["kernels"].get(name, 0)
        elif name in ("pow_grouped", "dual_pow"):
            kernels[-1]["launches_share_phase"] = share_launches["sites"].get(name, 0)
        if name in OFF_PATH:
            kernels[-1]["kernel_phase_launches"] = rec["launches_per_call"]
            kernels[-1]["off_path"] = OFF_PATH[name]
        if "tc_bound_ms" in rec:
            kernels[-1]["bounds"] = {"int_ops_ms": rec["int_bound_ms"],
                                     "tensor_core_ms": rec["tc_bound_ms"]}
        elif name in ("merkle_forest", "merkle_verify"):
            n512 = phases["n512"][name]
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
