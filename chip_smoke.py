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
   against their plain versions (timed once after a warm-up)
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
   group), the plain version's (once), launches per call and the
   bound (for a pow or dual pow, from the fewest Montgomery products a
   fixed-window method needs for the run's exponents, each product's
   instructions split by pipe, ``mont_bound``; for the comb, the
   fewest a comb of any width 2..8 per base needs, ``least_comb``; for
   the GF codecs also the tensor-core bound, their bit products at the
   b1 yardstick against their bytes); last the rows phase
   (``rows_phase``): ``sha256_rows`` (K4) at 16,384 rows of 128 bytes with
   the prefix 0x00, 8,192 of 64 with 0x01 and 4,096 of 1,001 with none,
   and ``mont_mul_batch`` (K10) at 16,384 and 1,048,576 products, each
   byte-equal to its plain version and to ``hashlib`` or Python's integers,
   one launch a call, with its entry time, its time alone from a replayed
   CUDA graph, its plain version's and its bound; K10 also on values in
   [p, 2^264);
3. three paths through ``LockstepCluster`` with its defaults (the
   'cuda' backend), each committing 3 epochs (the N=512 path 2) of
   random 64-byte transactions, every one exactly once, with the launch counts set to
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
5. after the three lockstep paths, the device mesh (``mesh_phase``,
   parallel/mesh.py): at the ops level, on ``CryptoMesh((2, 4))`` of
   eight handles of the card and on the default ``CryptoMesh((1, 1))``,
   RS encode, shared and mixed-pattern decode, the forest, the N^2
   branch verify (a leaf, a sibling and an index tampered a warp), the
   pow (5,504 rows), the dual pow (22,016) and the grouped pow (98,304
   exponents over 257 bases, flattened under a mesh) at the N=128
   epoch's shapes, each byte-equal to the unsharded call and one launch
   a tile; a (3, 2) mesh on six handles with a ragged batch of 5; then
   mesh-n128: the N=128 path with ``Config(mesh_shape=...)`` on each of
   both meshes, a warm-up and one measured epoch of the same
   transactions, whose committed batches must equal the N=128 path's own
   first two epochs byte for byte, launching K1, K2, K5-K8 (a whole
   number of launches a tile) and neither K3, nor K9, nor ``OFF_PATH``;
   then ``flagship.dryrun_multichip`` on eight handles and on one device
   (its tile shapes, its roots and shards equal to the unsharded
   flagship step, its N=64 epoch on the sharded plane); then the fuzz
   driver (``fuzz_phase``, tools/fuzz.py) on the card's defaults over the
   seeds from 0 of the 0:20 smoke band that fit in 60 s, each schedule
   holding every invariant and committing the ledgers of the same
   schedule on 'cpu', the planted tx injector caught as
   ``no_foreign_tx``, and ``tools/loadgen.py`` at its smoke size with
   its own audits (zero lost acks, frontiers met, agreement, equal
   settled content at depths 1 and 4);
6. then the asynchronous plane's path
   (``async_phase``): ``SimulatedCluster(config=Config(n=64,
   batch_size=10000, seed=99), key_seed=77)`` with its defaults (the
   'cuda' backend), N HoneyBadger state machines over the in-process
   channel transport with one shared ``CryptoHub`` (BASELINE.json
   configs[2], in ``bench.py``'s ``measure_protocol`` arrangement): one
   warm-up and 1 measured epoch, each 10,000 random 64-byte
   transactions kicked by ``start_epoch`` on every node (a kick settles
   two consensus epochs: 156 transactions a node, then the remainder),
   which must commit on every node alike, each exactly once, on the
   card's modexp engines, launching K1 and K5 (each node's propose), K6
   and K3 (the hub's waves), K8 and K9 and nothing of ``OFF_PATH``; a
   twin on the 'cpu' backend commits byte-identical batches for the
   warm-up and the measured epoch.  It prints each epoch's wall
   seconds, node 0's two frontiers, tx/s, the hub's stats and wave
   widths by kind, launches by kernel per epoch, and the hub's flush
   seconds split into the modexp engines' device leg, their packing and
   host Python; then holds the six kernels to their plain versions and
   times them at the path's shapes (K1 and K5 at the B=1 propose call,
   the others at their median wave) with their bounds;
7. then the same deployment at its full fault budget
   (``byzantine_phase``): the first f=21 nodes lie (``BYZ_KINDS`` in
   turn: four each of ShareForger, BadDealer and Equivocator, three each
   of SplitVoter, SelectiveMute and EpochSprayer) under a wire adversary
   of the same nodes (drop 10 %, tamper 5 %, reorder 20 %), and 10,000
   random transactions go round-robin to the 43 honest nodes, ordered
   by one ``run_until_drained`` with the launch counts set to 0 just
   before.  The honest nodes must agree to depth 2 and commit every
   transaction exactly once, every behaviour must have lied, the six
   entry points must launch and nothing of ``OFF_PATH``; the branch
   wave's K6 verdicts and the pooled CP checks on K8 must include false
   ones, every K6 call, the median K8 call and every K8 call inside a
   check with a false verdict must give on their plain versions what
   they gave in the run, and a 'cpu' twin built from the same seeds must
   commit byte-identical honest ledgers with equal rewrites, hub stats
   and reject counts.  It prints the run's wall seconds, epochs, tx/s,
   the lowest honest node's frontiers, the flush split, rewrites by
   kind, rejects and launches, and K6 and K8 timed at their median call;
8. then the system as it is deployed (``grpc_phase``): BASELINE.json
   configs[1] (N=16, f=5, 4,096-transaction batches) as 16
   ``ValidatorHost``s, ``node00``-``node15``, each with its own
   ``CryptoHub``, dispatcher thread, gRPC server and 15 dialed streams,
   on 127.0.0.1 ephemeral ports, with batch logs and telemetry
   (``obs_port=0``) on and the port's defaults: a warm-up of 4,096 random
   64-byte transactions, then, with the launch counts set to 0, 8,192
   (``default_rng(19)``) submitted round-robin and proposed on every host
   until every host has committed every one.  Every host must commit the
   same batch bytes at every epoch and every transaction once, on the
   card's modexp engines, every dispatcher thread on the card's default
   stream, launching the async path's entry points with K7 in K9's place
   (``GRPC_SITES``: a host's share waves stay under the comb's 64
   exponents) and nothing of ``OFF_PATH``; node 0's /metrics must parse, its transport and hub
   counters equal ``node.metrics.snapshot()``, and /healthz and every
   peer be UP; no host thread may outlive ``stop``; and a 'cpu' twin of
   the same roster, seeds and transactions must commit the same set of
   transactions, byte-equal over the epochs whose included proposers
   agree (each epoch's proposers printed for both runs).  It prints the
   run's seconds and tx/s, node 0's ordered and settled p50, the hubs'
   flushes and dispatches (summed and the median host), the transport
   counters, launches, and the run split into the hubs' flush time
   (host Python, packing, device leg) and the rest; then its kernels at
   their median call.  After it, the runnable entry point,
   ``cleisthenes_tpu_torch.demo.main(["--n", "4", "--txs", "64",
   "--batch-size", "16", "--dkg"])`` on its defaults (``demo_phase``),
   must return 0 with K7 launched by its DKG;
9. after that, the DKG path (ops/dkg.py) and the share
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
10. the seconds the run took after the build, the ``{"kernels": [...]}``
   JSON line (K1-K12, each with its launches per epoch on the async
   path and on the gRPC path (``launches_grpc_n16``), in mesh-n128's
   measured epoch on each mesh (``launches_mesh_n128``) and in the fuzz
   phase (``launches_fuzz``) and, for those six,
   its ``async_n64`` record and, for the gRPC path's, its ``grpc_n16``
   record, its launches and
   rejects on the Byzantine path (``launches_async_n64_byz``,
   ``rejects_async_n64_byz``: false verdicts for K6 and K8, null for a
   kernel that gives none) and, for K6 and K8, its ``async_n64_byz``
   record; ``OFF_PATH``'s
   kernels, mont_mul and sha256_rows,
   which no path launches, carry the paths' 0 with their kernel-phase
   launches and the reason beside it; K1's, K2's, K3's and K11's entries
   carry both their bounds, K5's and K6's their N=512 time and bound;
   K7's carries the finalize call's times, bound and plan, its launches
   on the decrypt-combine, DKG and demo paths, and the 5,504-item record
   beside),
   the card line again, and last
   ``{"ok": true, "device": {...}}``.

Tolerance everywhere is zero: all of this is exact integer math.  Any
failure exits non-zero before the last line.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import queue
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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
# the N=512 path's depth: 1 epoch since the gRPC path joined the script
# and waits for its roster to go idle (its epochs take ~15 s each; the
# script must end well inside 1,200 s)
N512_EPOCHS = 1


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


def time_ms(torch, fn, reps: int, warm: bool = True) -> float:
    """Median ms per call: CUDA events around each call after a warm-up
    (``warm=False``: the caller has just called ``fn``)."""
    if warm:
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
            rec["plain_ms"] = time_ms(torch, plain, 1, warm=False)
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
        # the plain forest of >64 KB rows on the host, as the verify's below
        plain_shards = shards.cpu() if tag == "global_rows" else shards
        trees[tag] = shards_np, held(
            f"merkle_forest@{tag}", lambda: sh.build_forest(shards),
            lambda: sh.build_forest_plain(plain_shards),
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


def _nonzero_digits(np, exps, w: int, bits=None):
    """(B, nb) big-endian exponent bytes (or their ``bits``, unpacked) ->
    (B, ceil(8 nb / w)) bool: each base-2^w digit, most significant first,
    is nonzero (an OR of the digit's bit columns)."""
    if bits is None:
        bits = np.unpackbits(exps, axis=1)
    bits = np.pad(bits, ((0, 0), ((-bits.shape[1]) % w, 0)))
    d = bits.reshape(bits.shape[0], -1, w)
    nz = d[:, :, 0] != 0
    for j in range(1, w):
        nz |= d[:, :, j] != 0
    return nz


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
        nz = _nonzero_digits(np, exps, w)
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
        n1, n2 = _nonzero_digits(np, e1, w), _nonzero_digits(np, e2, w)
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
    widths = range(2, 9)
    per_exp = {w: np.zeros(m, np.int64) for w in widths}
    for lo in range(0, m, 1 << 17):  # bounded memory at the N=512 shapes
        bits = np.unpackbits(exps[lo : lo + (1 << 17)], axis=1)
        for w in widths:
            nz = _nonzero_digits(np, None, w, bits).sum(1)
            per_exp[w][lo : lo + len(nz)] = np.maximum(nz - 1, 0) + 1
    best = None
    for w in widths:
        r = np.maximum(-(-bbits // w), 1)
        cost = into + w * (r - 1) + r * (2**w - 2) + np.bincount(rows, per_exp[w], n_b)
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
        reps = 1
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
            lambda i: pow(pb[i], pe[i], p), 1,
        )
        xs = [rnd.randrange(p) for _ in range(n_mont)]
        ys = [rnd.randrange(p) for _ in range(n_mont)]
        mm_ = (put(ints_to_bytes33(xs)), put(ints_to_bytes33(ys)))
        cases["mont_mul"] = (
            lambda: mx.mont_mul_batch(*mm_, spec),
            lambda: mx.mont_mul_batch_plain(*mm_, spec),
            n_mont * 3 * 33, lambda: n_mont,
            lambda i: xs[i] * ys[i] * r_inv % p, 1,
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
            rec["plain_ms"] = time_ms(torch, plain, reps, warm=False)
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
                rec["plain_ms"] = time_ms(torch, plain, 1, warm=False)
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


# K4 and K10 at the shapes their redesign is judged by: the table's N=128
# leaves (16,384 rows of 128 bytes after the prefix 0x00), the reference's
# device floor for node rows (XlaMerkle._hash_batch: 8,192 rows of 64 bytes
# after 0x01), and a ragged length with no prefix (1,001 bytes: across
# 16-byte granules, 64-byte blocks and K4's 256-byte staging chunk); K10 at
# the table's 16,384 products and at 1,048,576, where the bytes bind
ROWS_SHAPES = (("leaves", 16384, 128, 0), ("nodes", 8192, 64, 1), ("ragged", 4096, 1001, None))
MUL_SHAPES = (16384, 1 << 20)


def mul_rows(np, rng, p: int, n: int, unreduced: bool = False):
    """(x, y) as (n, 33) little-endian rows below p (p's top byte 0xFF:
    a top byte below it keeps a value below p); with ``unreduced`` every
    third row of every other warp holds values in [p, 2^264)."""
    assert p >> 248 == 0xFF
    xy = rng.integers(0, 256, (2, n, 33), dtype=np.uint8)
    xy[:, :, 32] = 0
    xy[:, :, 31] = np.minimum(xy[:, :, 31], 0xFE)
    if unreduced:
        rows = np.arange(n)
        big = (rows % 3 == 0) & ((rows // 32) % 2 == 1)
        xy[:, big, 31] = 0xFF
        xy[0, big, 32] = rng.integers(1, 256, int(big.sum()), dtype=np.uint8)
    return xy[0], xy[1]


def rows_phase(torch, dev, rng, p: int, rows_shapes=ROWS_SHAPES, mul_shapes=MUL_SHAPES,
               timed: bool = True) -> dict:
    """K4 (``sha256_rows``) at ``ROWS_SHAPES`` and K10 (``mont_mul_batch``)
    at ``MUL_SHAPES``, each held byte for byte to its plain version and
    to ``hashlib`` (a sample) or Python's integers (every row), one launch
    a call, and timed: the entry point by CUDA events (median of 20), the
    kernel alone from a replayed CUDA graph, the plain version once, the
    bound from the bytes and the SASS's ops; K10 once more, untimed, on
    16,384 rows with values in [p, 2^264) in every other warp.  On the CPU
    (a rehearsal at small shapes, untimed) the plain versions run.
    Returns {"sha256_rows@<tag>" or "mont_mul@<n>": record}."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.ops import modexp_cuda as mx
    from cleisthenes_tpu_torch.ops import sha256_cuda as sh
    from cleisthenes_tpu_torch.ops.modmath import bytes33_to_ints

    def held(kern, plain):
        before = sum(COUNTS.kernels.values())
        got = kern()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        per_call = sum(COUNTS.kernels.values()) - before
        want = plain()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        return got, {"equal": torch.equal(got, want) and per_call == (dev.type == "cuda"),
                     "max_abs_err": float(err), "launches_per_call": per_call}

    def time_it(rec, kern, plain, nbytes, ops):
        if not timed:
            return ""
        rec["kernel_ms"] = time_ms(torch, kern, 20)
        rec["alone_ms"] = graph_ms(torch, kern, 20)
        rec["plain_ms"] = time_ms(torch, plain, 1, warm=False)
        rec["bound_ms"], rec["bound_by"] = ops(nbytes)
        return (f"kernel_ms={rec['kernel_ms']} alone_ms={rec['alone_ms']} "
                f"plain_ms={rec['plain_ms']} bound_ms={rec['bound_ms']} ({rec['bound_by']}) "
                f"x_bound_alone={rec['alone_ms'] / rec['bound_ms']}")

    out = {}
    for tag, b, L, prefix in rows_shapes:
        msgs_np = rng.integers(0, 256, (b, L), dtype=np.uint8)
        msgs = torch.from_numpy(msgs_np).to(dev)
        kern = (lambda m=msgs, pre=prefix: sh.sha256_rows(m, pre))
        plain = (lambda m=msgs, pre=prefix: sh.sha256_rows_plain(m, pre))
        got, rec = held(kern, plain)
        head = b"" if prefix is None else bytes([prefix])
        dig = got.cpu().numpy()
        for i in sorted({0, b - 1} | set(rng.choice(b, min(b, 64), replace=False).tolist())):
            rec["equal"] &= dig[i].tobytes() == hashlib.sha256(head + msgs_np[i].tobytes()).digest()
        n_blocks = b * blocks(L + len(head))
        rec.update(rows=b, msg_len=L, prefix=prefix, compressions=n_blocks)
        line = time_it(rec, kern, plain, b * (L + 32), lambda nb, k=n_blocks: bound(nb, *sha_ops(k, 0)))
        print(f"rows sha256_rows@{tag} B={b} L={L} prefix={prefix}: equal={rec['equal']} "
              f"launches_per_call={rec['launches_per_call']} {line}", flush=True)
        out[f"sha256_rows@{tag}"] = rec
    spec = mx.mont_spec(p)
    r_inv = pow(2**256, -1, p)
    for n, unreduced in [(n, False) for n in mul_shapes] + [(mul_shapes[0], True)]:
        x_np, y_np = mul_rows(np, rng, p, n, unreduced)
        x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
        kern = (lambda a=x, b_=y: mx.mont_mul_batch(a, b_, spec))
        plain = (lambda a=x, b_=y: mx.mont_mul_batch_plain(a, b_, spec))
        got, rec = held(kern, plain)
        res = bytes33_to_ints(got.cpu().numpy())
        rec["equal"] &= res == [a * b_ * r_inv % p for a, b_ in
                                zip(bytes33_to_ints(x_np), bytes33_to_ints(y_np))]
        rec["rows"] = n
        tag = "unreduced" if unreduced else str(n)
        line = "" if unreduced else time_it(rec, kern, plain, n * 3 * 33,
                                            lambda nb, k=n: mont_bound(nb, k))
        print(f"rows mont_mul@{tag} n={n}: equal={rec['equal']} "
              f"launches_per_call={rec['launches_per_call']} {line}", flush=True)
        out[f"mont_mul@{tag}"] = rec
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

        def keep(kernel, t_pack, *arrays, kept=kept):
            kept.append((kernel, arrays))
            return dispatch(kernel, t_pack, *arrays)

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


# the asynchronous plane's path: BASELINE.json configs[2] (N=64, f=21,
# 10k-tx batches; bench.py:96 measure_protocol's arrangement), one warm-up
# kick, then ASYNC_EPOCHS measured kicks (one: the Byzantine path after it
# holds the script's time); its 'cpu' twin runs the warm-up and the
# measured kick
ASYNC_N, ASYNC_BATCH, ASYNC_EPOCHS, ASYNC_TWIN_EPOCHS = 64, 10000, 1, 1
ASYNC_CONFIG_SEED, ASYNC_TX_SEED = 99, 13
# the entry points the path must launch: K1 and K5 (each node's propose,
# B=1), K6 and K3 (the hub's branch and decode waves), K8 (pooled CP
# checks) and K9 (coin and decryption-share issue)
ASYNC_SITES = ("rs_encode", "merkle_forest", "merkle_verify", "decode_recheck",
               "dual_pow", "pow_grouped")


def async_cluster(n: int, batch: int, behaviors=None, **overrides):
    """The async path's ``SimulatedCluster`` (``bench.py``
    ``measure_protocol``): the port's defaults unless ``overrides``
    (``crypto_backend``, ``device``) say otherwise; ``behaviors`` mounts
    semantic Byzantine behaviours on their nodes."""
    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster

    cfg = Config(n=n, batch_size=batch, seed=ASYNC_CONFIG_SEED, **overrides)
    return SimulatedCluster(config=cfg, key_seed=KEY_SEED, auto_propose=True,
                            shared_hub=True, behaviors=behaviors)


def async_kick(cluster, txs) -> float:
    """Queue ``txs`` round-robin over the nodes, start an epoch on every
    node and run the network until it is quiet; returns the wall seconds
    of the run (``add_transaction`` never opens an epoch by itself)."""
    ids = cluster.ids
    for i, tx in enumerate(txs):
        cluster.nodes[ids[i % len(ids)]].add_transaction(tx)
    t0 = time.perf_counter()
    for hb in cluster.nodes.values():
        hb.start_epoch()
    cluster.net.run()
    return time.perf_counter() - t0


def ledger_bytes(cluster) -> dict:
    """Every node's committed batches as their WAL record bodies."""
    from cleisthenes_tpu_torch.core.ledger import encode_batch_body

    return {nid: [encode_batch_body(e, b) for e, b in enumerate(hb.committed_batches)]
            for nid, hb in cluster.nodes.items()}


class AsyncRecorder:
    """Instruments one async run from outside the program: the host clock
    around every outermost ``CryptoHub.flush`` (with the modexp engines'
    ``stats`` inside it and the hub's per-flush column widths), and the
    arguments of every call of the six entry points, kept to time the
    kernels at the path's own shapes afterwards.  ``close`` restores
    every wrapped function.  Flushes may run in many threads at once (one
    hub a validator on the gRPC path): a lock guards the tallies, and
    ``flush_spans`` keeps each flush's (start, end) for the union of
    their wall time; there the engines' deltas inside a flush also hold
    other threads' calls, so that path reads the engines' stats over the
    whole run instead."""

    WRAPPED = (
        ("rs_cuda", "rs_encode"), ("sha256_cuda", "build_forest"),
        ("sha256_cuda", "verify_branches"), ("rs_cuda", "decode_recheck"),
        ("modexp_cuda", "dual_pow_fused"), ("modexp_cuda", "pow_fused_grouped"),
        ("modexp_cuda", "pow_fused"),
    )

    def __init__(self, engines, keep=()):
        import importlib

        from cleisthenes_tpu_torch.protocol import hub as hub_mod

        self.engines = engines
        # entry point -> [(cloned args, cloned result)]: the calls whose
        # verdicts are replayed through the plain versions afterwards
        self.kept = {name: [] for name in keep}
        self.flush_s = 0.0
        self.flush_engine = {"engine_s": 0.0, "device_s": 0.0, "calls": 0}
        self.widths = {"branch": [], "decode": [], "share": []}
        self.flush_dispatches = []
        self.flush_spans = []
        self.calls = {name: [] for _mod, name in self.WRAPPED}
        self._lock = threading.Lock()
        self._restore = []
        real_flush = hub_mod.CryptoHub.flush
        rec = self

        def flush(hub):
            if hub._flushing:
                return real_flush(hub)
            before = [dict(e.stats) for e in rec.engines]
            st = hub.stats()
            t0 = time.perf_counter()
            try:
                return real_flush(hub)
            finally:
                t1 = time.perf_counter()
                now = hub.stats()
                with rec._lock:
                    rec.flush_s += t1 - t0
                    rec.flush_spans.append((t0, t1))
                    for eng, old in zip(rec.engines, before):
                        for k_ in rec.flush_engine:
                            rec.flush_engine[k_] += eng.stats[k_] - old[k_]
                    for kind in rec.widths:
                        w = now[kind + "_items"] - st[kind + "_items"]
                        if w:
                            rec.widths[kind].append(w)
                    rec.flush_dispatches.append(now["dispatches"] - st["dispatches"])

        hub_mod.CryptoHub.flush = flush
        self._restore.append((hub_mod.CryptoHub, "flush", real_flush))
        for mod_name, name in self.WRAPPED:
            mod = importlib.import_module("cleisthenes_tpu_torch.ops." + mod_name)
            real = getattr(mod, name)

            def kept(*args, _real=real, _name=name):
                rec.calls[_name].append(args)
                if _name not in rec.kept:
                    return _real(*args)
                inputs = tuple(a.clone() if hasattr(a, "data_ptr") else a for a in args)
                out = _real(*args)
                rec.kept[_name].append((inputs, out.clone()))
                return out

            setattr(mod, name, kept)
            self._restore.append((mod, name, real))

    def close(self) -> None:
        for obj, name, real in reversed(self._restore):
            setattr(obj, name, real)
        self._restore = []


def _p50(xs):
    return statistics.median(xs) if xs else None


def async_kernel_records(torch, calls, b1_rate: float, sites=ASYNC_SITES,
                         tag: str = "async_n64") -> dict:
    """Each entry point of the async path held to its plain version and
    timed (kernel by CUDA events, median of 20; plain, once) on
    the inputs of one of its own calls in the measured run: K1 and K5 at
    their propose call (B=1; the median call by rows), K6, K3, K8 and K9
    at their median hub-wave call by rows; with the bounds ``kernel_phase``
    and ``modexp_phase`` give the same work."""
    import numpy as np

    from cleisthenes_tpu_torch.ops import modexp_cuda as mx
    from cleisthenes_tpu_torch.ops import rs_cuda as rs
    from cleisthenes_tpu_torch.ops import sha256_cuda as sh

    # the argument whose first dimension counts a call's rows
    row_arg = {"rs_encode": 1, "build_forest": 0, "verify_branches": 0,
               "decode_recheck": 2, "dual_pow_fused": 0, "pow_fused_grouped": 1,
               "pow_fused": 0}

    def median_call(name):
        cs = sorted(calls[name], key=lambda a: a[row_arg[name]].shape[0])
        return cs[len(cs) // 2], len(cs)

    def host(t):
        return t.cpu().numpy()

    out = {}
    for name in sites:
        wrapped = {"merkle_forest": "build_forest", "merkle_verify": "verify_branches",
                   "dual_pow": "dual_pow_fused", "pow_grouped": "pow_fused_grouped",
                   "pow": "pow_fused"}.get(name, name)
        if not calls[wrapped]:
            raise AssertionError(f"async path made no {wrapped} call")
        args, n_calls = median_call(wrapped)
        tc = None
        if name == "rs_encode":
            enc, data = args
            n_, k = enc.shape
            b, _, L = data.shape
            kern, plain = (lambda: rs.rs_encode(*args)), (lambda: rs.gf256_apply_plain(*args))
            nbytes = b * k * L + n_ * k + b * n_ * L
            ops = (2 * b * (n_ - k) * k * L, 0)
            tc = gf2_bit_products(n_ - k, k, b * L, 8), (0, 0)
            shape = f"B={b} n={n_} k={k} L={L}"
        elif name == "merkle_forest":
            (full,) = args
            b, n_, L = full.shape
            p = sh.next_pow2(n_)
            kern, plain = (lambda: sh.build_forest(*args)), (lambda: sh.build_forest_plain(*args))
            nbytes = b * n_ * L + b * (2 * p - 1) * 32
            ops = sha_ops(b * n_ * blocks(L + 1), b * (p - 1))
            shape = f"B={b} n={n_} L={L}"
        elif name == "merkle_verify":
            roots, leaves, br, idx = args
            b, L = leaves.shape
            d = br.shape[1]
            kern, plain = (lambda: sh.verify_branches(*args)), (lambda: sh.verify_branches_plain(*args))
            nbytes = b * (32 + L + d * 32 + 8 + 1)
            ops = sha_ops(b * blocks(L + 1), b * d)
            shape = f"B={b} L={L} D={d}"
        elif name == "decode_recheck":
            dec, enc, shards = args
            n_, k = enc.shape
            b, _, L = shards.shape
            p = sh.next_pow2(n_)
            kern, plain = (lambda: rs.decode_recheck(*args)), (lambda: rs.decode_recheck_plain(*args))
            per_instance = dec.dim() == 3
            nbytes = 2 * b * k * L + k * k * (b if per_instance else 1) + n_ * k + b * 32
            forest_ops = sha_ops(b * n_ * blocks(L + 1), b * (p - 1))
            table_ops = 2 * b * k * k * L + 2 * b * (n_ - k) * k * L
            ops = tuple(table_ops + o for o in forest_ops)
            tc = (gf2_bit_products(k, k, b * L, 8) + gf2_bit_products(n_ - k, k, b * L, 8),
                  forest_ops)
            shape = f"B={b} n={n_} k={k} L={L} per_instance_matrices={per_instance}"
        elif name == "dual_pow":
            kern, plain = (lambda: mx.dual_pow_fused(*args)), (lambda: mx.dual_pow_fused_plain(*args))
            b = args[0].shape[0]
            nbytes = b * (3 * 33 + 2 * 32)
            products = dual_products(np, *(host(a) for a in args[:4]))
            shape = f"rows={b}"
        elif name == "pow":
            kern, plain = (lambda: mx.pow_fused(*args)), (lambda: mx.pow_fused_plain(*args))
            b = args[0].shape[0]
            nbytes = b * (33 + 32 + 33)
            products = pow_products(np, host(args[0]), host(args[1]))
            shape = f"rows={b} plan={mx.pow_plan(b, sms_of(torch, args[0].device))}"
        else:  # pow_grouped
            kern, plain = (lambda: mx.pow_fused_grouped(*args)), \
                (lambda: mx.pow_fused_grouped_plain(*args))
            bases, exps, rows = (host(a) for a in args[:3])
            b = rows.shape[0]
            nbytes = bases.size + exps.size + rows.nbytes + b * 33
            products = least_comb(np, bases, exps, rows)
            shape = f"rows={b} bases={bases.shape[0]}"
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        equal = all(torch.equal(g, w) for g, w in zip(got_t, want_t))
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got_t, want_t))
        rec = {"equal": equal, "max_abs_err": float(err), "shape": shape, "calls": n_calls,
               "kernel_ms": time_ms(torch, kern, 20),
               "plain_ms": time_ms(torch, plain, 1, warm=False)}
        if name in ("dual_pow", "pow_grouped", "pow"):
            rec["bound_ms"], rec["bound_by"] = mont_bound(nbytes, products)
            rec["products"] = products
        else:
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, *ops)
            if tc is not None:  # the codecs: the lesser of their two bounds
                rec["int_bound_ms"] = rec["bound_ms"]
                t_ms, t_by = tc_bound(nbytes, tc[0], b1_rate, *tc[1])
                if t_ms < rec["bound_ms"]:
                    rec["bound_ms"], rec["bound_by"] = t_ms, t_by
                rec["tc_bound_ms"] = t_ms
        print(f"kernel {name}@{tag} {shape} (median of {n_calls} calls): "
              f"equal={equal} kernel_ms={rec['kernel_ms']} plain_ms={rec['plain_ms']} "
              f"bound_ms={rec['bound_ms']} ({rec['bound_by']}) "
              f"x_bound={rec['kernel_ms'] / rec['bound_ms']}", flush=True)
        out[name] = rec
    return out


def async_phase(torch, b1_rate: float, n: int = ASYNC_N, batch: int = ASYNC_BATCH,
                epochs: int = ASYNC_EPOCHS, twin_epochs: int = ASYNC_TWIN_EPOCHS,
                **overrides) -> dict:
    """The asynchronous protocol plane through its user entry point,
    ``SimulatedCluster``, with the port's defaults (``crypto_backend=
    'cuda'``, ``device='cuda'``) unless ``overrides`` (a CPU rehearsal
    passes device='cpu'): one warm-up kick and ``epochs`` measured kicks
    of ``batch`` random 64-byte transactions each, spread round-robin
    over the nodes.  Gates: every node commits the same batches, every
    transaction once, none left pending; every modexp engine is the
    card's; with the launch counts reset just before the measured kicks,
    ``ASYNC_SITES`` launch and nothing of ``OFF_PATH``; a twin on the
    'cpu' backend, given the same transactions and seeds for the warm-up
    and ``twin_epochs`` kicks, commits byte-identical batches on every
    node.  Prints each kick's wall seconds and committed epochs, node 0's
    two frontiers (``ordered_latency``/``epoch_latency`` p50), tx/s, the
    hub's stats and column widths, launches per kick and the split of
    the hub's flush seconds; then times the six entry points at the
    path's shapes (``async_kernel_records``).  Returns {"launches":
    per-kick launch dicts, "kernels": records}."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.ops.modmath import get_engine_degraded

    t0 = time.perf_counter()
    cluster = async_cluster(n, batch, **overrides)
    cfg = cluster.config
    hub = cluster._hub
    keys = cluster.keys[cluster.ids[0]]
    print(
        f"async_phase: SimulatedCluster(n={n}, batch_size={batch}, seed="
        f"{ASYNC_CONFIG_SEED}, key_seed={KEY_SEED}) backend={cfg.crypto_backend} "
        f"device={cfg.device} f={cfg.f} k={cfg.data_shards} "
        f"pipeline_depth={cfg.pipeline_depth} group_bits="
        f"{keys.tpke_pub.group.p.bit_length()} codec={type(hub.crypto.erasure).__name__} "
        f"setup_s={time.perf_counter() - t0}",
        flush=True,
    )
    on_card = torch.device(cfg.device).type == "cuda" and cfg.crypto_backend == "cuda"
    engines = [
        get_engine_degraded(hub.crypto.engine_backend, gp, hub.crypto.device)
        for gp in {keys.tpke_pub.group, keys.coin_pub.group}
    ]
    if on_card and any(eng.backend != "cuda" for eng in engines):
        raise AssertionError("a modexp engine of the async path is not the card's")
    rows = np.random.default_rng(ASYNC_TX_SEED).integers(
        0, 256, ((epochs + 1) * batch, TX_BYTES), dtype=np.uint8)
    txs = [r.tobytes() for r in rows]
    kicks = [txs[i * batch:(i + 1) * batch] for i in range(epochs + 1)]
    warm_s = async_kick(cluster, kicks[0])
    n0 = cluster.nodes[cluster.ids[0]]
    print(f"async warm-up: wall_s={warm_s} settled_epochs={n0.settled_epoch}", flush=True)
    if n0.settled_epoch < 1:
        raise AssertionError("async warm-up epoch did not commit")
    depth_after = [len(n0.committed_batches)]
    rec = AsyncRecorder(engines)
    COUNTS.reset()
    kick_s, per_kick, st0 = [], [], hub.stats()
    eng0 = [dict(e.stats) for e in engines]
    mark = time.monotonic()
    try:
        for e in range(epochs):
            before = launch_counts()
            kick_s.append(async_kick(cluster, kicks[e + 1]))
            if on_card:
                torch.cuda.synchronize()
            now = launch_counts()
            per_kick.append({
                kind: {k_: v - before[kind].get(k_, 0) for k_, v in now[kind].items()
                       if v - before[kind].get(k_, 0)}
                for kind in now
            })
            depth_after.append(len(n0.committed_batches))
            print(f"async epoch {e}: wall_s={kick_s[-1]} settled_epochs="
                  f"{n0.settled_epoch} launches={json.dumps(per_kick[-1]['sites'], sort_keys=True)}",
                  flush=True)
    finally:
        rec.close()
    launches = launch_counts()
    # gates: agreement, exactly-once, nothing pending, launches
    cluster.assert_agreement()
    committed = [tx for b in n0.committed_batches for tx in b.tx_list()]
    pending = sum(hb.outstanding_tx_count() for hb in cluster.nodes.values())
    if pending or len(committed) != len(txs) or set(committed) != set(txs):
        raise AssertionError(
            f"async path committed {len(committed)} txs ({len(set(committed))} "
            f"distinct) of {len(txs)}, {pending} outstanding")
    for site in ASYNC_SITES:
        if on_card and launches["sites"].get(site, 0) <= 0:
            raise AssertionError(f"async path never launched {site}: {launches}")
    for site in OFF_PATH:
        if launches["sites"].get(site, 0):
            raise AssertionError(f"async path launched {site}: {launches}")
    m = n0.metrics
    spans = [(tp, tc) for _e, tp, tc in m.epoch_spans() if tp >= mark and tc is not None]
    st = {k_: v - st0[k_] for k_, v in hub.stats().items()}
    eng = {k_: sum(e.stats[k_] - o[k_] for e, o in zip(engines, eng0))
           for k_ in ("calls", "engine_s", "device_s")}
    measured_txs = epochs * batch
    print(
        f"async_path: n={n} f={cfg.f} batch={batch} txs={len(txs)} committed_once="
        f"{len(committed)} measured_kicks={epochs} kick_wall_s={kick_s} "
        f"epochs_settled_in_window={len(spans)} "
        f"ordered_epoch_p50_s={m.ordered_latency.p50} "
        f"settled_epoch_p50_s={m.epoch_latency.p50} "
        f"tx_per_s={measured_txs / sum(kick_s)}",
        flush=True,
    )
    print("async_hub_stats " + json.dumps({
        **st,
        "flushes_timed": len(rec.flush_dispatches),
        "dispatches_per_flush_p50": _p50(rec.flush_dispatches),
        "wave_width_p50": {k_: _p50(v) for k_, v in rec.widths.items()},
        "wave_width_max": {k_: max(v) if v else None for k_, v in rec.widths.items()},
        "waves": {k_: len(v) for k_, v in rec.widths.items()},
    }, sort_keys=True), flush=True)
    fe = rec.flush_engine
    print(
        f"async_flush_split: kick_s={sum(kick_s)} flush_s={rec.flush_s} "
        f"flush_engine_s={fe['engine_s']} flush_device_s={fe['device_s']} "
        f"flush_packing_s={fe['engine_s'] - fe['device_s']} "
        f"flush_host_python_s={rec.flush_s - fe['engine_s']} "
        f"engine_calls_in_flush={fe['calls']} engine_s_whole_run={eng['engine_s']} "
        f"device_s_whole_run={eng['device_s']} engine_calls_whole_run={eng['calls']} "
        f"outside_flush_s={sum(kick_s) - rec.flush_s}",
        flush=True,
    )
    print("launches_async_path " + json.dumps(launches, sort_keys=True), flush=True)
    print("launches_async_per_kick " + json.dumps(per_kick, sort_keys=True), flush=True)
    # the 'cpu' twin: the same transactions, seeds and kicks
    t0 = time.perf_counter()
    twin = async_cluster(n, batch, crypto_backend="cpu")
    twin_s = [async_kick(twin, kicks[i]) for i in range(1 + twin_epochs)]
    card_l, twin_l = ledger_bytes(cluster), ledger_bytes(twin)
    depth = len(twin_l[cluster.ids[0]])
    same = depth == depth_after[twin_epochs] and all(
        twin_l[nid] == card_l[nid][:depth] for nid in cluster.ids)
    print(f"async_twin: backend=cpu kicks={1 + twin_epochs} kick_wall_s={twin_s} "
          f"depth={depth} card_depth={depth_after[twin_epochs]} "
          f"ledger_equal={same} total_s={time.perf_counter() - t0}", flush=True)
    if not same:
        raise AssertionError("the card cluster's ledger differs from the cpu twin's")
    del twin
    records = async_kernel_records(torch, rec.calls, b1_rate) if on_card else {}
    bad = [name for name, r in records.items() if not r["equal"]]
    if bad:
        raise AssertionError(f"async-shape kernels disagree with their plain versions: {bad}")
    return {"launches": per_kick, "kernels": records}


# the Byzantine path: the async path's deployment (BASELINE.json
# configs[2]) at its full fault budget.  The first f nodes by id lie,
# node i with BYZ_KINDS[i % 6] seeded BYZ_BEHAVIOR_SEED + i (tx_injector,
# the fuzzer's planted violation, stays out), under a wire coalition of
# the same nodes; BYZ_TXS random 64-byte transactions go round-robin to
# the honest nodes, and one run_until_drained orders them all
BYZ_KINDS = ("share_forger", "bad_dealer", "equivocator", "split_voter",
             "selective_mute", "epoch_sprayer")
BYZ_BEHAVIOR_SEED, BYZ_WIRE_SEED, BYZ_TX_SEED = 101, 7, 17
BYZ_TXS = 10000
# run_until_drained's cap on proposal rounds (a round runs the network to
# quiet, and auto-propose chains its epochs): one round drained the
# coalition run at N=64 in the CPU rehearsal; the slack is for the card
BYZ_MAX_ROUNDS = 8


def byzantine_coalition(f: int):
    """(the coalition's ids, their behaviours): fresh behaviour objects
    on every call, so a twin run draws the same lies from the start."""
    from cleisthenes_tpu_torch.protocol.byzantine import make_behavior

    bad = [f"node{i:03d}" for i in range(f)]
    return bad, {b: make_behavior(BYZ_KINDS[i % len(BYZ_KINDS)],
                                  seed=BYZ_BEHAVIOR_SEED + i)
                 for i, b in enumerate(bad)}


def byzantine_cluster(n: int, batch: int, **overrides):
    """The Byzantine path's cluster: ``async_cluster`` with the
    coalition's behaviours mounted and its wire adversary (drop 10 %,
    tamper 5 %, reorder 20 % of the coalition's frames) on the channel
    transport.  Returns (cluster, the coalition's ids)."""
    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.utils.adversary import Coalition

    f = Config(n=n).f
    bad, behaviors = byzantine_coalition(f)
    cluster = async_cluster(n, batch, behaviors=behaviors, **overrides)
    cluster.fault_filter = (
        Coalition(bad, seed=BYZ_WIRE_SEED).drop(0.1).tamper(0.05).reorder(0.2).filter)
    return cluster, bad


def byzantine_txs(count: int) -> list:
    import numpy as np

    rows = np.random.default_rng(BYZ_TX_SEED).integers(
        0, 256, (count, TX_BYTES), dtype=np.uint8)
    return [r.tobytes() for r in rows]


class RejectTap:
    """Counts, on any backend, what one cluster's hub waves reject: false
    verdicts of the branch wave (``merkle.verify_batch``) and of the
    pooled CP checks (``verify_share_groups``), and the decode groups
    with the dispatches they cost (one fused call on 'cuda', three on
    the host backend).  ``k8_calls``, the recorder's list of K8
    arguments, lets it mark the K8 calls made inside a check that
    returned a false verdict.  ``close`` restores what it wrapped."""

    def __init__(self, cluster, k8_calls=None):
        from cleisthenes_tpu_torch.protocol import hub as hub_mod

        crypto = cluster._hub.crypto
        self.branch_false = self.branch_verdicts = 0
        self.share_false = self.share_checks = 0
        self.decode_groups = self.decode_dispatches = 0
        self.k8_false_calls = set()
        tap = self
        real_verify = crypto.merkle.verify_batch
        real_shares = hub_mod.verify_share_groups
        real_decode = crypto.decode_recheck_batch

        def verify_batch(*args):
            ok = real_verify(*args)
            tap.branch_verdicts += len(ok)
            tap.branch_false += len(ok) - int(sum(bool(x) for x in ok))
            return ok

        def verify_share_groups(*args, **kw):
            first = len(k8_calls) if k8_calls is not None else 0
            verdicts = real_shares(*args, **kw)
            flat = [v for group in verdicts for v in group]
            tap.share_checks += len(flat)
            tap.share_false += flat.count(False)
            if k8_calls is not None and False in flat:
                tap.k8_false_calls.update(range(first, len(k8_calls)))
            return verdicts

        def decode_recheck_batch(*args):
            out = real_decode(*args)
            tap.decode_groups += 1
            tap.decode_dispatches += out[2]
            return out

        crypto.merkle.verify_batch = verify_batch
        hub_mod.verify_share_groups = verify_share_groups
        crypto.decode_recheck_batch = decode_recheck_batch
        self._restore = [(hub_mod, "verify_share_groups", real_shares)]
        self._own = [(crypto.merkle, "verify_batch"), (crypto, "decode_recheck_batch")]

    def close(self) -> None:
        for obj, name, real in self._restore:
            setattr(obj, name, real)
        for obj, name in self._own:
            delattr(obj, name)
        self._restore, self._own = [], []

    def counts(self) -> dict:
        return {"branch_false": self.branch_false, "branch_verdicts": self.branch_verdicts,
                "cp_false": self.share_false, "cp_checks": self.share_checks,
                "decode_groups": self.decode_groups,
                "decode_dispatches": self.decode_dispatches}


def byzantine_run(cluster, bad, txs, max_rounds: int):
    """Submit ``txs`` round-robin to the honest nodes and drain once;
    returns (wall seconds, rounds used)."""
    honest = [i for i in cluster.ids if i not in bad]
    for i, tx in enumerate(txs):
        cluster.submit(tx, node_id=honest[i % len(honest)])
    t0 = time.perf_counter()
    rounds = cluster.run_until_drained(max_rounds=max_rounds, skip=bad)
    return time.perf_counter() - t0, rounds


def byzantine_phase(torch, b1_rate: float, n: int = ASYNC_N, batch: int = ASYNC_BATCH,
                    txs: int = BYZ_TXS, max_rounds: int = BYZ_MAX_ROUNDS, twin: bool = True,
                    **overrides) -> dict:
    """The async path's deployment at its full fault budget, through the
    same entry point (``SimulatedCluster`` on the port's defaults unless
    ``overrides`` say otherwise): f nodes lie (``byzantine_cluster``),
    ``txs`` random transactions go to the honest nodes, and one
    ``run_until_drained`` orders them, with the launch counts set to 0
    just before.  Gates: (1) the honest nodes agree to a depth of at
    least 2 and each commits every transaction exactly once, nothing
    foreign, nothing left pending; (2) every behaviour lied; (3) the
    modexp engines are the card's, ``ASYNC_SITES`` launch and nothing of
    ``OFF_PATH`` (K7's launches are printed); (4) the branch wave's K6
    calls returned false verdicts (BadDealer) and the pooled CP checks
    false ones (ShareForger); on the card every K6 call, the median K8
    call and every K8 call inside a check with a false verdict give on
    their plain versions what they gave in the run; (5) with ``twin``, a
    'cpu' twin (fresh behaviours and wire adversary from the same seeds,
    the same transactions) commits byte-identical honest ledgers, each
    behaviour lies as often, and the hub's stats and reject counts match
    (dispatches less the decode dispatches, which the host backend
    counts three to a group).  Prints the run's wall seconds, epochs,
    tx/s, the lowest honest node's frontiers, the hub's flush split,
    rewrites by kind, rejects by kernel and launches, then times K6 and
    K8 at their median call.  Returns {"launches", "rejects", "kernels"}."""
    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.ops.modmath import get_engine_degraded

    t0 = time.perf_counter()
    cluster, bad = byzantine_cluster(n, batch, **overrides)
    cfg, hub = cluster.config, cluster._hub
    honest = [i for i in cluster.ids if i not in bad]
    keys = cluster.keys[honest[0]]
    kinds = {b: type(beh).__name__ for b, beh in cluster.behaviors.items()}
    print(
        f"byzantine_phase: SimulatedCluster(n={n}, batch_size={batch}, seed="
        f"{ASYNC_CONFIG_SEED}, key_seed={KEY_SEED}) backend={cfg.crypto_backend} "
        f"device={cfg.device} f={cfg.f} k={cfg.data_shards} coalition={len(bad)} "
        f"({bad[0]}..{bad[-1]}) kinds={json.dumps(collections.Counter(kinds.values()))} "
        f"wire=Coalition(seed={BYZ_WIRE_SEED}).drop(0.1).tamper(0.05).reorder(0.2) "
        f"txs={txs} setup_s={time.perf_counter() - t0}",
        flush=True,
    )
    on_card = torch.device(cfg.device).type == "cuda" and cfg.crypto_backend == "cuda"
    engines = [
        get_engine_degraded(hub.crypto.engine_backend, gp, hub.crypto.device)
        for gp in {keys.tpke_pub.group, keys.coin_pub.group}
    ]
    if on_card and any(eng.backend != "cuda" for eng in engines):
        raise AssertionError("a modexp engine of the Byzantine path is not the card's")
    tx_list = byzantine_txs(txs)
    rec = AsyncRecorder(engines, keep=("verify_branches", "dual_pow_fused"))
    tap = RejectTap(cluster, rec.calls["dual_pow_fused"])
    st0, eng0 = hub.stats(), [dict(e.stats) for e in engines]
    COUNTS.reset()
    try:
        wall, rounds = byzantine_run(cluster, bad, tx_list, max_rounds)
        if on_card:
            torch.cuda.synchronize()
    finally:
        tap.close()
        rec.close()
    launches = launch_counts()
    # (1) agreement, exactly once on every honest node, nothing pending
    depth = cluster.assert_agreement(skip=bad)
    want = set(tx_list)
    for nid in honest:
        hb = cluster.nodes[nid]
        got = [tx for b in hb.committed_batches for tx in b.tx_list()]
        if (len(got) != len(tx_list) or set(got) != want
                or hb.outstanding_tx_count()):
            raise AssertionError(
                f"{nid} committed {len(got)} txs ({len(set(got))} distinct, "
                f"{len(set(got) - want)} foreign) of {len(tx_list)}, "
                f"{hb.outstanding_tx_count()} outstanding, after {rounds} rounds")
    if depth < 2:
        raise AssertionError(f"honest agreement reached depth {depth} < 2")
    # (2) every behaviour lied
    rewrites = {b: beh.rewrites for b, beh in cluster.behaviors.items()}
    if not all(rewrites.values()):
        raise AssertionError(f"behaviours that never lied: "
                             f"{[b for b, r in rewrites.items() if not r]}")
    # (3) launches
    for site in ASYNC_SITES:
        if on_card and launches["sites"].get(site, 0) <= 0:
            raise AssertionError(f"Byzantine path never launched {site}: {launches}")
    for site in OFF_PATH:
        if launches["sites"].get(site, 0):
            raise AssertionError(f"Byzantine path launched {site}: {launches}")
    # (4) the reject paths: on the 'cuda' backend every branch verdict is
    # K6's and every CP check runs on K8
    k6_false = sum(int((~out).sum()) for _args, out in rec.kept["verify_branches"])
    rejects = {**tap.counts(), "k6_false": k6_false,
               "k6_calls": len(rec.kept["verify_branches"]),
               "k8_calls": len(rec.kept["dual_pow_fused"]),
               "k8_calls_with_a_false_verdict": len(tap.k8_false_calls)}
    if tap.branch_false <= 0 or tap.share_false <= 0:
        raise AssertionError(f"no false branch or CP verdict in the Byzantine run: {rejects}")
    if cfg.crypto_backend == "cuda" and (
            k6_false != tap.branch_false or not tap.k8_false_calls):
        raise AssertionError(f"the false verdicts are not K6's and K8's: {rejects}")
    if on_card:
        replay = byzantine_replay(torch, rec.kept, tap.k8_false_calls)
        rejects["replayed"] = replay
    n_lo = cluster.nodes[honest[0]]
    m = n_lo.metrics
    st = {k_: v - st0[k_] for k_, v in hub.stats().items()}
    eng = {k_: sum(e.stats[k_] - o[k_] for e, o in zip(engines, eng0))
           for k_ in ("calls", "engine_s", "device_s")}
    by_kind = {}
    for b, r in rewrites.items():
        by_kind[kinds[b]] = by_kind.get(kinds[b], 0) + r
    print(
        f"byzantine_path: n={n} f={cfg.f} batch={batch} txs={len(tx_list)} "
        f"wall_s={wall} rounds={rounds} epochs={depth} tx_per_s={len(tx_list) / wall} "
        f"lowest_honest={honest[0]} ordered_epoch_p50_s={m.ordered_latency.p50} "
        f"settled_epoch_p50_s={m.epoch_latency.p50}",
        flush=True,
    )
    fe = rec.flush_engine
    print(
        f"byzantine_flush_split: wall_s={wall} flush_s={rec.flush_s} "
        f"flush_engine_s={fe['engine_s']} flush_device_s={fe['device_s']} "
        f"flush_packing_s={fe['engine_s'] - fe['device_s']} "
        f"flush_host_python_s={rec.flush_s - fe['engine_s']} "
        f"engine_calls_in_flush={fe['calls']} engine_s_whole_run={eng['engine_s']} "
        f"device_s_whole_run={eng['device_s']} outside_flush_s={wall - rec.flush_s}",
        flush=True,
    )
    print("byzantine_hub_stats " + json.dumps({
        **st, "waves": {k_: len(v) for k_, v in rec.widths.items()},
        "wave_width_p50": {k_: _p50(v) for k_, v in rec.widths.items()},
    }, sort_keys=True), flush=True)
    print("byzantine_rewrites " + json.dumps({"by_kind": by_kind, "by_node": rewrites},
                                             sort_keys=True), flush=True)
    print("byzantine_rejects " + json.dumps(rejects, sort_keys=True), flush=True)
    print("launches_byzantine_path " + json.dumps(launches, sort_keys=True), flush=True)
    print(f"byzantine_k7_launches: pow={launches['sites'].get('pow', 0)} "
          f"pow_fused={launches['kernels'].get('pow_fused', 0)}", flush=True)
    if twin:
        twin_res = byzantine_twin(n, batch, tx_list, max_rounds, cluster, bad, st,
                                  tap.counts())
        print("byzantine_twin " + json.dumps(twin_res, sort_keys=True), flush=True)
    records = (async_kernel_records(torch, rec.calls, b1_rate,
                                    sites=("merkle_verify", "dual_pow"), tag="async_n64_byz")
               if on_card else {})
    bad_k = [name for name, r in records.items() if not r["equal"]]
    if bad_k:
        raise AssertionError(f"Byzantine-shape kernels disagree with their plain "
                             f"versions: {bad_k}")
    return {"launches": launches, "rejects": rejects, "kernels": records}


def byzantine_replay(torch, kept, k8_false_calls) -> dict:
    """Every kept K6 call and the median K8 call plus every K8 call
    inside a check with a false verdict, through their plain versions on
    the card: the results must equal the run's (K6's verdict vectors;
    K8's values, from which the host draws the CP verdicts).  The K8
    calls' rows go through one plain call (each row is its own dual
    pow), whose cost is mostly per call."""
    from cleisthenes_tpu_torch.ops import modexp_cuda as mx
    from cleisthenes_tpu_torch.ops import sha256_cuda as sh

    k8 = kept["dual_pow_fused"]
    by_rows = sorted(range(len(k8)), key=lambda i: k8[i][0][0].shape[0])
    picks = sorted(set(k8_false_calls) | {by_rows[len(by_rows) // 2]})
    k6_differ = sum(
        not torch.equal(sh.verify_branches_plain(*args), out)
        for args, out in kept["verify_branches"])
    by_modulus = {}
    for i in picks:
        by_modulus.setdefault(k8[i][0][4].p, []).append(i)
    k8_rows = k8_differ = 0
    for calls in by_modulus.values():
        rows = [torch.cat([k8[i][0][j] for i in calls]) for j in range(4)]
        got = mx.dual_pow_fused_plain(*rows, k8[calls[0]][0][4])
        want = torch.cat([k8[i][1] for i in calls])
        k8_rows += want.shape[0]
        k8_differ += int((got != want).any(dim=1).sum())
    torch.cuda.synchronize()
    res = {"k6_calls": len(kept["verify_branches"]), "k6_differ": int(k6_differ),
           "k8_calls": len(picks), "k8_rows": k8_rows, "k8_rows_differ": k8_differ}
    if k6_differ or k8_differ:
        raise AssertionError(f"replayed K6/K8 calls differ from their plain versions: {res}")
    return res


def byzantine_twin(n, batch, tx_list, max_rounds, card, bad, card_stats, card_rejects):
    """The Byzantine run again on the 'cpu' backend from fresh objects and
    the same seeds; raises unless it matches the card's run."""
    t0 = time.perf_counter()
    twin, _ = byzantine_cluster(n, batch, crypto_backend="cpu")
    st0 = twin._hub.stats()
    tap = RejectTap(twin)
    try:
        wall, rounds = byzantine_run(twin, bad, tx_list, max_rounds)
    finally:
        tap.close()
    st = {k_: v - st0[k_] for k_, v in twin._hub.stats().items()}
    twin_rejects = tap.counts()
    card_l, twin_l = ledger_bytes(card), ledger_bytes(twin)
    honest = [i for i in card.ids if i not in bad]
    same_ledger = all(card_l[nid] == twin_l[nid] for nid in honest)
    card_rw = {b: beh.rewrites for b, beh in card.behaviors.items()}
    twin_rw = {b: beh.rewrites for b, beh in twin.behaviors.items()}

    def comparable(stats, rej):
        out = dict(stats, dispatches=stats["dispatches"] - rej["decode_dispatches"])
        out.update({k_: rej[k_] for k_ in ("branch_false", "branch_verdicts", "cp_false",
                                           "cp_checks", "decode_groups")})
        return out

    res = {"wall_s": wall, "rounds": rounds, "total_s": time.perf_counter() - t0,
           "depth": len(twin_l[honest[0]]), "ledger_equal": same_ledger,
           "rewrites_equal": card_rw == twin_rw,
           "stats_equal": comparable(card_stats, card_rejects) == comparable(st, twin_rejects),
           "stats": st, "rejects": twin_rejects}
    if not (same_ledger and res["rewrites_equal"] and res["stats_equal"]):
        raise AssertionError(f"the cpu twin of the Byzantine run differs: {res} "
                             f"card stats {card_stats} rejects {card_rejects}")
    return res


# the gRPC path: BASELINE.json configs[1] ("N=16 f=5, 4k-tx batch") as the
# system is deployed, one ValidatorHost a validator (its own CryptoHub,
# dispatcher thread, gRPC server and dialed streams), node00-node15 in
# this process on 127.0.0.1 ephemeral ports, batch logs on and obs_port=0;
# a warm-up of GRPC_WARM_TXS transactions, then GRPC_TXS measured, each
# submitted round-robin and proposed on every host until every host has
# committed every one; a 'cpu' twin takes the same roster, seeds and
# transactions
GRPC_N, GRPC_BATCH, GRPC_TXS, GRPC_WARM_TXS = 16, 4096, 8192, 4096
GRPC_CONFIG_SEED, GRPC_TX_SEED = 99, 19
GRPC_TIMEOUT_S = 600.0
# the roster is idle once its counters hold still this long (its epochs
# take seconds each at n=16); it must be idle within the timeout
GRPC_QUIET_S, GRPC_QUIET_TIMEOUT_S = 2.0, 120.0
# the entry points the path must launch: the async path's, but K7 (pow)
# where it has K9 (pow_grouped): a host's hub issues at most n coin or
# decryption shares a wave, 3 exponentiations each, below the comb's
# COMB_MIN = 64 at n=16, so its grouped calls flatten into one generic
# pow; K9 runs only where a wave reaches 64 (its records are kept then)
GRPC_SITES = ("rs_encode", "merkle_forest", "merkle_verify", "decode_recheck",
              "dual_pow", "pow")
# the threads a host starts; none may outlive its stop()
HOST_THREADS = ("dispatch-", "conn-read-", "conn-ingest-", "redial-", "obs-",
                "grpc-server")


def grpc_hosts(n: int, batch: int, log_dir: str, **overrides):
    """``n`` ValidatorHosts on the port's defaults unless ``overrides``
    (``crypto_backend``, ``device``) say otherwise, each with a batch log
    in ``log_dir`` and telemetry on an ephemeral port; all listen, then
    each dials every peer from a thread of its own, as the demo boots
    them.  Returns the hosts by id."""
    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.protocol.honeybadger import setup_keys
    from cleisthenes_tpu_torch.transport.host import ValidatorHost

    cfg = Config(n=n, batch_size=batch, seed=GRPC_CONFIG_SEED, obs_port=0, **overrides)
    ids = [f"node{i:02d}" for i in range(n)]
    keys = setup_keys(cfg, ids, seed=KEY_SEED)
    hosts = {}
    try:
        for nid in ids:
            hosts[nid] = ValidatorHost(cfg, nid, ids, keys[nid],
                                       batch_log_path=os.path.join(log_dir, f"{nid}.log"))
        addrs = {nid: h.listen() for nid, h in hosts.items()}
        dials = [threading.Thread(target=h.connect, args=(addrs,)) for h in hosts.values()]
        for t in dials:
            t.start()
        for t in dials:
            t.join(60)
        short = {nid: len(h.pool) for nid, h in hosts.items() if len(h.pool) != n - 1}
        if short or any(t.is_alive() for t in dials):
            raise AssertionError(f"gRPC roster did not connect: pool sizes {short}")
    except BaseException:
        stop_hosts(hosts)
        raise
    return hosts


def host_threads() -> list:
    return sorted(t.name for t in threading.enumerate() if t.name.startswith(HOST_THREADS))


def stop_hosts(hosts) -> list:
    """Stop every host, all at once as the processes of a deployment
    would (a thread each); returns the names of host threads still alive
    after a grace of a few seconds (their joins are bounded)."""
    stops = [threading.Thread(target=h.stop) for h in hosts.values()]
    for t in stops:
        t.start()
    for t in stops:
        t.join(60)
    deadline = time.monotonic() + 5.0
    while host_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    return host_threads()


def grpc_commit_all(hosts, txs, timeout: float = GRPC_TIMEOUT_S) -> float:
    """Submit ``txs`` round-robin over the hosts and propose on every host
    (again each second: a host mid-epoch ignores it, and auto-propose
    chains the epochs) until every host has committed every one of them;
    returns the wall seconds from the first propose."""
    ids = sorted(hosts)
    for i, tx in enumerate(txs):
        hosts[ids[i % len(ids)]].submit(tx)
    want = set(txs)
    left = {nid: set(want) for nid in ids}
    t0 = time.perf_counter()
    next_propose = 0.0
    while any(left.values()):
        now = time.perf_counter()
        if now - t0 > timeout:
            raise AssertionError(
                f"gRPC roster left {sum(map(len, left.values()))} commits after {timeout} s")
        if now >= next_propose:
            for h in hosts.values():
                h.propose()
            next_propose = now + 1.0
        idle = True
        for nid, h in hosts.items():
            while True:
                try:
                    _epoch, batch_ = h.wait_commit(timeout=0)
                except queue.Empty:
                    break
                left[nid].difference_update(batch_.tx_list())
                idle = False
        if idle:
            time.sleep(0.002)
    return time.perf_counter() - t0


def grpc_ledgers(hosts, settle_s: float = 10.0) -> dict:
    """({host: its batches as WAL record bodies}, {host: its batches}),
    read on each host's dispatcher once every host has the same depth
    (or ``settle_s`` passed)."""
    from cleisthenes_tpu_torch.core.ledger import encode_batch_body

    deadline = time.monotonic() + settle_s
    while True:
        batches = {nid: h.committed_batches() for nid, h in hosts.items()}
        if len({len(b) for b in batches.values()}) == 1 or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    return {nid: [encode_batch_body(e, b) for e, b in enumerate(bs)]
            for nid, bs in batches.items()}, batches


def parse_exposition(text: str) -> dict:
    """Prometheus text exposition -> {(name, ((label, value), ...)): value};
    raises on a line that is not ``name{labels} value``."""
    import re

    label = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.fullmatch(r"(\w+)\{(.*)\} (\S+)", line)
        if m is None:
            raise AssertionError(f"unparsable exposition line: {line!r}")
        labels = tuple(sorted(label.findall(m.group(2))))
        out[(m.group(1), labels)] = float(m.group(3).replace("+Inf", "inf"))
    return out


# the counters the scrape gate holds /metrics to, by exposition family:
# (family, snapshot block, ((result label, key), ...)) and (family,
# block, key)
SCRAPE_LABELLED = (
    ("transport_frames_total", "transport", (("delivered", "delivered"),
                                             ("rejected", "rejected"))),
    ("transport_decode_memo_total", "transport", (("hit", "decode_memo_hits"),
                                                  ("miss", "decode_memo_misses"))),
    ("transport_encode_memo_total", "transport", (("hit", "encode_memo_hits"),
                                                  ("miss", "encode_memo_misses"))))
SCRAPE_PLAIN = (("transport_frames_decoded_total", "transport", "frames_decoded"),
                ("transport_mac_verify_batches_total", "transport", "mac_verify_batches"),
                ("transport_frames_encoded_total", "transport", "frames_encoded"),
                ("transport_mac_sign_batches_total", "transport", "mac_sign_batches"),
                ("dedup_absorbed_total", "transport", "dedup_absorbed"),
                ("coin_share_batches_total", "hub", "coin_share_batches"),
                ("coin_share_items_total", "hub", "coin_share_items"))


def scrape_counters(nid: str, snap: dict) -> dict:
    """{(exposition name, labels): value} of the scrape gate's counters in
    node ``nid``'s ``metrics.snapshot()``."""
    out = {}
    for fam, block, pairs in SCRAPE_LABELLED:
        for lab, key in pairs:
            out[(f"cleisthenes_{fam}", (("node", nid), ("result", lab)))] = float(
                snap[block][key])
    for fam, block, key in SCRAPE_PLAIN:
        out[(f"cleisthenes_{fam}", (("node", nid),))] = float(snap[block][key])
    return out


def grpc_quiesce(hosts, still_s: float = GRPC_QUIET_S,
                 timeout: float = GRPC_QUIET_TIMEOUT_S) -> float:
    """Wait for the roster to go idle after a run.  The last propose kick
    of ``grpc_commit_all`` may open an (empty) epoch that every host
    follows, so traffic goes on after the last commit.  The card run and
    its twin wait after the warm-up too: a host that orders an epoch
    while the next transactions are still being submitted proposes from
    a half-filled queue, and its batches then depend on thread timing.
    Idle: every
    dispatcher has drained its mailbox and no host's scrape counters
    (``scrape_counters``) moved over ``still_s``.  Returns the seconds
    waited; raises if the roster is not idle within ``timeout``."""
    t0 = time.monotonic()

    def reading():
        for h in hosts.values():  # the wait's own budget, not drain's 30 s
            h.dispatcher.drain(timeout=max(1.0, timeout - (time.monotonic() - t0)))
        return {nid: scrape_counters(nid, h.node.metrics.snapshot())
                for nid, h in hosts.items()}

    last = reading()
    while True:
        time.sleep(still_s)
        now = reading()
        if now == last:
            return time.monotonic() - t0
        if time.monotonic() - t0 > timeout:
            moved = {nid: {k[0]: (last[nid][k], v) for k, v in now[nid].items()
                           if last[nid][k] != v} for nid in now}
            raise AssertionError(f"the gRPC roster was still busy {timeout} s after its "
                                 f"run: {({nid: m for nid, m in moved.items() if m})}")
        last = now


def scrape_gate(host) -> dict:
    """Fetch /metrics and /healthz from ``host``'s telemetry port and hold
    them to ``node.metrics.snapshot()`` read before and after the scrape
    (equal reads: the counters were still; the caller first waits for the
    roster to go idle, ``grpc_quiesce``): every transport frame counter
    and the hub's coin dispatch counters (``scrape_counters``), every
    peer UP."""
    import urllib.request

    base = f"http://127.0.0.1:{host.obs.port}"
    nid = host.node_id

    def fetch(path):
        with urllib.request.urlopen(base + path, timeout=10) as resp:
            return resp.status, resp.read().decode("utf-8")

    for _attempt in range(20):
        before = host.node.metrics.snapshot()
        status, text = fetch("/metrics")
        after = host.node.metrics.snapshot()
        if scrape_counters(nid, before) == scrape_counters(nid, after):
            break
        time.sleep(0.25)
    else:
        raise AssertionError("the node's counters never held still for a scrape")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    got = parse_exposition(text)
    want = scrape_counters(nid, after)
    differ = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if differ:
        raise AssertionError(f"/metrics differs from node.metrics.snapshot(): {differ}")
    peers = {dict(k[1])["peer"]: dict(k[1])["state"] for k in got
             if k[0] == "cleisthenes_peer_health"}
    h_status, h_body = fetch("/healthz")
    health = json.loads(h_body)
    if (len(peers) != len(host.members) - 1 or set(peers.values()) != {"up"}
            or h_status != 200 or health["status"] != "up"):
        raise AssertionError(f"peers not all UP: /healthz {h_status} {health}, "
                             f"/metrics peer states {peers}")
    return {"families_parsed": len({k[0] for k in got}), "samples": len(got),
            "counters_checked": len(want), "peers_up": len(peers),
            "healthz": health["status"],
            "frames_delivered": after["transport"]["delivered"],
            "frames_rejected": after["transport"]["rejected"],
            "mac_verify_batches": after["transport"]["mac_verify_batches"],
            "encode_memo_hits": after["transport"]["encode_memo_hits"],
            "frames_encoded": after["transport"]["frames_encoded"]}


def proposer_sets(batches) -> list:
    return [sorted(b.contributions) for b in batches]


def grpc_twin(n, batch, warm, txs, card_ledgers, card_batches) -> dict:
    """The gRPC run again on the 'cpu' backend: the same roster, seeds and
    transactions.  It must commit the same set of transactions, and byte-
    equal batches at every epoch of the longest prefix over which both
    runs' ACS included the same proposers (real sockets order messages by
    thread timing, so the included sets may differ, and a proposer left
    out keeps its transactions for a later epoch: past the first
    difference the batches legitimately differ).  Prints each epoch's
    proposers for both runs; on a difference, names the epochs."""
    t0 = time.perf_counter()
    log_dir = tempfile.mkdtemp(prefix="grpc-twin-")
    hosts = grpc_hosts(n, batch, log_dir, crypto_backend="cpu")
    try:
        warm_s = grpc_commit_all(hosts, warm)
        grpc_quiesce(hosts)
        run_s = grpc_commit_all(hosts, txs)
        quiet_s = grpc_quiesce(hosts)
        ledgers, batches = grpc_ledgers(hosts)
    finally:
        leftover = stop_hosts(hosts)
        shutil.rmtree(log_dir, ignore_errors=True)
    nid = sorted(hosts)[0]
    card_p, twin_p = proposer_sets(card_batches[nid]), proposer_sets(batches[nid])
    prefix = 0
    while (prefix < min(len(card_p), len(twin_p))
           and card_p[prefix] == twin_p[prefix]):
        prefix += 1
    card_set = {tx for b in card_batches[nid] for tx in b.tx_list()}
    twin_set = {tx for b in batches[nid] for tx in b.tx_list()}
    differ = sorted({e for h in ledgers for e in range(prefix)
                     if ledgers[h][e] != card_ledgers[h][e]})
    twin_agree = len({tuple(v) for v in ledgers.values()}) == 1
    res = {"warm_s": warm_s, "run_s": run_s, "quiesce_s": quiet_s,
           "total_s": time.perf_counter() - t0,
           "depth": len(twin_p), "card_depth": len(card_p), "same_proposer_prefix": prefix,
           "prefix_bytes_equal": not differ, "epochs_differing": differ,
           "tx_set_equal": card_set == twin_set,
           "twin_agreement": twin_agree, "leftover_threads": leftover}
    for e in range(max(len(card_p), len(twin_p))):
        print(f"grpc_proposers epoch {e}: card="
              f"{','.join(p[-2:] for p in card_p[e]) if e < len(card_p) else '-'} "
              f"cpu={','.join(p[-2:] for p in twin_p[e]) if e < len(twin_p) else '-'}",
              flush=True)
    if differ or not (res["tx_set_equal"] and twin_agree) or leftover:
        raise AssertionError(f"the cpu twin of the gRPC run differs: {res}")
    return res


def grpc_phase(torch, b1_rate: float, n: int = GRPC_N, batch: int = GRPC_BATCH,
               txs: int = GRPC_TXS, warm_txs: int = GRPC_WARM_TXS, twin: bool = True,
               **overrides) -> dict:
    """The deployment its users run: ``n`` ValidatorHosts (``grpc_hosts``)
    over localhost gRPC on the port's defaults unless ``overrides`` say
    otherwise.  After a warm-up of ``warm_txs`` transactions, the launch
    counts are set to 0 and ``txs`` random 64-byte transactions
    (``default_rng(GRPC_TX_SEED)``) are committed on every host
    (``grpc_commit_all``).  Gates: every host commits the same batch
    bytes at every epoch, every transaction exactly once, none pending;
    every host's modexp engines are the card's and every dispatcher
    thread launches on the card's default stream; ``GRPC_SITES`` launch
    and nothing of ``OFF_PATH``; node 0's /metrics parses and its
    transport and hub counters equal its snapshot, /healthz and every
    peer UP (``scrape_gate``); the six kernels' median calls equal their
    plain versions (K9's too where it ran); no host thread outlives
    ``stop``; with ``twin``, the
    'cpu' twin (``grpc_twin``).  Prints the run's seconds and tx/s, node
    0's ordered and settled p50, the hubs' flushes and dispatches, the
    transport counters, launches, and the split of the run into the
    hubs' flush time (host Python, packing and device leg from the
    engines' stats) and the rest; then times the path's kernels at
    their median call (``async_kernel_records``).  Returns {"launches",
    "kernels", "run_s"}."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.ops.modmath import get_engine_degraded

    t0 = time.perf_counter()
    threads_before = host_threads()
    log_dir = tempfile.mkdtemp(prefix="grpc-logs-")
    hosts = grpc_hosts(n, batch, log_dir, **overrides)
    rec = None
    try:
        h0 = hosts[sorted(hosts)[0]]
        cfg = h0.config
        keys = h0.keys
        print(
            f"grpc_phase: {n} ValidatorHosts (Config(n={n}, batch_size={batch}, seed="
            f"{GRPC_CONFIG_SEED}, obs_port=0), key_seed={KEY_SEED}) backend="
            f"{cfg.crypto_backend} device={cfg.device} f={cfg.f} k={cfg.data_shards} "
            f"pipeline_depth={cfg.pipeline_depth} hubs={len({id(h.node.hub) for h in hosts.values()})} "
            f"streams_dialed={sum(len(h.pool) for h in hosts.values())} batch_logs=on "
            f"boot_s={time.perf_counter() - t0}",
            flush=True,
        )
        on_card = torch.device(cfg.device).type == "cuda" and cfg.crypto_backend == "cuda"
        groups = {keys.tpke_pub.group, keys.coin_pub.group}
        engines = {}
        for h in hosts.values():
            for gp in groups:
                eng = get_engine_degraded(h.node.hub.crypto.engine_backend, gp,
                                          h.node.hub.crypto.device)
                engines[id(eng)] = eng
        engines = list(engines.values())
        if on_card and any(eng.backend != "cuda" for eng in engines):
            raise AssertionError("a modexp engine of the gRPC path is not the card's")
        if on_card:
            dev = torch.device(cfg.device)
            index = torch.cuda.current_device() if dev.index is None else dev.index
            default = torch.cuda.default_stream(index).cuda_stream
            streams = {nid: h.dispatcher.call_sync(
                lambda: torch._C._cuda_getCurrentRawStream(index))
                for nid, h in hosts.items()}
            if set(streams.values()) != {default}:
                raise AssertionError(f"a dispatcher thread is not on the default stream: "
                                     f"{streams} (default {default})")
            print(f"grpc_streams: every dispatcher thread's current stream is the "
                  f"card's default stream ({default})", flush=True)
        rows = np.random.default_rng(GRPC_TX_SEED).integers(
            0, 256, (warm_txs + txs, TX_BYTES), dtype=np.uint8)
        all_txs = [r.tobytes() for r in rows]
        warm, measured = all_txs[:warm_txs], all_txs[warm_txs:]
        warm_s = grpc_commit_all(hosts, warm)
        warm_quiet_s = grpc_quiesce(hosts)
        print(f"grpc warm-up: {warm_txs} txs committed on every host in {warm_s} s, "
              f"the roster idle {warm_quiet_s} s later", flush=True)
        st0 = {nid: h.node.hub.stats() for nid, h in hosts.items()}
        eng0 = [dict(e.stats) for e in engines]
        rec = AsyncRecorder(engines)
        COUNTS.reset()
        run_s = grpc_commit_all(hosts, measured)
        if on_card:
            torch.cuda.synchronize()
        rec.close()
        launches = launch_counts()
        # the run's own readings, before the roster's trailing traffic
        st = {nid: {k_: v - st0[nid][k_] for k_, v in h.node.hub.stats().items()}
              for nid, h in hosts.items()}
        eng = {k_: sum(e.stats[k_] - o[k_] for e, o in zip(engines, eng0))
               for k_ in ("calls", "engine_s", "device_s")}
        m = h0.node.metrics
        ordered_p50, settled_p50 = m.ordered_latency.p50, m.epoch_latency.p50
        run_epochs = len(h0.committed_batches())
        quiet_s = grpc_quiesce(hosts)
        ledgers, batches = grpc_ledgers(hosts)
        # gates: agreement, exactly once, nothing pending, launches
        ref = ledgers[h0.node_id]
        split = [nid for nid, lg in ledgers.items() if lg != ref]
        if split:
            raise AssertionError(f"hosts {split} committed other batches than {h0.node_id}")
        committed = [tx for b in batches[h0.node_id] for tx in b.tx_list()]
        pending = sum(h.node.outstanding_tx_count() for h in hosts.values())
        if pending or len(committed) != len(all_txs) or set(committed) != set(all_txs):
            raise AssertionError(
                f"gRPC path committed {len(committed)} txs ({len(set(committed))} "
                f"distinct) of {len(all_txs)}, {pending} outstanding")
        for site in GRPC_SITES:
            if on_card and launches["sites"].get(site, 0) <= 0:
                raise AssertionError(f"gRPC path never launched {site}: {launches}")
        for site in OFF_PATH:
            if launches["sites"].get(site, 0):
                raise AssertionError(f"gRPC path launched {site}: {launches}")
        scrape = scrape_gate(h0)
        print(
            f"grpc_path: n={n} f={cfg.f} batch={batch} txs={len(measured)} (+{warm_txs} "
            f"warm-up) committed_once={len(committed)} epochs={run_epochs} "
            f"epochs_once_idle={len(batches[h0.node_id])} run_s={run_s} "
            f"tx_per_s={len(measured) / run_s} quiesce_s={quiet_s} "
            f"ordered_epoch_p50_s={ordered_p50} settled_epoch_p50_s={settled_p50}",
            flush=True,
        )
        flushes = sorted(s_["flushes"] for s_ in st.values())
        dispatches = sorted(s_["dispatches"] for s_ in st.values())
        print("grpc_hub_stats " + json.dumps({
            "flushes_sum": sum(flushes), "flushes_median_host": _p50(flushes),
            "dispatches_sum": sum(dispatches), "dispatches_median_host": _p50(dispatches),
            "by_kind_sum": {k_: sum(s_[k_] for s_ in st.values()) for k_ in (
                "branch_items", "decode_items", "share_items", "coin_issue_batches",
                "dec_issue_batches")},
            "wave_width_p50": {k_: _p50(v) for k_, v in rec.widths.items()},
            "waves": {k_: len(v) for k_, v in rec.widths.items()},
        }, sort_keys=True), flush=True)
        print("grpc_transport " + json.dumps(scrape, sort_keys=True), flush=True)
        flush_wall = _merged_us(rec.flush_spans)
        print(
            f"grpc_flush_split: run_s={run_s} flush_thread_s={rec.flush_s} "
            f"flush_wall_s={flush_wall} flushes_timed={len(rec.flush_spans)} "
            f"engine_s={eng['engine_s']} device_s={eng['device_s']} "
            f"packing_s={eng['engine_s'] - eng['device_s']} "
            f"flush_host_python_thread_s={rec.flush_s - eng['engine_s']} "
            f"engine_calls={eng['calls']} outside_flush_wall_s={run_s - flush_wall}",
            flush=True,
        )
        print("launches_grpc_path " + json.dumps(launches, sort_keys=True), flush=True)
    finally:
        if rec is not None:
            rec.close()
        leftover = stop_hosts(hosts)
        shutil.rmtree(log_dir, ignore_errors=True)
    if leftover:
        raise AssertionError(f"host threads outlived stop(): {leftover}")
    print(f"grpc_teardown: {n} hosts stopped, host threads before {len(threads_before)} "
          f"after {len(host_threads())}", flush=True)
    if twin:
        twin_res = grpc_twin(n, batch, warm, measured, ledgers, batches)
        print("grpc_twin " + json.dumps(twin_res, sort_keys=True), flush=True)
    sites = GRPC_SITES + (("pow_grouped",) if rec.calls["pow_fused_grouped"] else ())
    records = (async_kernel_records(torch, rec.calls, b1_rate, sites=sites, tag="grpc_n16")
               if on_card else {})
    bad = [name for name, r in records.items() if not r["equal"]]
    if bad:
        raise AssertionError(f"gRPC-shape kernels disagree with their plain versions: {bad}")
    return {"launches": launches, "kernels": records, "run_s": run_s}


def demo_phase(torch) -> dict:
    """The system's runnable entry point on its defaults (the card):
    ``cleisthenes_tpu_torch.demo.main`` with --dkg, 4 validators over
    localhost gRPC, with the launch counts set to 0 just before; it must
    return 0, and its DKG must have launched K7 (``pow``)."""
    from cleisthenes_tpu_torch import demo
    from cleisthenes_tpu_torch.csrc.build import COUNTS

    args = ["--n", "4", "--txs", "64", "--batch-size", "16", "--dkg"]
    COUNTS.reset()
    t0 = time.perf_counter()
    rc = demo.main(args)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"demo: main({args}) rc={rc} wall_s={time.perf_counter() - t0} "
          f"launches={json.dumps(launches['sites'], sort_keys=True)}", flush=True)
    if rc != 0 or launches["sites"].get("pow", 0) <= 0:
        raise AssertionError(f"the demo failed (rc={rc}) or launched no K7: {launches}")
    return launches


# The device mesh (parallel/mesh.py): the N=128 epoch's crypto plane cut
# into tiles, one launch a tile, on (2, 4) = eight handles of the one card
# and on the default (1, 1).  Under a mesh the codec skips the fused K3
# (delivery in three calls) and the engine the comb (grouped calls
# flattened to K7), as the reference routes them (rs_xla.py:177,
# modmath.py:930-933)
MESH_SHAPES = ((2, 4), (1, 1))
MESH_SITES = ("rs_encode", "rs_decode", "merkle_forest", "merkle_verify", "pow",
              "dual_pow")
MESH_ABSENT = ("decode_recheck", "pow_grouped")
MESH_EPOCHS = 2  # a warm-up and one measured epoch


def mesh_handles(dev, shape):
    """The mesh's devices: v*l handles of ``dev`` for a mesh wider than
    one device (one card carrying several), else the defaults (None)."""
    v, l = shape
    return [dev] * (v * l) if v * l > 1 else None


def mesh_op_record(torch, dev, name, want_launches, run, plain, equal):
    """One sharded call held to its unsharded twin on the same inputs:
    the sharded call alone between counts set to 0 and read after a
    synchronise, then the unsharded one; every site of the call must
    have launched ``want_launches`` times."""
    from cleisthenes_tpu_torch.csrc.build import COUNTS

    COUNTS.reset()
    t0 = time.perf_counter()
    got = run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()["sites"]
    t0 = time.perf_counter()
    ref = plain()
    plain_s = time.perf_counter() - t0
    rec = {"equal": bool(equal(got, ref)), "launches": launches, "call_s": secs,
           "unsharded_s": plain_s}
    wrong = {k_: v_ for k_, v_ in launches.items() if v_ != want_launches}
    if dev.type == "cuda" and (not launches or wrong):
        rec["equal"] = False
    print(f"mesh_op {name}: equal={rec['equal']} launches={json.dumps(launches, sort_keys=True)} "
          f"want_each={want_launches} call_s={secs} unsharded_s={plain_s}", flush=True)
    return rec


def mesh_ops_phase(torch, dev, rng, rnd, n: int = N, f: int = F, batch: int = BATCH) -> dict:
    """The sharded crypto plane at one roster's epoch shapes (N=128: B=128
    proposals, k=44, the 10k-tx payload's L; the N^2 branches with tampered
    ones; the decrypt-combine pow's 5,504 rows, the dual pow's 22,016 and
    the comb's 98,304 exponents over 257 bases) on each of ``MESH_SHAPES``,
    every call byte-equal to the unsharded call and making one launch a
    tile; then a (3, 2) mesh on six handles with a ragged batch of 5.
    Returns {"<op>@<v>x<l>": record}."""
    import numpy as np

    from cleisthenes_tpu_torch.ops import sha256_cuda as sh
    from cleisthenes_tpu_torch.ops.merkle import CudaMerkle
    from cleisthenes_tpu_torch.ops.modmath import P, ModEngine
    from cleisthenes_tpu_torch.ops.payload import split_payload
    from cleisthenes_tpu_torch.ops.rs_cuda import CudaErasureCoder
    from cleisthenes_tpu_torch.parallel.mesh import CryptoMesh

    k = n - 2 * f
    L = split_payload(bytes(payload_len(n, batch)), k).shape[1]
    data = rng.integers(0, 256, (n, k, L), dtype=np.uint8)
    plain_rs = CudaErasureCoder(n, k, device=dev)
    plain_mk = CudaMerkle(device=dev)
    plain_mx = ModEngine("cuda", device=dev)
    full = plain_rs.encode_batch(data)
    shared = np.tile(np.array(sorted(rng.choice(n, k, replace=False))), (n, 1))
    mixed = np.stack([np.sort(rng.choice(n, k, replace=False)) for _ in range(n)])
    sh_shared = np.stack([full[i, shared[i]] for i in range(n)])
    sh_mixed = np.stack([full[i, mixed[i]] for i in range(n)])
    forest = sh.build_forest(torch.from_numpy(full).to(dev)).cpu().numpy()
    br, idx = tree_branches(np, forest, n)
    leaves = full.reshape(n * n, L).copy()
    expect = tamper_per_warp(np, leaves, br, idx)
    roots = np.repeat(forest[:, -1], n, axis=0)
    pb, pe, _u2, _e2 = dual_inputs(rnd, P, 5504)
    u1, e1, u2, e2 = dual_inputs(rnd, P, 22016)
    cb, ce, crow = comb_inputs(rnd, P, *MODEXP_SHAPES["n128"][:3])
    groups = [(cb[r], []) for r in range(len(cb))]
    for r, e in zip(crow, ce):
        groups[r][1].append(e)

    def same_trees(a, b):
        return all(x.root == y.root and all(np.array_equal(p_, q_) for p_, q_ in
                                            zip(x.levels, y.levels)) for x, y in zip(a, b))

    out = {}
    for shape in MESH_SHAPES:
        mesh = CryptoMesh(shape, devices=mesh_handles(dev, shape), device=dev)
        tiles = mesh.n_devices
        tag = f"{shape[0]}x{shape[1]}"
        print(f"mesh_ops: mesh {shape} on {[str(d_) for d_ in mesh.flat_devices]}", flush=True)
        rs = CudaErasureCoder(n, k, device=dev, mesh=mesh)
        mk = CudaMerkle(device=dev, mesh=mesh)
        mx = ModEngine("cuda", device=dev, mesh=mesh)
        eq = np.array_equal
        cases = {
            "encode_batch": (lambda: rs.encode_batch(data), lambda: plain_rs.encode_batch(data), eq),
            "decode_batch_shared": (lambda: rs.decode_batch(shared, sh_shared),
                                    lambda: plain_rs.decode_batch(shared, sh_shared), eq),
            "decode_batch_mixed": (lambda: rs.decode_batch(mixed, sh_mixed),
                                   lambda: plain_rs.decode_batch(mixed, sh_mixed), eq),
            "build_batch": (lambda: mk.build_batch(full), lambda: plain_mk.build_batch(full),
                            same_trees),
            "verify_batch": (lambda: mk.verify_batch(roots, leaves, br, idx),
                             lambda: plain_mk.verify_batch(roots, leaves, br, idx),
                             lambda a, b: eq(a, b) and eq(a, expect) and not a.all()),
            "pow_batch": (lambda: mx.pow_batch(pb, pe), lambda: plain_mx.pow_batch(pb, pe),
                          lambda a, b: a == b),
            "dual_pow_batch": (lambda: mx.dual_pow_batch(u1, e1, u2, e2),
                               lambda: plain_mx.dual_pow_batch(u1, e1, u2, e2),
                               lambda a, b: a == b),
            "pow_batch_grouped": (lambda: mx.pow_batch_grouped(groups),
                                  lambda: plain_mx.pow_batch_grouped(groups),
                                  lambda a, b: a == b),
        }
        for name, (run, plain, equal) in cases.items():
            out[f"{name}@{tag}"] = mesh_op_record(torch, dev, f"{name}@{tag}", tiles, run, plain,
                                                  equal)
        if rs.decode_recheck_batch(shared, sh_shared) is not None:
            raise AssertionError("the fused decode-recheck ran under a mesh")
    # a mesh of six: a ragged batch of 5 pads to 6 (the reference's
    # TestNonPow2Mesh)
    mesh6 = CryptoMesh((3, 2), devices=[dev] * 6)
    mk6 = CudaMerkle(device=dev, mesh=mesh6)
    if mk6._bucket(5) != 6:
        raise AssertionError(f"(3, 2) mesh pads 5 rows to {mk6._bucket(5)}")
    rs6 = CudaErasureCoder(n, k, device=dev, mesh=mesh6)
    five = data[:5]
    out["encode_batch@3x2_B5"] = mesh_op_record(
        torch, dev, "encode_batch@3x2_B5", 6, lambda: rs6.encode_batch(five),
        lambda: plain_rs.encode_batch(five), np.array_equal)
    out["build_batch@3x2_B5"] = mesh_op_record(
        torch, dev, "build_batch@3x2_B5", 6, lambda: mk6.build_batch(full[:5]),
        lambda: plain_mk.build_batch(full[:5]), same_trees)
    return out


def ledger_bodies(batches) -> list:
    """The committed batches' ledger-body bytes, one an epoch."""
    from cleisthenes_tpu_torch.core.ledger import encode_batch_body

    return [encode_batch_body(e, b) for e, b in enumerate(batches)]


def mesh_path(torch, dev, shape, ref_bodies, n: int = N, batch: int = BATCH,
              epochs: int = MESH_EPOCHS, **overrides) -> dict:
    """The n128-lockstep path with ``Config(mesh_shape=shape)`` on the
    port's defaults (a CPU rehearsal passes device='cpu'), on eight
    handles of ``dev`` for (2, 4): a warm-up epoch, then one measured
    epoch between launch counts set to 0 and read.  Gates: the committed
    batches' ledger bytes equal ``ref_bodies`` (n128-lockstep's own first
    epochs, the same txs and key seed), ``MESH_SITES`` launch, a whole
    number of launches a tile, and nothing of ``MESH_ABSENT`` or
    ``OFF_PATH``.  Returns the measured epoch's stats and launches."""
    import numpy as np

    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster

    t0 = time.perf_counter()
    cfg = Config(n=n, batch_size=batch, mesh_shape=shape, **overrides)
    cluster = LockstepCluster(config=cfg, key_seed=KEY_SEED,
                              mesh_devices=mesh_handles(dev, shape))
    mesh = cluster.crypto.mesh
    tag = f"{shape[0]}x{shape[1]}"
    print(f"mesh_path {tag}: LockstepCluster(config=Config(n={n}, batch_size={batch}, "
          f"mesh_shape={shape}), key_seed={KEY_SEED}) backend={cfg.crypto_backend} "
          f"device={cfg.device} mesh_devices={[str(d_) for d_ in mesh.flat_devices]} "
          f"setup_s={time.perf_counter() - t0}", flush=True)
    total = (batch // n) * n * epochs
    txs = np.random.default_rng(13).integers(0, 256, (total, TX_BYTES), dtype=np.uint8)
    for row in txs:
        cluster.submit(row.tobytes())
    on_card = dev.type == "cuda"
    keys = ("propose_s", "rbc_encode_s", "rbc_verify_s", "rbc_decode_s", "bba_s",
            "decrypt_s", "commit_s", "epoch_s", "bba_rounds")
    stats = {}
    for e in range(epochs):
        if e == epochs - 1:
            if on_card:
                torch.cuda.synchronize()
            COUNTS.reset()
        stats = cluster.run_epoch()
        print(f"mesh_path {tag} epoch {e}: " + " ".join(f"{k_}={stats[k_]}" for k_ in keys),
              flush=True)
    if on_card:
        torch.cuda.synchronize()
    launches = launch_counts()
    bodies = ledger_bodies(cluster.committed_batches)
    if cluster.pending_tx_count() or bodies != ref_bodies[:epochs]:
        raise AssertionError(f"mesh {shape}: committed batches differ from n128-lockstep's "
                             f"({len(bodies)} epochs, {cluster.pending_tx_count()} pending)")
    for site in MESH_SITES:
        got = launches["sites"].get(site, 0)
        if on_card and (got <= 0 or got % mesh.n_devices):
            raise AssertionError(f"mesh {shape}: {site} launched {got} times: {launches}")
    for site in (*MESH_ABSENT, *OFF_PATH):
        if launches["sites"].get(site, 0):
            raise AssertionError(f"mesh {shape}: launched {site}: {launches}")
    print(f"mesh_path {tag}: committed_equal_to_n128=True epochs={epochs} "
          f"measured_epoch_s={stats['epoch_s']} launches " + json.dumps(launches, sort_keys=True),
          flush=True)
    return {"stats": stats, "launches": launches}


def dryrun_phase(torch, dev, **roster) -> dict:
    """``flagship.dryrun_multichip`` on eight handles of ``dev`` and on
    one device (its default for one card): its own shape asserts, and
    its roots and shards equal the unsharded flagship step at its
    length.  ``roster`` (n, f, batch) shrinks it for a rehearsal."""
    import numpy as np

    from cleisthenes_tpu_torch import flagship
    from cleisthenes_tpu_torch.csrc.build import COUNTS

    out = {}
    for n_dev, devices in ((8, [dev] * 8), (1, None if dev.type == "cuda" else [dev])):
        COUNTS.reset()
        t0 = time.perf_counter()
        res = flagship.dryrun_multichip(n_dev, devices=devices, **roster)
        secs = time.perf_counter() - t0
        launches = launch_counts()
        n = res["encoded"].shape[0]
        f = roster.get("f", flagship.DRYRUN_F)
        step, (data,) = flagship.flagship(n, f, res["encoded"].shape[-1], device=dev)
        roots, encoded = step(data)
        ok = (np.array_equal(res["roots"], roots.cpu().numpy())
              and np.array_equal(res["encoded"], encoded.cpu().numpy()))
        print(f"dryrun {n_dev}: mesh={res['mesh']} in_tile={res['in_tile_shape']} "
              f"out_block={res['out_block_shape']} checksum={res['checksum']} "
              f"equal_to_unsharded={ok} s={secs} launches={json.dumps(launches, sort_keys=True)}",
              flush=True)
        if not ok:
            raise AssertionError(f"dry run on {n_dev} devices differs from the unsharded step")
        out[n_dev] = {"s": secs, "launches": launches}
    return out


def mesh_phase(torch, dev, rng, rnd, ref_bodies, **overrides) -> dict:
    """The mesh at the ops level, the n128 path on each mesh, the dry run."""
    t0 = time.perf_counter()
    ops = mesh_ops_phase(torch, dev, rng, rnd)
    bad = [name for name, rec in ops.items() if not rec["equal"]]
    if bad:
        raise AssertionError(f"sharded calls differ from unsharded or launch wrongly: {bad}")
    print(f"mesh_ops done in {time.perf_counter() - t0} s", flush=True)
    paths = {shape: mesh_path(torch, dev, shape, ref_bodies, **overrides)
             for shape in MESH_SHAPES}
    dry = dryrun_phase(torch, dev)
    print(f"mesh_phase done in {time.perf_counter() - t0} s", flush=True)
    return {"ops": ops, "paths": paths, "dryrun": dry}


# The fuzz driver (tools/fuzz.py) on the card's defaults: seeds from 0 of
# ci.sh's 0:20 smoke band for as long as FUZZ_BUDGET_S allows, each held
# to its "cpu" run; the planted violation caught; loadgen --smoke's gates
FUZZ_SEEDS, FUZZ_BUDGET_S = 20, 60.0


def planted_schedule() -> dict:
    """tests/test_fuzz.py's planted violation: a tx injector buried
    under components the shrinker strips."""
    return {
        "version": 1, "seed": 3, "n": 4, "f": 1, "batch_size": 8, "key_seed": 33,
        "rounds": 4, "txs": 4, "bad": ["node003"],
        "behaviors": [{"kind": "split_voter", "node": "node003", "seed": 1},
                      {"kind": "tx_injector", "node": "node003", "seed": 9}],
        "wire": [{"stage": "drop", "args": {"fraction": 0.1}}],
        "timeline": [{"round": 1, "op": "partition", "node": "node003", "peer": "node000"},
                     {"round": 2, "op": "heal", "node": "node003", "peer": "node000"}],
        "check_liveness": True,
    }


def fuzz_phase(torch, budget_s: float = FUZZ_BUDGET_S, **crypto) -> dict:
    """The fuzz driver and the load generator on the port's defaults
    (``crypto`` = crypto/device for a CPU rehearsal).  Gates: every seed
    run holds every invariant and commits the same ledgers as the same
    schedule on ``crypto='cpu'``; the planted schedule is caught as
    no_foreign_tx; ``loadgen`` at its smoke size passes its own audits
    (zero lost acks, frontiers met, agreement, equal settled content at
    depths 1 and 4).  Launch counts cover the card's runs."""
    from cleisthenes_tpu_torch.csrc.build import COUNTS
    from cleisthenes_tpu_torch.tools import fuzz, loadgen

    COUNTS.reset()
    t0 = time.perf_counter()
    ran = []
    for seed in range(FUZZ_SEEDS):
        if time.perf_counter() - t0 >= budget_s:
            break
        schedule = fuzz.sample_schedule(seed)
        card, host = {}, {}
        ts = time.perf_counter()
        v = fuzz.run_schedule(schedule, ledgers=card, **crypto)
        secs = time.perf_counter() - ts
        v_host = fuzz.run_schedule(schedule, crypto="cpu", ledgers=host)
        print(f"fuzz seed {seed}: verdict={v} cpu_verdict={v_host} s={secs} "
              f"epochs={max(len(x) for x in card.values())} ledgers_equal={card == host}",
              flush=True)
        if v is not None or v_host is not None or card != host or not all(card.values()):
            raise AssertionError(f"fuzz seed {seed}: {v} / {v_host}, ledgers equal {card == host}")
        ran.append(seed)
    band_s = time.perf_counter() - t0
    planted = fuzz.run_schedule(planted_schedule(), **crypto)
    print(f"fuzz planted: {planted}", flush=True)
    if planted is None or planted["invariant"] != "no_foreign_tx":
        raise AssertionError(f"the planted violation was not caught: {planted}")
    ts = time.perf_counter()
    load = loadgen.run(
        clients=loadgen.SMOKE_CLIENTS, txs=loadgen.SMOKE_TXS, depths=loadgen.DEFAULT_DEPTHS,
        batch=loadgen.SMOKE_BATCH, ticks=loadgen.SMOKE_TICKS, **crypto,
    )
    load_s = time.perf_counter() - ts
    launches = launch_counts()
    on_card = crypto.get("crypto", "cuda") == "cuda" and crypto.get("device", "cuda") != "cpu"
    for site in ("rs_encode", "merkle_forest", "merkle_verify", "dual_pow"):
        if on_card and launches["sites"].get(site, 0) <= 0:
            raise AssertionError(f"the fuzz phase never launched {site}: {launches}")
    print(f"fuzz_phase: seeds_ran={len(ran)} (0..{ran[-1] if ran else None}) band_s={band_s} "
          f"loadgen_s={load_s} loadgen_arms=" + json.dumps(
              [{k_: a[k_] for k_ in ("depth", "settled", "txs", "evicted", "epochs", "wall_s",
                                     "submit_to_ordered_ms", "submit_to_settled_ms")}
               for a in load["arms"]]) + f" ledger={load['ledger_digest'][:16]} "
          f"total_s={time.perf_counter() - t0} launches=" + json.dumps(launches, sort_keys=True),
          flush=True)
    return {"seeds": ran, "launches": launches}


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
    build.load_all()
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
    phases = {}
    for where, run in (
        ("n128", lambda: kernel_phase(torch, N, F, BATCH, dev, True, rng, b1_rate)),
        ("n100", lambda: kernel_phase(torch, 100, 33, BATCH, dev, False, rng, b1_rate)),
        ("modexp", lambda: modexp_phase(torch, P_DEFAULT, dev, True, rnd)),
        ("modexp_p2", lambda: modexp_phase(torch, P2, dev, False, rnd)),
        ("n512", lambda: kernel_phase(torch, 512, 170, 4096, dev, True, rng, b1_rate)),
        ("n300", lambda: kernel_phase(torch, 300, 99, 4096, dev, False, rng, b1_rate)),
        ("edges", lambda: edge_phase(torch, dev, rng)),
        ("wide", lambda: wide_phase(torch, dev, rnd)),
        ("rows", lambda: rows_phase(torch, dev, rng, P_DEFAULT)),
    ):
        t_phase = time.perf_counter()
        phases[where] = run()
        print(f"kernel phase {where} took {time.perf_counter() - t_phase} s", flush=True)
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
    n128_bodies = ledger_bodies(cluster.committed_batches)
    dec_launches = decrypt_combine_phase(torch, cluster, dev)
    del cluster
    launches_512, _ = main_path(
        torch, 512, 4096, N512_EPOCHS, WAVES_512,
        sites=("rs16_encode", "rs16_decode", "merkle_forest", "merkle_verify",
               "pow_grouped", "dual_pow"),
    )
    launches_384, _ = main_path(
        torch, N, BATCH, EPOCHS, WAVES_384, group=GROUP384,
        sites=("rs_encode", "merkle_forest", "merkle_verify", "decode_recheck",
               "wide_pow", "wide_dual_pow"),
        absent=("pow_grouped", "dual_pow", "pow"),
    )

    def done(what):
        print(f"{what} done at {time.perf_counter() - t_start} s", flush=True)

    done("lockstep paths")
    mesh_res = mesh_phase(torch, dev, rng, rnd, n128_bodies)
    fuzz_res = fuzz_phase(torch)
    done("mesh and fuzz phases")
    async_res = async_phase(torch, b1_rate)
    done("async_phase")
    byz_res = byzantine_phase(torch, b1_rate)
    done("byzantine_phase")
    grpc_res = grpc_phase(torch, b1_rate)
    demo_launches = demo_phase(torch)
    done("grpc and demo phases")
    dkg_launches = dkg_run_phase(torch, dev)
    dkg_steps = dkg_roster_phase(torch, dev)
    share_launches = share_phase(torch, dev)
    done("DKG and share phases")
    # last, so that its epoch shifts nothing the timed paths share (the
    # combine memo's fill, the profiler's host objects)
    profile_phase(torch, 512, 4096)
    counts = dict(launches["sites"])
    pow_by_path = {
        "decrypt_combine": dec_launches["sites"].get("pow", 0),
        "dkg_run_n32": dkg_launches["g256"]["sites"].get("pow", 0),
        "dkg_n128_steps": sum(r["pow_launches"] for r in dkg_steps.values()),
        "demo_dkg": demo_launches["sites"].get("pow", 0),
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
        kernels[-1]["launches_async_n64_per_epoch"] = [
            kick["sites"].get(name, kick["kernels"].get(name, 0))
            for kick in async_res["launches"]]
        kernels[-1]["launches_mesh_n128"] = {
            f"{sh_[0]}x{sh_[1]}": mesh_res["paths"][sh_]["launches"]["sites"].get(
                name, mesh_res["paths"][sh_]["launches"]["kernels"].get(name, 0))
            for sh_ in MESH_SHAPES}
        kernels[-1]["launches_fuzz"] = fuzz_res["launches"]["sites"].get(
            name, fuzz_res["launches"]["kernels"].get(name, 0))
        kernels[-1]["launches_async_n64_byz"] = byz_res["launches"]["sites"].get(
            name, byz_res["launches"]["kernels"].get(name, 0))
        kernels[-1]["rejects_async_n64_byz"] = {
            "merkle_verify": byz_res["rejects"]["k6_false"],
            "dual_pow": byz_res["rejects"]["cp_false"]}.get(name)
        kernels[-1]["launches_grpc_n16"] = grpc_res["launches"]["sites"].get(
            name, grpc_res["launches"]["kernels"].get(name, 0))
        if name in grpc_res["kernels"]:
            g_ = grpc_res["kernels"][name]
            kernels[-1]["grpc_n16"] = {k_: g_[k_] for k_ in (
                "shape", "calls", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                "bound_by")}
        if name in byz_res["kernels"]:
            b_ = byz_res["kernels"][name]
            kernels[-1]["async_n64_byz"] = {k_: b_[k_] for k_ in (
                "shape", "calls", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                "bound_by")}
        if name in async_res["kernels"]:
            a_ = async_res["kernels"][name]
            kernels[-1]["async_n64"] = {k_: a_[k_] for k_ in (
                "shape", "calls", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                "bound_by")}
        if name in OFF_PATH:
            kernels[-1]["kernel_phase_launches"] = rec["launches_per_call"]
            kernels[-1]["off_path"] = OFF_PATH[name]
            kernels[-1]["shapes"] = {
                tag.split("@")[1]: {k_: v_ for k_, v_ in r_.items() if k_ != "equal"}
                for tag, r_ in phases["rows"].items() if tag.startswith(name + "@")}
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
