"""The frozen roofline of the benchmark: peaks, SASS counts and the
least work a kernel's inputs need.

A copy, held apart from the program so that no later change to it moves
the yardstick.  Peaks are one H100 SXM's at its 700 W limit: HBM at
3.35 TB/s (NVIDIA's data sheet); 32-bit integer work, which the data
sheet does not list, at 64 INT32 lanes an SM a clock (half its 128 FP32
lanes), the FMA pipe's integer multiplies at the same rate, and one warp
instruction a sub-partition a clock issued whatever the pipe, over 132
SMs at 1.98 GHz.

Instruction counts were read from the SASS of the kernels as sm_90a
compiles them: a SHA-256 compression of words that do not fold takes
1,265 INT32-pipe and 1,383 issued instructions, the two compressions of
a 65-byte Merkle node 2,421 and 2,675; a 256-bit Montgomery product of
K8's team plan 212 on the INT32 pipe, 202 on the FMA pipe and 431
issued.  A modular exponentiation is bounded by the fewest Montgomery
products any fixed-window method needs for its exponents (``least_dual``
for u1^e1 u2^e2), each input byte read once and each output byte written
once.

K12 (csrc/modexp_wide.cu) takes the repository's bound of a wide product,
``WIDE_BOUND_OPS`` of cleisthenes_tpu_torch/csrc/sass_ops.py: the fewer
of the 32-bit ALU instructions that the first design's one-thread CIOS
product (1,013 / 4,068 / 26,987 at 12 / 25 / 66 words) and the shipped
plans' team product (950 / 11,680 / 65,536, all lanes of the team) were
read to need in their SASS, 950 / 4,068 / 26,987.  The one-thread
product's instructions were never split by pipe, so every wide count is
held at the issue rate, which no split over the INT32 and FMA pipes
(each at half that rate) can beat.  A row's products are ``least_pow``
or ``least_dual`` of its exponents at the family's width; each row reads
its bases and exponents and writes one value, all of the family's
width; its bases arrive reduced, so none folds.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_OPS_PER_S = 132 * 4 * 32 * 1.98e9
FMA_INT_OPS_PER_S = 132 * 64 * 1.98e9

SHA_BLOCK_OPS = (1265, 1383)  # (INT32 pipe, issued) a compression
SHA_NODE_OPS = (2421, 2675)  # (INT32 pipe, issued) a 65-byte Merkle node
MONT_PIPE_OPS = (212, 202, 431)  # (INT32 pipe, FMA pipe, issued) a product
# K12: a wide family's row bytes -> its 32-bit words, and the issued ALU
# instructions of one Montgomery product by words (sass_ops.WIDE_BOUND_OPS)
WIDE_WORDS = {48: 12, 99: 25, 264: 66}
WIDE_BOUND_OPS = {12: 950, 25: 4068, 66: 26987}


def blocks(msg_len: int) -> int:
    """SHA-256 compressions of one message of ``msg_len`` bytes."""
    return (msg_len + 9 + 63) // 64


def bound(nbytes: int, ops: int, issued: int = 0, fma: int = 0):
    """(bound_ms, bound_by): bytes at the HBM rate against ``ops`` on the
    INT32 lanes, ``fma`` integer multiplies on the FMA pipe and ``issued``
    instructions at the issue rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / INT32_OPS_PER_S, fma / FMA_INT_OPS_PER_S, issued / ISSUE_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sha_ops(n_blocks: int, n_nodes: int):
    """(INT32-pipe, issued) instructions of ``n_blocks`` compressions and
    ``n_nodes`` Merkle node hashes."""
    return tuple(n_blocks * b + n_nodes * nd for b, nd in zip(SHA_BLOCK_OPS, SHA_NODE_OPS))


def mont_bound(nbytes: int, products: int):
    """(bound_ms, bound_by) of ``products`` 256-bit Montgomery products on
    ``nbytes`` of input and output."""
    i32, fma, issued = (products * c for c in MONT_PIPE_OPS)
    return bound(nbytes, i32, issued, fma)


def merkle_verify_bound(branches: int, leaf_len: int, depth: int):
    """K6 ``merkle_verify`` on ``branches`` proofs of ``leaf_len``-byte
    leaves and ``depth`` siblings: each reads its root, leaf, siblings and
    8-byte index and writes a verdict byte; hashes its prefixed leaf and
    ``depth`` nodes."""
    nbytes = branches * (32 + leaf_len + depth * 32 + 8 + 1)
    return bound(nbytes, *sha_ops(branches * blocks(leaf_len + 1), branches * depth))


def _nonzero_digits(exps, w: int, bits=None):
    """(B, nb) big-endian exponent bytes (or their unpacked ``bits``) ->
    (B, ceil(8 nb / w)) bool: each base-2^w digit, most significant first,
    is nonzero."""
    if bits is None:
        bits = np.unpackbits(exps, axis=1)
    bits = np.pad(bits, ((0, 0), ((-bits.shape[1]) % w, 0)))
    d = bits.reshape(bits.shape[0], -1, w)
    nz = d[:, :, 0] != 0
    for j in range(1, w):
        nz |= d[:, :, j] != 0
    return nz


def _tail(nz):
    """Per row: digit positions from the first nonzero one to the end."""
    return np.where(nz.any(1), nz.shape[1] - nz.argmax(1), 0)


def least_pow(exps):
    """Per row, the fewest Montgomery products of b^e by a fixed w-bit
    window, w = 1..7: into the domain, the table b^2..b^(2^w - 1), w
    squarings a digit after the top one, a multiply a further nonzero
    digit, out of the domain; none for e = 0."""
    def window(w):
        nz = _nonzero_digits(exps, w)
        nd = _tail(nz)
        return np.where(nd > 0, 2 + (2**w - 2) + w * (nd - 1) + nz.sum(1) - 1, 0)

    return np.minimum.reduce([window(w) for w in range(1, 8)])


def least_dual(e1, e2):
    """Per row, the fewest Montgomery products of u1^e1 u2^e2 over one
    shared chain of squarings: a joint table of every u1^i u2^j (w = 1..3)
    and a multiply where either digit is nonzero, or a table a base
    (w = 1..7) and a multiply a nonzero digit of each; both bases into the
    domain, the result out.  A row whose other exponent is 0 is one pow."""
    def window(w, joint):
        n1, n2 = _nonzero_digits(e1, w), _nonzero_digits(e2, w)
        nd = _tail(n1 | n2)
        if joint:
            table, mults = 2 * (2**w - 2) + (2**w - 1) ** 2, (n1 | n2).sum(1)
        else:
            table, mults = 2 * (2**w - 2), n1.sum(1) + n2.sum(1)
        return np.where(nd > 0, 3 + table + w * (nd - 1) + mults - 1, 0)

    big = np.iinfo(np.int64).max
    return np.minimum.reduce(
        [window(w, True) for w in range(1, 4)]
        + [window(w, False) for w in range(1, 8)]
        + [np.where(e2.any(1), big, least_pow(e1)),
           np.where(e1.any(1), big, least_pow(e2))]
    )


def exp_bit_lengths(exps):
    """(B,) bit lengths of (B, 32) big-endian exponent rows."""
    m = exps.shape[0]
    nz = exps != 0
    first = np.where(nz.any(1), nz.argmax(1), 32)
    top = exps[np.arange(m), np.minimum(first, 31)].astype(np.int64)
    return np.where(first < 32, 8 * (31 - first) + np.floor(np.log2(np.maximum(top, 1))).astype(np.int64) + 1, 0)


def least_comb(bases, exps, rows) -> int:
    """K9's least products for (n, 33) bases, (B, 32) exponents and the
    (B,) base row of each: a fixed-base comb of width w = 2..8 chosen a
    base; a base's chain of w (r - 1) squarings and its table's r (2^w - 2)
    products, r = ceil(b / w) for its widest exponent of b bits, and into
    the domain (one more where a 33rd byte folds); an exponent's multiply
    a nonzero digit after the first, and one out of the domain."""
    n_b, m = bases.shape[0], exps.shape[0]
    ebits = exp_bit_lengths(exps)
    bbits = np.zeros(n_b, np.int64)
    np.maximum.at(bbits, rows, ebits)
    into = 1 + (bases[:, 32] != 0)
    widths = range(2, 9)
    per_exp = {w: np.zeros(m, np.int64) for w in widths}
    for lo in range(0, m, 1 << 17):  # bounded memory
        bits = np.unpackbits(exps[lo : lo + (1 << 17)], axis=1)
        for w in widths:
            nz = _nonzero_digits(None, w, bits).sum(1)
            per_exp[w][lo : lo + len(nz)] = np.maximum(nz - 1, 0) + 1
    best = None
    for w in widths:
        r = np.maximum(-(-bbits // w), 1)
        cost = into + w * (r - 1) + r * (2**w - 2) + np.bincount(rows, per_exp[w], n_b)
        best = cost if best is None else np.minimum(best, cost)
    return int(best.sum())


def dual_products(u1, e1, u2, e2) -> int:
    """K8's least products for (B, 33) little-endian bases and (B, 32)
    big-endian exponents: ``least_dual``, plus one a base whose 33rd byte
    folds into the domain."""
    n = least_dual(e1, e2)
    fold = (u1[:, 32] != 0).astype(np.int64) + (u2[:, 32] != 0)
    return int((n + np.where(n > 0, fold, 0)).sum())


def dual_pow_bound(u1, e1, u2, e2):
    """K8 ``dual_pow_fused`` on Python-integer rows: (bound_ms, bound_by,
    products).  Each row reads two 33-byte bases and two 32-byte exponents
    and writes a 33-byte value."""
    b33 = lambda xs: np.frombuffer(b"".join(x.to_bytes(33, "little") for x in xs), np.uint8).reshape(-1, 33)  # noqa: E731
    b32 = lambda xs: np.frombuffer(b"".join(x.to_bytes(32, "big") for x in xs), np.uint8).reshape(-1, 32)  # noqa: E731
    products = 0
    for lo in range(0, len(u1), 1 << 15):  # bounded memory
        sl = slice(lo, lo + (1 << 15))
        products += dual_products(b33(u1[sl]), b32(e1[sl]), b33(u2[sl]), b32(e2[sl]))
    ms, by = mont_bound(len(u1) * (3 * 33 + 2 * 32), products)
    return ms, by, products


def _be_rows(xs, nb: int):
    """(B,) Python ints -> (B, nb) big-endian bytes."""
    return np.frombuffer(b"".join(x.to_bytes(nb, "big") for x in xs), np.uint8).reshape(-1, nb)


def _wide_bound(nbytes: int, products: int, vb: int):
    return bound(nbytes, 0, products * WIDE_BOUND_OPS[WIDE_WORDS[vb]])


def wide_pow_bound(bases, exps, vb: int):
    """K12 ``wide_pow_kernel`` of the ``vb``-byte family on Python-integer
    rows: (bound_ms, bound_by, products)."""
    products = 0
    for lo in range(0, len(exps), 1 << 13):  # bounded memory
        products += int(least_pow(_be_rows(exps[lo : lo + (1 << 13)], vb)).sum())
    return (*_wide_bound(len(bases) * 3 * vb, products, vb), products)


def wide_dual_pow_bound(u1, e1, u2, e2, vb: int):
    """K12 ``wide_dual_pow_kernel`` of the ``vb``-byte family on
    Python-integer rows: (bound_ms, bound_by, products)."""
    products = 0
    for lo in range(0, len(u1), 1 << 13):  # bounded memory
        sl = slice(lo, lo + (1 << 13))
        products += int(least_dual(_be_rows(e1[sl], vb), _be_rows(e2[sl], vb)).sum())
    return (*_wide_bound(len(u1) * 5 * vb, products, vb), products)
