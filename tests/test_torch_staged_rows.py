"""K4 (``csrc/sha256.cu`` ``sha256_rows``) and K10 (``csrc/modexp.cu``
``mont_mul``) as the card runs them, modelled in numpy and Python
integers and held to the JAX package on the CPU, to ``hashlib`` and to
Python's ``pow``.  Tolerance zero: every value is exact.

K4's model copies what a block does with its rows: for each chunk of
``kChunkBlocks`` compressions, the 16-byte granules that hold a row's
bytes of the chunk go into the row's slot behind its 16-byte lead at the
row address's offset mod 16 (bytes outside the tensor and stale bytes of
the last chunk stay in the slot), and ``staged_block`` builds each
message block's 16 big-endian words from five 16-byte reads, two selects
and a byte permute, then masks, inserts the prefix and pads.  Its words
must equal the reference's padded blocks (``sha256_xla._pad_to_blocks``)
and its digests ``sha256_batch``'s and ``hashlib``'s, at every row length
mod 64, across a chunk boundary and at L = 1,001, with no prefix and with
prefixes 0 and 1, from aligned and unaligned tensors.

K10's model copies a warp: 32 rows of 33 bytes cut into 16-byte granules
(then bytes), each lane's eight words and 33rd byte funnel-shifted from
nine aligned words, the warp's choice between one product and reducing
both values first, the one-lane CIOS product with its 257-bit final
subtract, and the result written back as aligned words joined across
rows by a shuffle.  It must equal ``x y 2^-256 mod p`` and the reference's
``mont_mul_batch`` (radix 2^264) on integer semantics, values in
[p, 2^264) included.  The block sizes the C entry points pick
(``spread_threads``, ``mul_threads``) are modelled from the constants the
sources declare."""

import hashlib
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleisthenes_tpu.ops import modmath as ref
from cleisthenes_tpu.ops import sha256_xla
from cleisthenes_tpu_torch.csrc import build
from cleisthenes_tpu_torch.ops import modexp_cuda as mx
from cleisthenes_tpu_torch.ops import modmath as mm

SHA_SRC = (build._CSRC / "sha256.cu").read_text()
MODEXP_SRC = (build._CSRC / "modexp.cu").read_text()
M32 = 0xFFFFFFFF
H100_SMS = 132


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


CHUNK_BLOCKS = _const(SHA_SRC, "kChunkBlocks")
SLOT_WORDS = _const(SHA_SRC, "kSlotWords")
ROWS_MOST = _const(SHA_SRC, "kRowsMostThreads")
MUL_MOST = _const(MODEXP_SRC, "kMulThreads")
VAL_BYTES = _const(MODEXP_SRC, "kValBytes")


# ---------------------------------------------------------------------------
# K4: staging and word-wise message assembly
# ---------------------------------------------------------------------------


def byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's ``__byte_perm``: byte n of the result is byte ``sel``'s
    nibble n of the eight bytes y:x (x's bytes 0-3)."""
    v = (y << 32) | x
    return sum(((v >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF) << (8 * n) for n in range(4))


def staged_block(slot: bytes, e: int, qb: int, nq: int, blk: int, total: int,
                 prefix: int, mask: bool) -> list:
    """The kernel's ``staged_block``: message block ``blk`` as 16 words."""
    q0 = (e >> 4) + 4 * qb
    s = []
    for k in range(5):
        quad = slot[16 * (q0 + k):16 * (q0 + k) + 16] if q0 + k < nq else bytes(16)
        s += [int.from_bytes(quad[4 * i:4 * i + 4], "little") for i in range(4)]
    d = (e >> 2) & 3
    s = s[d:d + 17]  # the two selects
    sel = 0x0123 + 0x1111 * (e & 3)
    w = [byte_perm(s[i], s[i + 1], sel) for i in range(16)]
    pos = 64 * blk
    tp = total - pos
    if mask and tp < 64:
        for i in range(16):
            v = tp - 4 * i
            if v <= 0:
                w[i] = 0
            elif v < 4:
                w[i] &= (M32 << (8 * (4 - v))) & M32
    if pos == 0 and prefix >= 0:
        w[0] = (w[0] & 0x00FFFFFF) | (prefix << 24)
    if 0 <= tp < 64:
        w[tp >> 2] |= 0x80 << (24 - 8 * (tp & 3))
    if tp <= 64 - 9:
        bitlen = total * 8
        w[14], w[15] = (bitlen >> 32) & M32, bitlen & M32
    return w


def sha256_rows_model(mem: np.ndarray, base: int, rows: int, L: int, prefix: int) -> list:
    """Every row's message blocks as ``sha256_rows_kernel`` builds them
    from the tensor at byte ``base`` of ``mem`` (row i at base + i L, the
    granules read at addresses aligned to 16 within ``mem``)."""
    pre = 1 if prefix >= 0 else 0
    total = L + pre
    nblocks = (total + 9 + 63) // 64
    slots = [bytearray(b"\xc3" * 4 * SLOT_WORDS) for _ in range(rows)]  # stale bytes
    blocks = [[] for _ in range(rows)]
    for b0 in range(0, nblocks, CHUNK_BLOCKS):
        k0 = max(0, 64 * b0 - pre)
        k1 = min(L, 64 * (b0 + CHUNK_BLOCKS) - pre)
        length = max(0, k1 - k0)
        for r in range(rows):
            a = base + r * L + k0
            off = a & 15
            if length:
                for g in range((off + length + 15) >> 4):
                    src = (a & ~15) + 16 * g
                    slots[r][16 + 16 * g:32 + 16 * g] = mem[src:src + 16].tobytes()
            e = 16 + off - (pre if b0 == 0 else 0)
            for qb in range(CHUNK_BLOCKS):
                if b0 + qb < nblocks:
                    blocks[r].append(staged_block(bytes(slots[r]), e, qb, SLOT_WORDS // 4,
                                                  b0 + qb, total, prefix, True))
    return blocks


_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & M32


def digest_of_blocks(blocks: list) -> bytes:
    """SHA-256 of a message given as its padded blocks of 16 words."""
    st = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
          0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
    for blk in blocks:
        w = list(blk)
        for t in range(16, 64):
            s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
            s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
        a, b, c, d, e, f, g, h = st
        for t in range(64):
            t1 = (h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + ((e & f) ^ (~e & g))
                  + _K[t] + w[t]) & M32
            s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            t2 = (s0 + ((a & b) ^ (a & c) ^ (b & c))) & M32
            a, b, c, d, e, f, g, h = (t1 + t2) & M32, a, b, c, (d + t1) & M32, e, f, g
        st = [(x + y) & M32 for x, y in zip(st, (a, b, c, d, e, f, g, h))]
    return b"".join(x.to_bytes(4, "big") for x in st)


PREFIXES = (-1, 0x00, 0x01)


def _check_rows(L: int, rows: int, bases: tuple, seed: int) -> None:
    """Seeded rows at each byte offset ``bases`` of random memory (bytes
    before and after the tensor are not the rows'), every prefix."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (rows, L), dtype=np.uint8)
    mems = []
    for base in bases:
        mem = rng.integers(0, 256, base + rows * L + 64, dtype=np.uint8)
        mem[base:base + rows * L] = data.reshape(-1)
        mems.append((mem, base))
    for prefix in PREFIXES:
        msgs = data if prefix < 0 else np.concatenate(
            [np.full((rows, 1), prefix, np.uint8), data], 1)
        want_words = np.asarray(sha256_xla._pad_to_blocks(jnp.asarray(msgs)))
        want_dig = np.asarray(sha256_xla.sha256_batch(jnp.asarray(msgs)))
        for k, (mem, base) in enumerate(mems):
            model = sha256_rows_model(mem, base, rows, L, prefix)
            for r in range(rows):
                got = np.asarray(model[r], np.uint32)
                assert np.array_equal(got, want_words[r]), (L, prefix, r)
                if k == 0:  # the other offsets' words are these
                    dig = digest_of_blocks(model[r])
                    assert dig == hashlib.sha256(msgs[r].tobytes()).digest()
                    assert dig == want_dig[r].tobytes()


@pytest.mark.parametrize("r", range(64))
def test_rows_model_words_every_length_mod_64(r):
    """L = 192 + r: the 0x80 byte and the length at every place of the
    last block, and rows of 4 and 5 compressions across the first
    chunk's end, from an aligned and an unaligned tensor."""
    _check_rows(192 + r, 3, (0, 5 + r % 11), seed=r)


@pytest.mark.parametrize("L", [0, 1, 55, 56, 63, 64, 119, 127, 128, 1001])
def test_rows_model_short_rows_and_1001(L):
    """Messages of one block, the table's 128-byte leaves, and L = 1,001
    (four chunks, ragged against 16, 64 and the chunk)."""
    _check_rows(L, 3, (0, 1, 15), seed=L)


def test_rows_slot_holds_every_read():
    """Every granule a row's chunk stages and every quad its blocks read
    lie in the slot (the kernel's static_assert, modelled), for every
    offset mod 16 and prefix; the slot's pitch is 4 (mod 8) words."""
    nq = SLOT_WORDS // 4
    for off in range(16):
        for pre in (0, 1):
            length = 64 * CHUNK_BLOCKS - (pre if off == 0 else 0)
            assert 1 + ((off + length + 15) >> 4) <= nq
            for first in (True, False):
                e = 16 + off - (pre if first else 0)
                assert 0 <= e < 32
                assert (e >> 4) + 4 * (CHUNK_BLOCKS - 1) + 5 <= nq
    assert SLOT_WORDS % 8 == 4


def spread_threads(n: int, sms: int, most: int) -> int:
    """The C entry points' block size for n rows (``spread_threads``,
    ``mul_threads``): ``most``, halved down to 32 while blocks that large
    leave SMs without one."""
    t = most
    while t > 32 and -(-n // t) < sms:
        t >>= 1
    return t


@pytest.mark.parametrize(
    "n,threads", [(16384, 64), (8192, 32), (4096, 32), (1 << 20, 128), (1, 32)])
def test_rows_and_mul_blocks_fill_the_sms(n, threads):
    """K4 and K10 pick the same block size: 16,384 rows in 256 blocks of
    64 threads on the H100's 132 SMs; K4's slots fit the default 48 KB of
    shared memory at its largest block."""
    for most in (ROWS_MOST, MUL_MOST):
        t = spread_threads(n, H100_SMS, most)
        assert t == threads
        assert -(-n // t) >= min(H100_SMS, -(-n // 32))
    assert ROWS_MOST * SLOT_WORDS * 4 <= 48 * 1024
    assert "spread_threads(rows, sms, kRowsMostThreads)" in SHA_SRC
    assert "const int threads = mul_threads(n, sms);" in MODEXP_SRC


# ---------------------------------------------------------------------------
# K10: a warp's staging and its product
# ---------------------------------------------------------------------------

WARP_BYTES = 32 * VAL_BYTES


def warp_stage_in(mem: np.ndarray, src: int, valid: int) -> bytearray:
    """A warp's 1,056 staged bytes: ``valid`` bytes from ``mem[src:]`` as
    whole 16-byte granules (when src is aligned) then bytes; stale past
    them."""
    dst = bytearray(b"\xa5" * WARP_BYTES)
    i0 = 0
    if src % 16 == 0:
        n16 = valid >> 4
        for i in range(n16):
            dst[16 * i:16 * i + 16] = mem[src + 16 * i:src + 16 * i + 16].tobytes()
        i0 = n16 << 4
    dst[i0:valid] = mem[src + i0:src + valid].tobytes()
    return dst


def staged_value(rows: bytes, lane: int):
    """Lane ``lane``'s eight words and 33rd byte from nine aligned words."""
    at = (VAL_BYTES * lane) >> 2
    v = [int.from_bytes(rows[4 * (at + j):4 * (at + j) + 4], "little") for j in range(9)]
    sh = 8 * (lane & 3)
    x = [(((v[j + 1] << 32) | v[j]) >> sh) & M32 for j in range(8)]
    return x, (v[8] >> sh) & 0xFF


def put_values(rows: bytearray, xs: list) -> None:
    """Every lane's ``put_value`` into the warp's rows: eight aligned words
    from its first byte's, the shared word joined with the lane before
    (the shuffle), the ninth only at lane mod 4 = 3."""
    outs = []
    for lane, x in enumerate(xs):
        s = lane & 3
        o = [(x[0] << (8 * s)) & M32]
        o += [((((x[j] << 32) | x[j - 1]) << (8 * s)) >> 32) & M32 for j in range(1, 8)]
        o.append((((0 << 32) | x[7]) << (8 * s)) >> 32 & M32)
        outs.append(o)
    for lane, o in enumerate(outs):
        s = lane & 3
        before = outs[lane - 1][8] if lane > 0 else o[8]  # __shfl_up_sync
        words = list(o)
        if s > 0:
            words[0] |= before
        at = (VAL_BYTES * lane) >> 2
        for j in range(9 if s == 3 else 8):
            rows[4 * (at + j):4 * (at + j) + 4] = words[j].to_bytes(4, "little")


def _words(x: int) -> list:
    return [(x >> (32 * i)) & M32 for i in range(8)]


def _int(w: list) -> int:
    return sum(v << (32 * i) for i, v in enumerate(w))


class Spec:
    """The kernel's MontSpec of p (R = 2^256)."""

    def __init__(self, p: int):
        self.p = _words(p)
        self.pinv = (-pow(p, -1, 1 << 32)) % (1 << 32)
        self.r2, self.r3 = (_words(pow(1 << 256, k, p)) for k in (2, 3))


def team_prod(a: list, b: list, s: Spec) -> list:
    """One lane's CIOS product (``team_prod`` with T = 1): a b / 2^256
    mod p for a < 2^256 and b < p, the carry word kept and the final
    subtract decided on all 257 bits."""
    t, hi = [0] * 8, 0
    for i in range(8):
        ai = a[i]
        m = ((t[0] + ai * b[0]) * s.pinv) & M32
        c1 = c2 = 0
        for j in range(8):
            c1 += ai * b[j] + t[j]
            u = c1 & M32
            c1 >>= 32
            c2 += m * s.p[j] + u
            t[j] = c2 & M32
            c2 >>= 32
        sm = hi + c1 + c2
        t, hi = t[1:] + [sm & M32], sm >> 32
    return settle(t, hi, s)


def settle(t: list, hi: int, s: Spec) -> list:
    d = (_int(t) - _int(s.p)) % (1 << 256)
    borrow = 1 if _int(t) < _int(s.p) else 0
    return _words(d) if hi >= borrow else t


def team_to_mont(lo: list, h: int, any_h: bool, s: Spec) -> list:
    """x R mod p of the 264-bit value lo + h 2^256 (``team_to_mont``):
    the 33rd byte's product only when a lane of the warp has one."""
    r = team_prod(lo, s.r2, s)
    if any_h:
        z = team_prod([h] + [0] * 7, s.r3, s)
        total = _int(r) + _int(z)
        r = settle(_words(total), total >> 256, s)
    return r


def below_p(x: list, h: int, s: Spec) -> bool:
    return h == 0 and _int(x) < _int(s.p)


def mont_mul_warp(x: list, hx: list, y: list, hy: list, live: int, s: Spec) -> list:
    """A warp of ``mont_mul_kernel``: one product a lane when every live
    lane's a < 2^256 and b < p (or the other way round), else both values
    reduced first in every lane."""
    lanes = range(32)
    y_low = [below_p(y[i], hy[i], s) for i in lanes]
    direct = [i >= live or (hx[i] == 0 if y_low[i] else hy[i] == 0 and below_p(x[i], hx[i], s))
              for i in lanes]
    if all(direct):
        return [team_prod(x[i], y[i], s) if y_low[i] else team_prod(y[i], x[i], s) for i in lanes]
    one = [1] + [0] * 7
    xr = [team_prod(team_to_mont(x[i], hx[i], any(hx), s), one, s) for i in lanes]
    yr = [team_prod(team_to_mont(y[i], hy[i], any(hy), s), one, s) for i in lanes]
    return [team_prod(xr[i], yr[i], s) for i in lanes]


def mont_mul_model(xs: list, ys: list, p: int, base: int) -> list:
    """``mont_mul`` on rows of xs and ys laid out at byte ``base`` of a
    buffer, warp by warp, as the 33-byte results it stores."""
    s = Spec(p)
    n = len(xs)
    rng = np.random.default_rng(base)

    def lay(vals):
        mem = rng.integers(0, 256, base + VAL_BYTES * n + 16, dtype=np.uint8)
        mem[base:base + VAL_BYTES * n] = np.frombuffer(
            b"".join(v.to_bytes(VAL_BYTES, "little") for v in vals), np.uint8)
        return mem

    ma, mb = lay(xs), lay(ys)
    out = b""
    for first in range(0, n, 32):
        here = min(32, n - first)
        sa = warp_stage_in(ma, base + VAL_BYTES * first, VAL_BYTES * here)
        sb = warp_stage_in(mb, base + VAL_BYTES * first, VAL_BYTES * here)
        xv = [staged_value(sa, i) for i in range(32)]
        yv = [staged_value(sb, i) for i in range(32)]
        for i in range(here):  # the staging gives back every row exactly
            assert _int(xv[i][0]) + (xv[i][1] << 256) == xs[first + i]
            assert _int(yv[i][0]) + (yv[i][1] << 256) == ys[first + i]
        res = mont_mul_warp([v[0] for v in xv], [v[1] for v in xv],
                            [v[0] for v in yv], [v[1] for v in yv], here, s)
        put_values(sa, res)
        out += bytes(sa[:VAL_BYTES * here])
    return [int.from_bytes(out[VAL_BYTES * i:VAL_BYTES * i + VAL_BYTES], "little")
            for i in range(n)]


P2 = 0x93A40B764F1F5026ADA7C38AA3EF4EE81E01E89F9FE80837B1E370913DA99F13


def _mul_values(p: int, n: int, seed: int, unreduced_every: int) -> tuple:
    """n seeded pairs, edge rows first; every ``unreduced_every``-th pair
    (0: none) has one or both values in [p, 2^264)."""
    rnd = random.Random(seed)
    top = 1 << 264
    xs = [0, 1, p - 1, p, p + 1, top - 1, 1 << 256, p - 1]
    ys = [p - 1, p - 1, p - 1, p - 1, 1, top - 1, 1 << 256, top - 1]
    for i in range(n - len(xs)):
        if unreduced_every and i % unreduced_every == 0:
            xs.append(rnd.randrange(top))
            ys.append(rnd.randrange(p, top) if i % 2 else rnd.randrange(p))
        else:
            xs.append(rnd.randrange(p))
            ys.append(rnd.randrange(p))
    if not unreduced_every:
        xs, ys = [x % p for x in xs], [y % p for y in ys]
    return xs, ys


@pytest.mark.parametrize("p", [mm.DEFAULT_GROUP.p, P2], ids=["default", "p2"])
@pytest.mark.parametrize("unreduced_every,base", [(0, 0), (0, 7), (5, 0), (29, 3)])
def test_mont_mul_model_matches_reference(p, unreduced_every, base):
    """The model's results equal x y 2^-256 mod p, the reference's
    ``mont_mul_batch`` (x y 2^-264 mod p, 22 x 12-bit limbs) times 2^8,
    and the plain version's bytes, on three warps (the last ragged), with
    values in [p, 2^264) in some warps or none."""
    xs, ys = _mul_values(p, 75, seed=p % 1000 + unreduced_every, unreduced_every=unreduced_every)
    got = mont_mul_model(xs, ys, p, base)
    want = [x * y * pow(1 << 256, -1, p) % p for x, y in zip(xs, ys)]
    assert got == want
    assert all(g < p for g in got)
    if p == ref.P:
        ref_out = ref.limbs_to_ints(
            np.asarray(ref.mont_mul_batch(ref.ints_to_limbs(xs), ref.ints_to_limbs(ys))))
        assert got == [r * 2**8 % p for r in ref_out]
    plain = mx.mont_mul_batch(torch.from_numpy(np.array(mm.ints_to_bytes33(xs))),
                              torch.from_numpy(np.array(mm.ints_to_bytes33(ys))),
                              mx.mont_spec(p))
    assert mm.bytes33_to_ints(plain.numpy()) == got


def test_mont_mul_staging_round_trip():
    """33-byte rows through 16-byte granules, nine-word funnel shifts and
    the shuffle-joined stores come back byte for byte, for every lane's
    offset mod 4 and a ragged last warp (rows past it stay untouched)."""
    rnd = random.Random(3)
    for here in (32, 1, 5, 31):
        vals = [rnd.randrange(1 << 256) for _ in range(here)]
        mem = np.frombuffer(b"".join(v.to_bytes(VAL_BYTES, "little") for v in vals), np.uint8)
        rows = warp_stage_in(mem, 0, VAL_BYTES * here)
        got = [staged_value(rows, i) for i in range(here)]
        assert [(_int(w) + (h << 256)) for w, h in got] == vals
        back = bytearray(b"\x5a" * WARP_BYTES)
        put_values(back, [_words(v) for v in vals] + [[M32] * 8] * (32 - here))
        assert bytes(back[:VAL_BYTES * here]) == mem.tobytes()
