"""The GF(2^8) codec kernel's arithmetic (csrc/gf256.cu: lifted rows
packed in words, column words from bytes, AND, popcount parity, output
packing), modelled in numpy and held to the JAX package's lifting and
kernels.

The CUDA kernel runs only on a card (chip_smoke.py holds it to its plain
version there); these models pin its word layout here: each model is held
to ``cleisthenes_tpu/ops/gf256.py`` ``lift_to_bits`` / ``bytes_to_bits``
and, through ``gf2_apply_model8``, to the reference's
``_encode_kernel_batch`` / ``_decode_kernel_shared`` /
``_decode_kernel_batch`` (JAX on the CPU) and to the port's plain
version, byte for byte.  Tolerance zero: exact field arithmetic."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleisthenes_tpu.ops import gf256 as ref_gf
from cleisthenes_tpu.ops import rs_xla
from cleisthenes_tpu_torch.ops import gf256, rs_cuda

_SRC = Path(rs_cuda.__file__).resolve().parent.parent / "csrc" / "gf256.cu"


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _xtime4(v: np.ndarray) -> np.ndarray:
    """v * x mod 0x11D in each byte of uint32 ``v``."""
    return ((v << 1) & np.uint32(0xFEFEFEFE)) ^ (
        ((v >> 7) & np.uint32(0x01010101)) * np.uint32(0x1D)
    )


def lift_words8(mat: np.ndarray) -> np.ndarray:
    """(m, k) uint8 -> (8m, kpad / 4) uint32, kpad = k rounded up to 32
    (zero coefficients): the kernel's A operand.  Word w of lifted row
    8r + e' holds, in bit 8h + e, bit e' of M[r, 4w + h] * x^e; it is
    built as the kernel builds it, from the packed word M[r, 4w] | ... |
    M[r, 4w + 3] << 24 by 8 xtime steps and an 8 x 8 bit transpose per
    byte."""
    m, k = mat.shape
    kpad = -(-k // 32) * 32
    c = np.zeros((m, kpad), dtype=np.uint32)
    c[:, :k] = mat
    v = c[:, 0::4] | (c[:, 1::4] << 8) | (c[:, 2::4] << 16) | (c[:, 3::4] << 24)
    p = []
    for _ in range(8):
        p.append(v)
        v = _xtime4(v)
    p = np.stack(p)  # (8, m, kpad / 4): p[e] = word * x^e
    for sh, mask in ((4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        lo = np.array([i for i in range(8) if not i & sh])
        t = ((p[lo] >> sh) ^ p[lo + sh]) & np.uint32(mask)
        p[lo + sh] ^= t
        p[lo] ^= t << sh
    return p.transpose(1, 0, 2).reshape(8 * m, kpad // 4)


def column_words8(x: np.ndarray) -> np.ndarray:
    """(B, k, L) uint8 -> (B, L, kpad / 4) uint32: the kernel's B
    operand, word w of column (b, l) = x[b, 4w, l] | ... | x[b, 4w + 3, l]
    << 24, zero past k."""
    b, k, l = x.shape
    kpad = -(-k // 32) * 32
    xp = np.zeros((b, kpad, l), dtype=np.uint32)
    xp[:, :k] = x
    w = xp[:, 0::4] | (xp[:, 1::4] << 8) | (xp[:, 2::4] << 16) | (xp[:, 3::4] << 24)
    return w.transpose(0, 2, 1)


def gf2_apply_model8(mat: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The kernel's function by its arithmetic: popcount(row AND column)
    over the words, bit 0 of the count, 8 lifted rows packed into one
    byte.  mat (m, k) or (B, m, k), x (B, k, L) uint8 -> (B, m, L)."""
    b, k, l = x.shape
    mats = np.broadcast_to(mat, (b,) + mat.shape[-2:])
    cols = column_words8(x)
    out = np.zeros((b, mats.shape[1], l), dtype=np.uint8)
    for i in range(b):
        a = lift_words8(mats[i])  # (8m, W)
        counts = np.bitwise_count(a[:, None, :] & cols[i][None]).sum(-1, dtype=np.int64)
        bits = (counts & 1).reshape(-1, 8, l).astype(np.uint8)
        out[i] = (bits << np.arange(8, dtype=np.uint8)[None, :, None]).sum(1, dtype=np.uint8)
    return out


def byte_perm(a: np.ndarray, b: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm: result byte i is byte (sel >> 4i) & 7 of the
    8 bytes b:a (a the low four)."""
    src = np.stack(
        [(a >> (8 * i)) & 0xFF for i in range(4)]
        + [(b >> (8 * i)) & 0xFF for i in range(4)]
    )
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def _unpack_words(w: np.ndarray) -> np.ndarray:
    """(..., W) uint32 -> (..., 32W) bits, bit i of word j at 32j + i."""
    return np.unpackbits(
        np.ascontiguousarray(w, dtype="<u4").view(np.uint8), axis=-1, bitorder="little"
    )


@pytest.mark.parametrize("m,k", [(84, 44), (6, 2), (3, 31), (2, 32), (5, 33), (1, 200)])
def test_lift_words8_are_the_reference_lifting(m, k):
    """Word w of lifted row 8r+e' holds columns 32w..32w+31 of the
    reference's (8m, 8k) lifting, zero past 8k (k padded to 32)."""
    rng = np.random.default_rng(80 + k)
    a = rng.integers(0, 256, (m, k)).astype(np.uint8)
    a[0, : min(3, k)] = 0
    words = lift_words8(a)
    kpad = -(-k // 32) * 32
    assert words.shape == (8 * m, kpad // 4) and words.dtype == np.uint32
    bits = _unpack_words(words)
    assert np.array_equal(bits[:, : 8 * k], ref_gf.lift_to_bits(a))
    assert not bits[:, 8 * k :].any()


def test_column_words8_are_the_bytes_bits():
    rng = np.random.default_rng(81)
    x = rng.integers(0, 256, (3, 37, 5)).astype(np.uint8)
    cols = column_words8(x)
    assert cols.shape == (3, 5, 16)
    for b in range(3):
        bits = _unpack_words(cols[b])  # (L, 512)
        assert np.array_equal(bits[:, : 8 * 37].T, ref_gf.bytes_to_bits(x[b]))
        assert not bits[:, 8 * 37 :].any()


def test_staging_byte_transpose_gives_the_column_words():
    """The kernel stages 4 bytes of rows 4w..4w+3 a thread and turns them
    into 4 columns' words with the byte permutes of csrc/gf256.cu; the
    same permutes on the same words give ``column_words8``."""
    src = _SRC.read_text()
    for expr in ("__byte_perm(rw[0], rw[1], 0x5140)", "__byte_perm(rw[0], rw[1], 0x7362)",
                 "__byte_perm(rw[2], rw[3], 0x5140)", "__byte_perm(rw[2], rw[3], 0x7362)",
                 "__byte_perm(t0, u0, 0x5410)", "__byte_perm(t0, u0, 0x7632)",
                 "__byte_perm(t1, u1, 0x5410)", "__byte_perm(t1, u1, 0x7632)"):
        assert expr in src
    rng = np.random.default_rng(82)
    x = rng.integers(0, 256, (1, 32, 8)).astype(np.uint8)
    want = column_words8(x)[0]  # (8 columns, 8 words)
    for w in range(8):
        for c in range(0, 8, 4):
            rw = [np.array(int.from_bytes(x[0, 4 * w + h, c : c + 4].tobytes(), "little"),
                           dtype=np.uint32) for h in range(4)]
            t0, t1 = byte_perm(rw[0], rw[1], 0x5140), byte_perm(rw[0], rw[1], 0x7362)
            u0, u1 = byte_perm(rw[2], rw[3], 0x5140), byte_perm(rw[2], rw[3], 0x7362)
            got = [byte_perm(t0, u0, 0x5410), byte_perm(t0, u0, 0x7632),
                   byte_perm(t1, u1, 0x5410), byte_perm(t1, u1, 0x7632)]
            assert [int(g) for g in got] == [int(want[c + i, w]) for i in range(4)]


def test_epilogue_packs_two_rows_a_tile():
    """One m16 tile is two output rows: lifted rows 0-7 are row r's
    bits, 8-15 row r+1's, so the kernel's epilogue word for columns
    2 tig, 2 tig + 1 is (r, 2tig) | (r, 2tig+1) << 8 | (r+1, 2tig) << 16
    | (r+1, 2tig+1) << 24, and a 16-bit store writes each row's pair."""
    src = _SRC.read_text()
    assert re.search(r"\(acc\[i\]\[t\]\[0\] & 1u\) << g\) \| "
                     r"\(\(acc\[i\]\[t\]\[1\] & 1u\) << \(g \+ 8\)\)", src)
    assert "((acc[i][t][2] & 1u) << (g + 16)) | ((acc[i][t][3] & 1u) << (g + 24))" in src
    rng = np.random.default_rng(83)
    mat = rng.integers(0, 256, (2, 40)).astype(np.uint8)
    x = rng.integers(0, 256, (1, 40, 8)).astype(np.uint8)
    a, cols = lift_words8(mat), column_words8(x)[0]
    # c[row, col] of the m16n8 tile: the parity of popcount(lifted row AND column)
    c = np.bitwise_count(a[:, None, :] & cols[None]).sum(-1) & 1  # (16, 8)
    want = gf2_apply_model8(mat, x)[0]
    for tig in range(4):
        word = 0
        for g in range(8):
            word |= (int(c[g, 2 * tig]) << g) | (int(c[g, 2 * tig + 1]) << (g + 8))
            word |= (int(c[g + 8, 2 * tig]) << (g + 16)) | (int(c[g + 8, 2 * tig + 1]) << (g + 24))
        assert word.to_bytes(4, "little") == bytes(
            [want[0, 2 * tig], want[0, 2 * tig + 1], want[1, 2 * tig], want[1, 2 * tig + 1]])


@pytest.mark.parametrize("n,f", [(4, 1), (16, 5), (96, 32), (100, 33), (128, 42)])
def test_gf2_model8_matches_plain_and_reference(n, f):
    """The model of the kernel's arithmetic, byte-equal to the plain
    version and to the reference's JAX kernels: encode of the parity rows,
    shared decode and per-instance decode, k padded with zero
    coefficients on both sides of the 32-byte step (k = 2, 6 -> 32;
    k = 32; k = 34, 44 -> 64)."""
    rng = np.random.default_rng(n)
    k = n - 2 * f
    b, length = 3, 37
    a = gf256.systematic_rs_matrix(n, k)
    data = rng.integers(0, 256, (b, k, length)).astype(np.uint8)
    data[0, :2] = 0
    parity = gf2_apply_model8(a[k:], data)
    plain = rs_cuda.gf256_apply_plain(_t(a), _t(data)).numpy()
    g_enc = jnp.asarray(ref_gf.lift_to_bits(a[k:]), dtype=jnp.bfloat16)
    ref_full = np.asarray(rs_xla._encode_kernel_batch(g_enc, jnp.asarray(data)))
    assert np.array_equal(parity, plain[:, k:])
    assert np.array_equal(parity, ref_full[:, k:])
    assert np.array_equal(plain, ref_full)
    pick = sorted(rng.choice(n, k, replace=False).tolist())
    inv = gf256.gf_mat_inv(a[pick])
    surv = np.ascontiguousarray(ref_full[:, pick])
    dec = gf2_apply_model8(inv, surv)
    g = jnp.asarray(ref_gf.lift_to_bits(inv), dtype=jnp.bfloat16)
    ref_dec = np.asarray(rs_xla._decode_kernel_shared(g, jnp.asarray(surv)))
    assert np.array_equal(dec, ref_dec) and np.array_equal(dec, data)
    pats = [sorted(rng.choice(n, k, replace=False).tolist()) for _ in range(b)]
    invs = np.stack([gf256.gf_mat_inv(a[q]) for q in pats])
    per = np.stack([ref_full[i, q] for i, q in enumerate(pats)])
    gs = jnp.stack([jnp.asarray(ref_gf.lift_to_bits(q), dtype=jnp.bfloat16) for q in invs])
    ref_pi = np.asarray(rs_xla._decode_kernel_batch(gs, jnp.asarray(per)))
    dec_pi = gf2_apply_model8(invs, per)
    assert np.array_equal(dec_pi, ref_pi)
    assert np.array_equal(dec_pi, rs_cuda.gf256_apply_plain(_t(invs), _t(per)).numpy())
    assert np.array_equal(dec_pi, data)


def test_rs_encode_takes_only_a_systematic_matrix():
    """rs_encode multiplies the parity rows and copies the data rows, so
    it takes only a matrix that mark_systematic checked (CudaErasureCoder
    marks its matrix where it builds it): an unmarked matrix, one written
    to since, and a matrix without an identity top raise; so does
    decode_recheck's re-encode."""
    rng = np.random.default_rng(84)
    x = _t(rng.integers(0, 256, (2, 4, 3)).astype(np.uint8))
    a = gf256.systematic_rs_matrix(9, 4)
    enc = _t(a)
    with pytest.raises(
        ValueError, match="rs_encode: the matrix was not checked by mark_systematic"
    ):
        rs_cuda.rs_encode(enc, x)
    with pytest.raises(ValueError, match="mark_systematic"):
        rs_cuda.decode_recheck(_t(np.eye(4, dtype=np.uint8)), enc, x)
    rs_cuda.mark_systematic(enc, a)
    full = rs_cuda.rs_encode(enc, x)
    assert torch.equal(full[:, :4], x)
    assert torch.equal(full, rs_cuda.gf256_apply_plain(enc, x))
    enc.zero_()
    with pytest.raises(ValueError, match="written to since"):
        rs_cuda.rs_encode(enc, x)
    bad = a.copy()
    bad[1, 2] = 7
    with pytest.raises(ValueError, match="identity top"):
        rs_cuda.mark_systematic(_t(bad), bad)
    coder = rs_cuda.CudaErasureCoder(9, 4, device="cpu")
    rs_cuda.require_systematic(coder._enc, "rs_encode")  # the coder marked its matrix


def test_chip_smoke_counts_gf256_bit_products():
    """chip_smoke.py's K1/K2 counts: bit products = 8 m x 8 k x columns
    with no padding of k; at the N=128 encode (B=128, k=44, n=128,
    L=128) the tensor-core bound is bytes, ~0.84 us, below the int-op
    bound, and K3's adds its forest's int32 operations."""
    import chip_smoke as cs

    assert cs.gf2_bit_products(84, 44, 128 * 128, 8) == 672 * 352 * 16384 == 3875536896
    assert cs.gf2_bit_products(1, 1, 1, 8) == 64
    assert cs.gf2_bit_products(1, 1, 1) == 256  # K11's e = 16 by default
    nbytes = 128 * 44 * 128 + 128 * 44 + 128 * 128 * 128
    ms, by = cs.tc_bound(nbytes, cs.gf2_bit_products(84, 44, 128 * 128, 8), 7.9e15)
    assert by == "bytes" and ms == pytest.approx(nbytes / cs.HBM_BYTES_PER_S * 1e3)
    assert ms < cs.bound(nbytes, 2 * 128 * 84 * 44 * 128)[0]
    ms, by = cs.tc_bound(1000, 10**9, 7.9e15, int_ops=10**9)
    assert by == "operations" and ms == pytest.approx(10**9 / cs.INT32_OPS_PER_S * 1e3)


@pytest.mark.parametrize("form", ["row0", "tables"])
def test_sweep_calls_the_parent_as_its_source_declares(form):
    """gf2_sweep.py --parent reads the form of the parent's C entry point
    from its source: this tree's (``row0``, as csrc/build.py binds it) or
    the first design's (exp/log tables, the whole matrix); any other form
    is refused rather than called with the wrong arguments."""
    import gf2_sweep

    src = _SRC.read_text()
    if form == "tables":
        src = src.replace("const void* x,", "const void* exp_tab, const void* log_tab,\n"
                          "                           const void* x,", 1)
        src = src.replace(" int row0,\n", "\n", 1)
    assert gf2_sweep.gf256_abi(src) == form
    with pytest.raises(RuntimeError, match="unknown gf256_apply parameters"):
        gf2_sweep.gf256_abi(src.replace("void* out,", "void* out, int extra,", 1))
