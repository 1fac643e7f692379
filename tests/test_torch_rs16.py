"""The port's GF(2^16) Reed-Solomon codec (cleisthenes_tpu_torch.ops
gf65536 / rs16 / rs16_cuda) against the JAX package's.

The cases of tests/test_rs16.py re-pointed at the port, and the K11
kernel's plain version (``gf65536_apply_plain``, which the wrappers run
for CPU tensors) held byte for byte to the reference's lifted bit-plane
kernels (``encode_kernel_batch``, ``decode_kernel_shared``, JAX on the
CPU) and to the host coder; and a numpy model of the CUDA kernel's
tensor-core arithmetic held to both.  Tolerance zero: exact field
arithmetic."""

import numpy as np
import pytest
import torch

from cleisthenes_tpu.ops import gf65536 as ref_gf
from cleisthenes_tpu.ops.rs16 import Cpu16ErasureCoder as RefCpu16
from cleisthenes_tpu.ops.rs16_xla_kernels import (
    decode_kernel_shared,
    encode_kernel_batch,
)
from cleisthenes_tpu_torch.ops import gf65536 as gf
from cleisthenes_tpu_torch.ops import rs16_cuda
from cleisthenes_tpu_torch.ops.rs16 import Cpu16ErasureCoder, Cuda16ErasureCoder


def test_field_axioms_sampled():
    rng = np.random.default_rng(3)
    for _ in range(200):
        a, b, c = (int(x) for x in rng.integers(1, gf.ORDER, 3))
        assert gf.gf_mul(a, gf.gf_inv(a)) == 1
        assert gf.gf_mul(a, b) == gf.gf_mul(b, a)
        assert gf.gf_mul(a, gf.gf_mul(b, c)) == gf.gf_mul(gf.gf_mul(a, b), c)
        # distributivity over xor (field addition)
        assert gf.gf_mul(a, b ^ c) == gf.gf_mul(a, b) ^ gf.gf_mul(a, c)
    assert np.array_equal(gf.GF_EXP, ref_gf.GF_EXP)
    assert np.array_equal(gf.GF_LOG, ref_gf.GF_LOG)


def test_mul_vec_matches_scalar():
    rng = np.random.default_rng(4)
    a = rng.integers(0, gf.ORDER, 64).astype(np.uint16)
    b = rng.integers(0, gf.ORDER, 64).astype(np.uint16)
    got = gf.gf_mul_vec(a, b)
    for i in range(64):
        assert int(got[i]) == gf.gf_mul(int(a[i]), int(b[i]))


def test_cpu16_roundtrip_any_k_subset():
    rng = np.random.default_rng(5)
    n, k, L = 24, 9, 96
    coder = Cpu16ErasureCoder(n, k)
    data = rng.integers(0, 256, size=(k, L), dtype=np.uint8)
    full = coder.encode(data)
    assert np.array_equal(full[:k], data)  # systematic
    for _ in range(5):
        pick = sorted(rng.choice(n, size=k, replace=False).tolist())
        assert np.array_equal(coder.decode(pick, full[pick]), data)


def test_cuda16_matches_cpu16():
    rng = np.random.default_rng(6)
    n, k, L = 20, 7, 64
    cpu = Cpu16ErasureCoder(n, k)
    cuda = Cuda16ErasureCoder(n, k, device="cpu")
    batch = rng.integers(0, 256, size=(6, k, L), dtype=np.uint8)
    full = cuda.encode_batch(batch)
    assert np.array_equal(full, np.stack([cpu.encode(b) for b in batch]))
    pick = [19, 17, 11, 7, 5, 3, 0]
    idx = np.tile(np.array(pick), (6, 1))
    assert np.array_equal(cuda.decode_batch(idx, full[:, pick, :]), batch)
    # single instances and a mixed-pattern batch run on the device path too
    assert np.array_equal(cuda.encode(batch[0]), full[0])
    assert np.array_equal(cuda.decode(pick, full[0, pick]), batch[0])
    pats = [sorted(rng.choice(n, k, replace=False).tolist()) for _ in range(6)]
    mixed = np.stack([full[i, p] for i, p in enumerate(pats)])
    assert np.array_equal(cuda.decode_batch(np.array(pats), mixed), batch)


def test_n512_roster_roundtrip():
    """512 distinct shard indices — impossible in GF(2^8) — on both the
    host coder and the device coder's plain path."""
    rng = np.random.default_rng(7)
    n, k = 512, 172
    coder = Cpu16ErasureCoder(n, k)
    cuda = Cuda16ErasureCoder(n, k, device="cpu")
    data = rng.integers(0, 256, size=(k, 8), dtype=np.uint8)
    full = coder.encode(data)
    assert np.array_equal(cuda.encode_batch(data[None])[0], full)
    assert np.array_equal(full, RefCpu16(n, k).encode(data))
    surv = list(range(n - k, n))  # parity-heavy survivor set
    assert np.array_equal(coder.decode(surv, full[surv]), data)
    assert np.array_equal(
        cuda.decode_batch(np.array([surv]), full[None, surv])[0], data
    )


def test_factory_selects_field_by_n():
    from cleisthenes_tpu_torch.ops.backend import make_erasure_coder

    assert make_erasure_coder("cpu", 512, 172).MAX_N == gf.ORDER
    wide = make_erasure_coder("cuda", 300, 100, device="cpu")
    assert isinstance(wide, Cuda16ErasureCoder) and wide.MAX_N == gf.ORDER
    assert make_erasure_coder("cpu", 64, 22).MAX_N == 256
    with pytest.raises(ValueError):
        make_erasure_coder("tpu", 300, 100)


def test_odd_shard_length_rejected():
    coder = Cpu16ErasureCoder(8, 3)
    with pytest.raises(ValueError):
        coder.encode(np.zeros((3, 7), dtype=np.uint8))
    cuda = Cuda16ErasureCoder(8, 3, device="cpu")
    with pytest.raises(ValueError):
        cuda.encode_batch(np.zeros((2, 3, 7), dtype=np.uint8))


def _syms(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint16))


def test_plain_kernel_matches_reference_kernels():
    """B=4, n=300, k=100, L=8 bytes (S=4 symbols): the plain K11 encode
    and the shared decode against the reference's bit-plane kernels and
    the host coder, with zero symbols and zero matrix rows in play."""
    rng = np.random.default_rng(11)
    b, n, k, L = 4, 300, 100, 8
    s = L // 2
    a = gf.systematic_rs_matrix(n, k)
    syms = rng.integers(0, gf.ORDER, (b, k, s)).astype(np.uint16)
    syms[0, :7] = 0
    syms[1, :, 0] = 0
    ref_full = np.asarray(
        encode_kernel_batch(ref_gf.lift_to_bits(a[k:]), syms)
    )
    enc = _syms(a)
    rs16_cuda.mark_systematic(enc, a)
    ours = rs16_cuda.rs16_encode(enc, _syms(syms)).numpy()
    assert ours.dtype == np.uint16 and ours.shape == (b, n, s)
    assert np.array_equal(ours, ref_full)
    cpu = Cpu16ErasureCoder(n, k)
    data = syms.view(np.uint8).reshape(b, k, L)
    full_bytes = np.stack([cpu.encode(d) for d in data])
    assert np.array_equal(ours.view(np.uint8).reshape(b, n, L), full_bytes)
    # decode: parity-heavy survivors, shared inverse
    pick = sorted(rng.choice(n, k, replace=False).tolist())
    inv = gf.gf_mat_inv(a[pick])
    surv = np.ascontiguousarray(ref_full[:, pick])
    ref_dec = np.asarray(
        decode_kernel_shared(ref_gf.lift_to_bits(inv), surv)
    )
    ours_dec = rs16_cuda.rs16_decode(_syms(inv), _syms(surv)).numpy()
    assert np.array_equal(ours_dec, ref_dec)
    assert np.array_equal(ours_dec, syms)
    # the coder's device path: byte view, shared and per-instance
    cuda = Cuda16ErasureCoder(n, k, device="cpu")
    assert np.array_equal(cuda.encode_batch(data), full_bytes)
    idx = np.tile(pick, (b, 1))
    assert np.array_equal(cuda.decode_batch(idx, full_bytes[:, pick]), data)
    pats = [sorted(rng.choice(n, k, replace=False).tolist()) for _ in range(b)]
    per = np.stack([full_bytes[i, q] for i, q in enumerate(pats)])
    assert np.array_equal(cuda.decode_batch(np.array(pats), per), data)


def test_plain_kernel_zero_matrix_and_checks():
    """A zero matrix gives zero symbols; misshapen inputs raise."""
    x = _syms(np.arange(12, dtype=np.uint16).reshape(1, 3, 4) * 5000)
    zero = torch.zeros((2, 3), dtype=torch.uint16)
    assert not rs16_cuda.gf65536_apply_plain(zero, x).any()
    eye = torch.from_numpy(np.eye(3, dtype=np.uint16))
    assert torch.equal(rs16_cuda.rs16_decode(eye, x), x)
    with pytest.raises(ValueError):
        rs16_cuda.rs16_encode(eye, x.to(torch.int32))
    with pytest.raises(ValueError):
        rs16_cuda.rs16_encode(torch.zeros((2, 4), dtype=torch.uint16), x)
    with pytest.raises(ValueError):
        rs16_cuda.rs16_decode(torch.zeros((2, 3, 3), dtype=torch.uint16), x)


def test_batch_crypto_decode_recheck_takes_three_steps():
    """Past 256 validators the 'cuda' BatchCrypto has no fused
    decode-recheck: it decodes, re-encodes and builds the forest in
    three calls (dispatches == 3), as the reference's does for its
    GF(2^16) coder, with the host coder's data and roots."""
    from cleisthenes_tpu_torch.ops.backend import BatchCrypto
    from cleisthenes_tpu_torch.ops.merkle import CpuMerkle

    rng = np.random.default_rng(12)
    n, f = 257, 85
    k = n - 2 * f
    crypto = BatchCrypto("cuda", n, f, k, device="cpu")
    assert isinstance(crypto.erasure, Cuda16ErasureCoder)
    data = rng.integers(0, 256, (3, k, 4), dtype=np.uint8)
    full = crypto.erasure.encode_batch(data)
    idx = np.tile(np.arange(k), (3, 1))
    got, roots, dispatches = crypto.decode_recheck_batch(idx, full[:, :k])
    assert dispatches == 3 and np.array_equal(got, data)
    want = [t.root for t in CpuMerkle().build_batch(full)]
    assert [r.tobytes() for r in roots] == want


def test_cuda16_default_needs_a_gpu():
    """The GF(2^16) device coder's default device is the card: without
    one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default runs there")
    from cleisthenes_tpu_torch.ops.backend import make_erasure_coder

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Cuda16ErasureCoder(300, 100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_erasure_coder("cuda", 512, 172)


# -- the K11 kernel's arithmetic (csrc/gf65536.cu: lifted rows packed in
# words, column words from symbols, AND, popcount parity, output packing),
# modelled in numpy


def _xtime2(v: np.ndarray) -> np.ndarray:
    """v * x mod 0x1100B in each 16-bit half of uint32 ``v``."""
    return ((v << 1) & np.uint32(0xFFFEFFFE)) ^ (
        ((v >> 15) & np.uint32(0x00010001)) * np.uint32(0x100B)
    )


def lift_words(mat: np.ndarray) -> np.ndarray:
    """(m, k) uint16 -> (16m, kpad / 2) uint32, kpad = k rounded up to 16
    (zero coefficients): the kernel's A operand.  Word w of lifted row
    16r + e' holds, in bit 16h + e, bit e' of M[r, 2w + h] * x^e; it is
    built as the kernel builds it, from the packed pair M[r, 2w] |
    M[r, 2w + 1] << 16 by 16 xtime steps and a 16 x 16 bit transpose per
    half."""
    m, k = mat.shape
    kpad = -(-k // 16) * 16
    c = np.zeros((m, kpad), dtype=np.uint32)
    c[:, :k] = mat
    v = c[:, 0::2] | (c[:, 1::2] << 16)
    p = []
    for _ in range(16):
        p.append(v)
        v = _xtime2(v)
    p = np.stack(p)  # (16, m, kpad / 2): p[e] = pair * x^e
    for sh, mask in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        lo = np.array([i for i in range(16) if not i & sh])
        t = ((p[lo] >> sh) ^ p[lo + sh]) & np.uint32(mask)
        p[lo + sh] ^= t
        p[lo] ^= t << sh
    return p.transpose(1, 0, 2).reshape(16 * m, kpad // 2)


def column_words(x: np.ndarray) -> np.ndarray:
    """(B, k, S) uint16 -> (B, S, kpad / 2) uint32: the kernel's B
    operand, word w of column (b, s) = x[b, 2w, s] | x[b, 2w + 1, s] << 16,
    zero past k."""
    b, k, s = x.shape
    kpad = -(-k // 16) * 16
    xp = np.zeros((b, kpad, s), dtype=np.uint32)
    xp[:, :k] = x
    return (xp[:, 0::2] | (xp[:, 1::2] << 16)).transpose(0, 2, 1)


def gf2_apply_model(mat: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The kernel's function by its arithmetic: popcount(row AND column)
    over the words, bit 0 of the count, 16 lifted rows packed into one
    symbol.  mat (m, k) or (B, m, k), x (B, k, S) uint16 -> (B, m, S)."""
    b, k, s = x.shape
    mats = np.broadcast_to(mat, (b,) + mat.shape[-2:])
    cols = column_words(x)
    out = np.zeros((b, mats.shape[1], s), dtype=np.uint16)
    for i in range(b):
        a = lift_words(mats[i])  # (16m, W)
        counts = np.bitwise_count(a[:, None, :] & cols[i][None]).sum(-1, dtype=np.int64)
        bits = (counts & 1).reshape(-1, 16, s).astype(np.uint16)
        out[i] = (bits << np.arange(16, dtype=np.uint16)[None, :, None]).sum(1, dtype=np.uint16)
    return out


def _unpack_words(w: np.ndarray) -> np.ndarray:
    """(..., W) uint32 -> (..., 32W) bits, bit i of word j at 32j + i."""
    return np.unpackbits(
        np.ascontiguousarray(w, dtype="<u4").view(np.uint8), axis=-1, bitorder="little"
    )


@pytest.mark.parametrize("m,k", [(10, 6), (170, 87), (3, 16), (2, 17)])
def test_lift_words_are_the_reference_lifting(m, k):
    """Word w of lifted row 16r+e' holds columns 32w..32w+31 of the
    reference's (16m, 16k) lifting, zero past 16k (k padded to 16)."""
    rng = np.random.default_rng(40 + k)
    a = rng.integers(0, gf.ORDER, (m, k)).astype(np.uint16)
    a[0, :3] = 0
    words = lift_words(a)
    kpad = -(-k // 16) * 16
    assert words.shape == (16 * m, kpad // 2) and words.dtype == np.uint32
    bits = _unpack_words(words)
    ref = ref_gf.lift_to_bits(a)
    assert np.array_equal(bits[:, : 16 * k], ref)
    assert not bits[:, 16 * k :].any()


def test_column_words_are_the_symbols_bits():
    rng = np.random.default_rng(44)
    x = rng.integers(0, gf.ORDER, (3, 21, 5)).astype(np.uint16)
    cols = column_words(x)
    assert cols.shape == (3, 5, 16)
    for b in range(3):
        bits = _unpack_words(cols[b])  # (S, 512)
        assert np.array_equal(bits[:, : 16 * 21].T, ref_gf.symbols_to_bits(x[b]))
        assert not bits[:, 16 * 21 :].any()


@pytest.mark.parametrize("n,f,s", [(16, 5, 7), (257, 85, 3)])
def test_gf2_model_matches_plain_and_reference(n, f, s):
    """The model of the kernel's arithmetic, byte-equal to the plain
    version and to the reference's bit-plane kernels (JAX on the CPU):
    encode of the parity rows, shared decode and per-instance decode, k
    padded with zero coefficients (k = 6 -> 16, k = 87 -> 96)."""
    rng = np.random.default_rng(n)
    k = n - 2 * f
    b = 3
    a = gf.systematic_rs_matrix(n, k)
    syms = rng.integers(0, gf.ORDER, (b, k, s)).astype(np.uint16)
    syms[0, :2] = 0
    parity = gf2_apply_model(a[k:], syms)
    plain = rs16_cuda.gf65536_apply_plain(_syms(a), _syms(syms)).numpy()
    ref_full = np.asarray(encode_kernel_batch(ref_gf.lift_to_bits(a[k:]), syms))
    assert np.array_equal(parity, plain[:, k:])
    assert np.array_equal(parity, ref_full[:, k:])
    assert np.array_equal(plain, ref_full)
    pick = sorted(rng.choice(n, k, replace=False).tolist())
    inv = gf.gf_mat_inv(a[pick])
    surv = np.ascontiguousarray(ref_full[:, pick])
    dec = gf2_apply_model(inv, surv)
    ref_dec = np.asarray(decode_kernel_shared(ref_gf.lift_to_bits(inv), surv))
    assert np.array_equal(dec, ref_dec) and np.array_equal(dec, syms)
    pats = [sorted(rng.choice(n, k, replace=False).tolist()) for _ in range(b)]
    invs = np.stack([gf.gf_mat_inv(a[q]) for q in pats])
    per = np.stack([ref_full[i, q] for i, q in enumerate(pats)])
    dec_pi = gf2_apply_model(invs, per)
    assert np.array_equal(dec_pi, rs16_cuda.gf65536_apply_plain(_syms(invs), _syms(per)).numpy())
    assert np.array_equal(dec_pi, syms)


def test_encode_takes_only_a_systematic_matrix():
    """rs16_encode multiplies the parity rows and copies the data rows,
    so it takes only a matrix that mark_systematic checked (the codec
    marks its matrix where it builds it): an unmarked matrix, one written
    to since, and a matrix without an identity top raise."""
    rng = np.random.default_rng(45)
    x = _syms(rng.integers(0, gf.ORDER, (2, 4, 3)).astype(np.uint16))
    a = gf.systematic_rs_matrix(9, 4)
    enc = _syms(a)
    with pytest.raises(ValueError, match="mark_systematic"):
        rs16_cuda.rs16_encode(enc, x)
    rs16_cuda.mark_systematic(enc, a)
    full = rs16_cuda.rs16_encode(enc, x)
    assert torch.equal(full[:, :4], x)
    assert torch.equal(full, rs16_cuda.gf65536_apply_plain(enc, x))
    enc.zero_()
    with pytest.raises(ValueError, match="written to since"):
        rs16_cuda.rs16_encode(enc, x)
    bad = a.copy()
    bad[1, 2] = 7
    with pytest.raises(ValueError, match="identity top"):
        rs16_cuda.mark_systematic(_syms(bad), bad)
    with pytest.raises(ValueError, match="systematic"):
        rs16_cuda.mark_systematic(_syms(a[:2, :3]), a[:2, :3])
    with pytest.raises(ValueError, match="systematic"):
        rs16_cuda.rs16_encode(_syms(a[:2, :3]), x[:, :3].contiguous())
    with pytest.raises(ValueError, match="is not"):
        rs16_cuda.mark_systematic(_syms(a[:8]), a)
    coder = Cuda16ErasureCoder(9, 4, device="cpu")
    rs16_cuda.require_systematic(coder._enc, "rs16_encode")  # the codec marked its matrix


def test_chip_smoke_counts_bit_products():
    """chip_smoke.py's K11 counts: bit products = 16 m x 16 k x columns,
    with no padding of k; the b1 yardstick scales the b1 reading by the
    gap between NVIDIA's published s8 peak and the s8 reading, never
    below the reading."""
    import chip_smoke as cs

    assert cs.gf2_bit_products(340, 172, 512 * 64) == 5440 * 2752 * 32768
    assert cs.gf2_bit_products(172, 172, 512 * 64) == 2752 * 2752 * 32768
    assert cs.gf2_bit_products(1, 1, 1) == 256
    assert cs.S8_PUBLISHED_MACS_PER_S == pytest.approx(9.895e14)
    assert cs.b1_yardstick(5.0e15, cs.S8_PUBLISHED_MACS_PER_S / 2) == pytest.approx(1.0e16)
    assert cs.b1_yardstick(5.0e15, cs.S8_PUBLISHED_MACS_PER_S * 2) == 5.0e15
    ms, by = cs.tc_bound(45_000_000, 5 * 10**10, 5.0e15)
    assert by == "bytes" and ms == pytest.approx(0.0134328, rel=1e-4)
    ms, by = cs.tc_bound(1000, 5 * 10**11, 5.0e15)
    assert by == "operations" and ms == pytest.approx(0.1)


def test_chip_smoke_profile_split():
    """chip_smoke.py's profiler split: device time per kernel and per
    memcpy direction inside the epoch's window, and the busy share as the
    union of device intervals (overlaps counted once)."""
    import chip_smoke as cs

    events = [
        ("gf65536_gf2_kernel", 10, 30),
        ("Memcpy HtoD (Pageable -> Device)", 25, 40),
        ("gf65536_gf2_kernel", 50, 60),
        ("Memcpy DtoH (Device -> Pageable)", 70, 75),
        ("merkle_forest_kernel", 200, 210),  # outside the window
    ]
    split = cs.profile_split(events, (0, 100))
    assert split["kernels_us"] == {"gf65536_gf2_kernel": 30}
    assert split["copies_us"] == {"HtoD": 15, "DtoH": 5}
    assert split["busy_us"] == 30 + 10 + 5 and split["busy_share"] == pytest.approx(0.45)
    assert cs._merged_us([]) == 0.0


def test_mma_probe_source_matches_its_rate_arithmetic():
    """The probe the b1 yardstick comes from: its source launches the
    THREADS and CHAINS that ``mma_rates`` counts instructions by, and runs
    the two instructions of ``INSTRS`` with their K; no kernel library
    carries it."""
    from cleisthenes_tpu_torch.csrc import build, mma_probe

    src = mma_probe.SOURCE
    assert f"constexpr int kThreads = {mma_probe.THREADS};" in src
    assert f"constexpr int kChains = {mma_probe.CHAINS};" in src
    assert [k for _, _, k in mma_probe.INSTRS] == [256, 32]
    assert "m16n8k256.row.col.s32.b1.b1.s32.and.popc" in src
    assert "m16n8k32.row.col.s32.s8.s8.s32" in src
    assert all("mma_rate_probe" not in fns for fns in build.SIGNATURES.values())
