"""The port's GF(2^16) Reed-Solomon codec (cleisthenes_tpu_torch.ops
gf65536 / rs16 / rs16_cuda) against the JAX package's.

The cases of tests/test_rs16.py re-pointed at the port, and the K11
kernel's plain version (``gf65536_apply_plain``, which the wrappers run
for CPU tensors) held byte for byte to the reference's lifted bit-plane
kernels (``encode_kernel_batch``, ``decode_kernel_shared``, JAX on the
CPU) and to the host coder.  Tolerance zero: exact field arithmetic."""

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
    ours = rs16_cuda.rs16_encode(_syms(a), _syms(syms)).numpy()
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
