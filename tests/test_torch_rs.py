"""The port's Reed-Solomon codec (cleisthenes_tpu_torch.ops.rs_cuda)
against the JAX package's, byte for byte.

The CUDA kernel itself runs only on a card (chip_smoke.py holds it to
its plain version there); here the plain PyTorch version — which the
wrappers run for CPU tensors — meets the reference's jitted TPU kernels
run on the CPU, on the same numpy-seeded inputs, with zero tolerance
(GF(2^8) arithmetic is exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleisthenes_tpu.ops import gf256 as ref_gf
from cleisthenes_tpu.ops import rs_xla
from cleisthenes_tpu.ops.rs_xla import XlaErasureCoder
from cleisthenes_tpu_torch.ops import gf256
from cleisthenes_tpu_torch.ops import rs_cuda
from cleisthenes_tpu_torch.ops.rs_cuda import CudaErasureCoder

ROSTERS = [(4, 1), (7, 2), (16, 5)]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def test_gf_tables_match_reference():
    assert np.array_equal(gf256.GF_EXP, ref_gf.GF_EXP)
    assert np.array_equal(gf256.GF_LOG, ref_gf.GF_LOG)
    assert np.array_equal(gf256.GF_MUL_TABLE, ref_gf.GF_MUL_TABLE)
    for n, f in ROSTERS + [(128, 42)]:
        k = n - 2 * f
        a = gf256.systematic_rs_matrix(n, k)
        assert np.array_equal(a, ref_gf.systematic_rs_matrix(n, k))
        rows = list(range(n - k, n))
        assert np.array_equal(gf256.gf_mat_inv(a[rows]), ref_gf.gf_mat_inv(a[rows]))
    a = gf256.systematic_rs_matrix(7, 3)
    assert np.array_equal(gf256.lift_to_bits(a), ref_gf.lift_to_bits(a))


@pytest.mark.parametrize("n,f", ROSTERS)
@pytest.mark.parametrize("length", [1, 37, 300])
def test_plain_apply_matches_jax_kernels(n, f, length):
    k = n - 2 * f
    rng = np.random.default_rng(1000 * n + length)
    b = 3
    data = rng.integers(0, 256, (b, k, length), dtype=np.uint8)
    a = gf256.systematic_rs_matrix(n, k)
    g_enc = jnp.asarray(ref_gf.lift_to_bits(a[k:]), dtype=jnp.bfloat16)
    # K1: encode
    want = np.asarray(rs_xla._encode_kernel_batch(g_enc, jnp.asarray(data)))
    assert np.array_equal(rs_cuda.gf256_apply_plain(_t(a), _t(data)).numpy(), want)
    full = want
    # K2, shared pattern: the last k shards survive
    rows = list(range(n - k, n))
    inv = gf256.gf_mat_inv(a[rows])
    shards = np.ascontiguousarray(full[:, rows])
    g = jnp.asarray(ref_gf.lift_to_bits(inv), dtype=jnp.bfloat16)
    want = np.asarray(rs_xla._decode_kernel_shared(g, jnp.asarray(shards)))
    got = rs_cuda.gf256_apply_plain(_t(inv), _t(shards)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, data)
    # K2, one pattern per instance
    pats = [sorted(rng.choice(n, k, replace=False).tolist()) for _ in range(b)]
    invs = np.stack([gf256.gf_mat_inv(a[p]) for p in pats])
    shards = np.stack([full[i, p] for i, p in enumerate(pats)])
    gs = jnp.stack(
        [jnp.asarray(ref_gf.lift_to_bits(m), dtype=jnp.bfloat16) for m in invs]
    )
    want = np.asarray(rs_xla._decode_kernel_batch(gs, jnp.asarray(shards)))
    got = rs_cuda.gf256_apply_plain(_t(invs), _t(shards)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, data)


@pytest.mark.parametrize("n,f", ROSTERS + [(10, 3)])
def test_roundtrip_random_erasures(n, f):
    k = n - 2 * f
    rng = np.random.default_rng(n)
    coder = CudaErasureCoder(n, k, device="cpu")
    data = rng.integers(0, 256, (5, k, 41), dtype=np.uint8)
    full = coder.encode_batch(data)
    assert np.array_equal(full[:, :k], data)
    pats = np.stack([rng.choice(n, k, replace=False) for _ in range(5)])
    shards = np.stack([full[i, p] for i, p in enumerate(pats)])
    assert np.array_equal(coder.decode_batch(pats, shards), data)
    # the single-instance surface, unordered survivors
    p = list(pats[0])
    assert np.array_equal(coder.decode(p, full[0, p]), data[0])
    assert np.array_equal(coder.encode(data[1]), full[1])


@pytest.mark.parametrize("n,f", [(7, 2), (16, 5)])
def test_coder_matches_xla_coder(n, f):
    """Large enough that the reference takes its device path (above
    its 4 x 64 KiB host floor), so the two kernels meet."""
    k = n - 2 * f
    rng = np.random.default_rng(7 * n)
    data = rng.integers(0, 256, (8, k, 8192), dtype=np.uint8)
    ours = CudaErasureCoder(n, k, device="cpu")
    ref = XlaErasureCoder(n, k)
    full = ours.encode_batch(data)
    assert np.array_equal(full, ref.encode_batch(data))
    pats = np.stack([np.arange(n - k, n)] * 8)
    shards = np.ascontiguousarray(full[:, n - k :])
    assert np.array_equal(
        ours.decode_batch(pats, shards), ref.decode_batch(pats, shards)
    )


def test_wrappers_reject_what_the_kernel_does_not_take():
    x = torch.zeros((2, 3, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        rs_cuda.rs_encode(torch.zeros((5, 3), dtype=torch.int32), x)
    with pytest.raises(ValueError):
        rs_cuda.rs_encode(torch.zeros((5, 2), dtype=torch.uint8), x)
    with pytest.raises(ValueError):
        rs_cuda.rs_decode(torch.zeros((3, 3, 3), dtype=torch.uint8), x)
    with pytest.raises(ValueError):
        strided = torch.zeros((2, 4, 3), dtype=torch.uint8).transpose(1, 2)
        rs_cuda.rs_encode(torch.zeros((5, 3), dtype=torch.uint8), strided)
