"""The port's SHA-256 / Merkle entry points (cleisthenes_tpu_torch.ops.
sha256_cuda, ops.merkle, and the fused decode-recheck of ops.rs_cuda)
against the JAX package's, byte for byte.

The plain PyTorch versions — which the wrappers run for CPU tensors —
meet the reference's jitted TPU kernels run on the CPU and ``hashlib``,
on numpy-seeded inputs, with zero tolerance.  The CUDA kernels are held
to the same plain versions on the card by chip_smoke.py."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleisthenes_tpu.ops import gf256 as ref_gf
from cleisthenes_tpu.ops import rs_xla, sha256_xla
from cleisthenes_tpu.ops.merkle import CpuMerkle as RefCpuMerkle
from cleisthenes_tpu_torch.ops import gf256, rs_cuda, sha256_cuda
from cleisthenes_tpu_torch.ops.merkle import CpuMerkle, CudaMerkle


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "length", [0, 1, 31, 32, 55, 56, 63, 64, 65, 119, 127, 200, 1000]
)
def test_sha256_plain_matches_jax_and_hashlib(length):
    """Also tests/test_merkle.py's ``TestSha256Xla.test_matches_hashlib``:
    its lengths, on the plain version and the wrapper."""
    rng = np.random.default_rng(length)
    msgs = rng.integers(0, 256, (6, length), dtype=np.uint8)
    got = sha256_cuda.sha256_rows_plain(_t(msgs)).numpy()
    if length:
        want = np.asarray(sha256_xla.sha256_batch(jnp.asarray(msgs)))
        assert np.array_equal(got, want)
    for row, dig in zip(msgs, got):
        assert dig.tobytes() == hashlib.sha256(row.tobytes()).digest()
    assert np.array_equal(sha256_cuda.sha256_rows(_t(msgs)).numpy(), got)
    # the wrapper with a domain byte, as the forest uses it
    pref = sha256_cuda.sha256_rows(_t(msgs), 0x01).numpy()
    for row, dig in zip(msgs, pref):
        assert dig.tobytes() == hashlib.sha256(b"\x01" + row.tobytes()).digest()


def test_sha256_known_vector():
    """tests/test_merkle.py's ``TestSha256Xla.test_known_vector``."""
    msg = np.frombuffer(b"abc", dtype=np.uint8)[None]
    got = sha256_cuda.sha256_rows(_t(msg)).numpy()[0].tobytes()
    assert got.hex() == (
        "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad"
    )


def test_empty_leaf_sentinel_is_the_reference_one():
    assert sha256_cuda.EMPTY_LEAF_DIGEST == sha256_xla._zero_digest()


@pytest.mark.parametrize("n", [4, 7, 8, 16])
def test_build_forest_matches_jax(n):
    rng = np.random.default_rng(100 + n)
    shards = rng.integers(0, 256, (3, n, 37), dtype=np.uint8)
    want = np.asarray(sha256_xla.build_forest(jnp.asarray(shards)))
    got = sha256_cuda.build_forest(_t(shards)).numpy()
    assert np.array_equal(got, want)
    # the backend surface: same trees as the reference's host backend
    trees = CudaMerkle(device="cpu").build_batch(shards)
    ref = RefCpuMerkle().build_batch(shards)
    for t, r in zip(trees, ref):
        assert t.root == r.root and t.depth == r.depth
        assert all(np.array_equal(a, b) for a, b in zip(t.levels, r.levels))
        assert t.branch(n - 1) == r.branch(n - 1)


def _branch_rows(shards):
    b, n, _ = shards.shape
    trees = RefCpuMerkle().build_batch(shards)
    roots = np.repeat(
        np.stack([np.frombuffer(t.root, np.uint8) for t in trees]), n, 0
    )
    d = trees[0].depth
    br = np.zeros((b * n, d, 32), np.uint8)
    for i, t in enumerate(trees):
        for j in range(n):
            for lvl, sib in enumerate(t.branch(j)):
                br[i * n + j, lvl] = np.frombuffer(sib, np.uint8)
    return roots, shards.reshape(b * n, -1).copy(), br, np.tile(np.arange(n), b)


def test_verify_branches_matches_jax_with_tampering():
    rng = np.random.default_rng(5)
    n = 7
    roots, leaves, br, idx = _branch_rows(
        rng.integers(0, 256, (3, n, 29), dtype=np.uint8)
    )
    leaves[1, 3] ^= 0x10  # tampered leaf
    br[9, 0, 0] ^= 0x01  # tampered sibling
    idx[12] ^= 1  # wrong index
    want = np.asarray(
        sha256_xla.verify_branches(
            jnp.asarray(roots), jnp.asarray(leaves), jnp.asarray(br),
            jnp.asarray(idx.astype(np.uint32)),
        )
    )
    got = sha256_cuda.verify_branches(
        _t(roots), _t(leaves), _t(br), _t(idx.astype(np.int64))
    ).numpy()
    assert np.array_equal(got, want)
    assert not got[[1, 9, 12]].any() and got.sum() == len(got) - 3
    assert np.array_equal(
        CudaMerkle(device="cpu").verify_batch(roots, leaves, br, idx), want
    )
    assert np.array_equal(CpuMerkle().verify_batch(roots, leaves, br, idx), want)


def test_decode_recheck_matches_jax():
    n, f = 7, 2
    k = n - 2 * f
    rng = np.random.default_rng(11)
    a = gf256.systematic_rs_matrix(n, k)
    data = rng.integers(0, 256, (4, k, 37), dtype=np.uint8)
    full = rs_cuda.gf256_apply_plain(_t(a), _t(data)).numpy()
    rows = [1, 4, 6]
    inv = gf256.gf_mat_inv(a[rows])
    shards = np.ascontiguousarray(full[:, rows])
    want_data, want_roots = rs_xla._decode_recheck_kernel(
        jnp.asarray(ref_gf.lift_to_bits(inv), dtype=jnp.bfloat16),
        jnp.asarray(ref_gf.lift_to_bits(a[k:]), dtype=jnp.bfloat16),
        jnp.asarray(shards),
    )
    # the re-encode takes the systematic matrix as rs_encode does: checked
    # once by mark_systematic
    enc = _t(a)
    rs_cuda.mark_systematic(enc, a)
    got_data, got_roots = rs_cuda.decode_recheck(_t(inv), enc, _t(shards))
    assert np.array_equal(got_data.numpy(), np.asarray(want_data))
    assert np.array_equal(got_roots.numpy(), np.asarray(want_roots))
    assert np.array_equal(got_data.numpy(), data)
    plain = rs_cuda.decode_recheck_plain(_t(inv), enc, _t(shards))
    assert torch.equal(plain[0], got_data) and torch.equal(plain[1], got_roots)
    # the coder surface: mixed erasure patterns stay fused on the port
    coder = rs_cuda.CudaErasureCoder(n, k, device="cpu")
    pats = np.array([rows, [0, 1, 2], rows, [2, 3, 5]])
    sh = np.stack([full[i, p] for i, p in enumerate(pats)])
    d2, r2 = coder.decode_recheck_batch(pats, sh)
    assert np.array_equal(d2, data)
    assert np.array_equal(r2, np.asarray(want_roots))


# -- tests/test_merkle.py's TestMerkle cases, re-pointed at the port: the
# host backend and the card's backend on a CPU device (its plain versions)

def _port_merkle(backend: str):
    from cleisthenes_tpu_torch.ops.merkle import make_merkle

    return make_merkle(backend, device="cpu")


merkle_rng = np.random.default_rng(7)


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
class TestPortMerkle:
    @pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 16])
    def test_build_and_verify_all_branches(self, backend, n):
        m = _port_merkle(backend)
        shards = merkle_rng.integers(0, 256, (n, 64)).astype(np.uint8)
        tree = m.build(shards)
        for j in range(n):
            assert m.verify_branch(
                tree.root, shards[j].tobytes(), tree.branch(j), j
            ), f"branch {j} of {n}"

    def test_tampered_leaf_rejected(self, backend, n=7):
        m = _port_merkle(backend)
        shards = merkle_rng.integers(0, 256, (n, 64)).astype(np.uint8)
        tree = m.build(shards)
        bad = bytearray(shards[3].tobytes())
        bad[0] ^= 1
        assert not m.verify_branch(tree.root, bytes(bad), tree.branch(3), 3)

    def test_wrong_index_rejected(self, backend, n=8):
        m = _port_merkle(backend)
        shards = merkle_rng.integers(0, 256, (n, 32)).astype(np.uint8)
        tree = m.build(shards)
        assert not m.verify_branch(
            tree.root, shards[3].tobytes(), tree.branch(3), 4
        )

    def test_tampered_branch_rejected(self, backend, n=4):
        m = _port_merkle(backend)
        shards = merkle_rng.integers(0, 256, (n, 32)).astype(np.uint8)
        tree = m.build(shards)
        branch = tree.branch(0)
        branch[1] = b"\x00" * 32
        assert not m.verify_branch(tree.root, shards[0].tobytes(), branch, 0)

    def test_batch_build_matches_single(self, backend):
        m = _port_merkle(backend)
        shards = merkle_rng.integers(0, 256, (5, 7, 48)).astype(np.uint8)
        trees = m.build_batch(shards)
        for i, t in enumerate(trees):
            assert t.root == m.build(shards[i]).root

    def test_batch_verify(self, backend):
        """The ECHO hot path: many (root, leaf, branch, index) checks in
        one call, including an invalid one."""
        m = _port_merkle(backend)
        n = 8
        shards = merkle_rng.integers(0, 256, (n, 64)).astype(np.uint8)
        tree = m.build(shards)
        roots = np.stack([np.frombuffer(tree.root, dtype=np.uint8)] * n)
        leaves = shards.copy()
        branches = np.stack(
            [
                np.stack([np.frombuffer(s, dtype=np.uint8) for s in tree.branch(j)])
                for j in range(n)
            ]
        )
        indices = np.arange(n)
        leaves[2] ^= 0xFF  # corrupt one
        ok = m.verify_batch(roots, leaves, branches, indices)
        want = np.ones(n, dtype=bool)
        want[2] = False
        assert np.array_equal(ok, want)


def test_backends_identical_roots():
    shards = merkle_rng.integers(0, 256, (7, 128)).astype(np.uint8)
    assert CpuMerkle().build(shards).root == CudaMerkle(device="cpu").build(shards).root


def test_branch_index_out_of_range():
    m = CpuMerkle()
    tree = m.build(merkle_rng.integers(0, 256, (4, 16)).astype(np.uint8))
    with pytest.raises(IndexError):
        tree.branch(4)


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("n", [1, 5, 16])
def test_build_and_verify_branch_match_reference(backend, n):
    """``build(...).root``, every branch and ``verify_branch`` (true
    proofs, a tampered leaf, a wrong index) equal the reference's on the
    same seeded shards."""
    rng = np.random.default_rng(300 + n)
    shards = rng.integers(0, 256, (n, 40), dtype=np.uint8)
    ours, ref = _port_merkle(backend), RefCpuMerkle()
    tree, ref_tree = ours.build(shards), ref.build(shards)
    assert tree.root == ref_tree.root and tree.depth == ref_tree.depth
    for j in range(n):
        assert tree.branch(j) == ref_tree.branch(j)
        for leaf, idx in ((shards[j].tobytes(), j),
                          (bytes([shards[j, 0] ^ 1]) + shards[j, 1:].tobytes(), j),
                          (shards[j].tobytes(), j ^ 1)):
            got = ours.verify_branch(tree.root, leaf, tree.branch(j), idx)
            assert got == ref.verify_branch(ref_tree.root, leaf, ref_tree.branch(j), idx)


def test_chip_smoke_off_path_kernels_are_listed():
    """chip_smoke.py's OFF_PATH (kernels no epoch path launches, held to
    0 launches on every path) names kernels of its kernels line, each
    with its reason; sha256_rows is one since the forest is one kernel."""
    import chip_smoke as cs

    names = {name for name, _, _ in cs.KERNELS}
    assert set(cs.OFF_PATH) <= names
    assert "sha256_rows" in cs.OFF_PATH and "merkle_forest" not in cs.OFF_PATH
    assert all(len(reason) > 20 for reason in cs.OFF_PATH.values())
