# The reference's tests/test_mesh.py, re-pointed at cleisthenes_tpu_torch:
# the port's CryptoMesh over eight handles of the CPU (where the
# reference forces eight virtual CPU devices), the 'cuda' backend on
# device='cpu' (the kernels' plain versions) where it says 'tpu'.  Each
# sharded call is also held byte-equal to the reference's sharded call
# on the eight virtual JAX CPU devices.
"""Multi-device crypto-plane sharding (SURVEY.md §2.2, §5.7-5.8).

Every test asserts the sharded path agrees bit-for-bit with the single-
device path and with the reference's GSPMD-sharded path.
"""

import numpy as np
import pytest
import torch

from cleisthenes_tpu.parallel.mesh import CryptoMesh as RefMesh
from cleisthenes_tpu_torch.parallel.mesh import CryptoMesh, make_crypto_mesh

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cpu_handles():
    return [CPU] * 8


@pytest.fixture(scope="module")
def mesh24(cpu_handles):
    return CryptoMesh((2, 4), devices=cpu_handles)


@pytest.fixture(scope="module")
def ref_mesh24(jax_cpu_devices):
    return RefMesh((2, 4), devices=jax_cpu_devices)


class TestCryptoMesh:
    def test_needs_enough_devices(self, cpu_handles):
        with pytest.raises(ValueError):
            CryptoMesh((4, 4), devices=cpu_handles)
        if torch.cuda.device_count() < 8:
            # the card's default list never falls back to fewer devices
            with pytest.raises(ValueError):
                CryptoMesh((2, 4))

    def test_bad_shape_rejected(self):
        with pytest.raises(ValueError):
            CryptoMesh((0, 2))
        with pytest.raises(ValueError):
            CryptoMesh((2,))

    def test_none_passthrough(self):
        assert make_crypto_mesh(None) is None

    def test_axis_names_and_shape(self, mesh24):
        assert mesh24.mesh.axis_names == ("v", "l")
        assert dict(zip(("v", "l"), mesh24.mesh.devices.shape)) == {
            "v": 2,
            "l": 4,
        }
        # the default list of a CPU device: v*l handles of the CPU
        assert list(CryptoMesh((2, 4), device="cpu").mesh.devices.flat) == [CPU] * 8

    def test_pad_rows_and_cols(self, mesh24):
        a = np.arange(3 * 5, dtype=np.uint8).reshape(3, 5)
        padded, b = mesh24.pad_rows(a, 4)
        assert padded.shape == (4, 5) and b == 3
        assert (padded[3] == a[0]).all()
        ref, _ = RefMesh.pad_rows(a, 4)
        assert np.array_equal(padded, ref)
        padded, l = mesh24.pad_cols(a, 4)
        assert padded.shape == (3, 8) and l == 5
        assert (padded[:, 5:] == 0).all()
        ref, _ = RefMesh.pad_cols(a, 4)
        assert np.array_equal(padded, ref)


class TestShardedErasure:
    """RS codec cut over ('v', 'l') tiles vs single-device."""

    @pytest.mark.parametrize("n,f,batch,length", [(8, 2, 8, 256), (7, 2, 5, 130)])
    def test_encode_batch_agrees(self, mesh24, ref_mesh24, n, f, batch, length):
        from cleisthenes_tpu.ops.rs_xla import XlaErasureCoder
        from cleisthenes_tpu_torch.ops.rs_cuda import CudaErasureCoder

        k = n - 2 * f
        rng = np.random.default_rng(5)
        data = rng.integers(0, 256, size=(batch, k, length), dtype=np.uint8)
        plain = CudaErasureCoder(n, k, device="cpu")
        sharded = CudaErasureCoder(n, k, device="cpu", mesh=mesh24)
        got = sharded.encode_batch(data)
        np.testing.assert_array_equal(plain.encode_batch(data), got)
        ref = XlaErasureCoder(n, k, mesh=ref_mesh24).encode_batch(data)
        np.testing.assert_array_equal(got, ref)

    def test_decode_batch_agrees_shared_pattern(self, mesh24, ref_mesh24):
        from cleisthenes_tpu.ops.rs_xla import XlaErasureCoder
        from cleisthenes_tpu_torch.ops.rs_cuda import CudaErasureCoder

        n, k, batch, length = 8, 4, 8, 192
        rng = np.random.default_rng(6)
        data = rng.integers(0, 256, size=(batch, k, length), dtype=np.uint8)
        plain = CudaErasureCoder(n, k, device="cpu")
        sharded = CudaErasureCoder(n, k, device="cpu", mesh=mesh24)
        enc = plain.encode_batch(data)
        survivors = np.array([n - k + i for i in range(k)])  # parity-heavy
        idx = np.tile(survivors, (batch, 1))
        got = sharded.decode_batch(idx, enc[:, survivors, :])
        np.testing.assert_array_equal(got, data)
        ref = XlaErasureCoder(n, k, mesh=ref_mesh24).decode_batch(
            idx, enc[:, survivors, :]
        )
        np.testing.assert_array_equal(got, ref)

    def test_decode_batch_agrees_mixed_patterns(self, mesh24, ref_mesh24):
        from cleisthenes_tpu.ops.rs_xla import XlaErasureCoder
        from cleisthenes_tpu_torch.ops.rs_cuda import CudaErasureCoder

        n, k, batch, length = 8, 4, 6, 128
        rng = np.random.default_rng(7)
        data = rng.integers(0, 256, size=(batch, k, length), dtype=np.uint8)
        sharded = CudaErasureCoder(n, k, device="cpu", mesh=mesh24)
        enc = CudaErasureCoder(n, k, device="cpu").encode_batch(data)
        idx = np.stack(
            [
                np.sort(rng.choice(n, size=k, replace=False))
                for _ in range(batch)
            ]
        )
        shards = np.stack([enc[i, idx[i], :] for i in range(batch)])
        got = sharded.decode_batch(idx, shards)
        np.testing.assert_array_equal(got, data)
        ref = XlaErasureCoder(n, k, mesh=ref_mesh24).decode_batch(idx, shards)
        np.testing.assert_array_equal(got, ref)
        # the fused K3 does not apply under a mesh (rs_xla.py:177)
        assert sharded.decode_recheck_batch(idx, shards) is None


class TestShardedMerkle:
    """Merkle forest + branch verify cut flat over every device."""

    def test_build_batch_agrees(self, mesh24, ref_mesh24):
        from cleisthenes_tpu.ops.merkle import XlaMerkle
        from cleisthenes_tpu_torch.ops.merkle import CudaMerkle

        rng = np.random.default_rng(8)
        shards = rng.integers(0, 256, size=(5, 8, 200), dtype=np.uint8)
        plain = CudaMerkle(device="cpu").build_batch(shards)
        sharded = CudaMerkle(device="cpu", mesh=mesh24).build_batch(shards)
        ref = XlaMerkle(mesh=ref_mesh24).build_batch(shards)
        for t0, t1, tr in zip(plain, sharded, ref):
            assert t0.root == t1.root == tr.root
            for j in range(8):
                assert t0.branch(j) == t1.branch(j) == tr.branch(j)

    def test_verify_batch_agrees(self, mesh24, ref_mesh24):
        from cleisthenes_tpu.ops.merkle import XlaMerkle
        from cleisthenes_tpu_torch.ops.merkle import CudaMerkle

        rng = np.random.default_rng(9)
        shards = rng.integers(0, 256, size=(4, 8, 96), dtype=np.uint8)
        m = CudaMerkle(device="cpu", mesh=mesh24)
        ref = XlaMerkle(mesh=ref_mesh24)
        trees = m.build_batch(shards)
        b = 4 * 8
        roots = np.stack(
            [np.frombuffer(t.root, dtype=np.uint8) for t in trees]
        ).repeat(8, axis=0)
        leaves = shards.reshape(b, -1).copy()
        branches = np.stack(
            [
                np.stack([np.frombuffer(s, np.uint8) for s in t.branch(j)])
                for t in trees
                for j in range(8)
            ]
        )
        indices = np.tile(np.arange(8), 4)
        ok = m.verify_batch(roots, leaves, branches, indices)
        assert ok.all()
        leaves[0, 0] ^= 1  # corrupt one shard byte
        ok = m.verify_batch(roots, leaves, branches, indices)
        assert not ok[0] and ok[1:].all()
        np.testing.assert_array_equal(
            ok, ref.verify_batch(roots, leaves, branches, indices)
        )


class TestShardedModexp:
    def test_dual_pow_agrees_with_cpu(self, mesh24, ref_mesh24):
        from cleisthenes_tpu.ops.modmath import ModEngine as RefEngine
        from cleisthenes_tpu_torch.ops.modmath import P, ModEngine

        rng = np.random.default_rng(10)
        b = 13  # deliberately not divisible by 8: exercises padding
        u1 = [int(x) % P for x in rng.integers(2, 1 << 62, size=b)]
        u2 = [int(x) % P for x in rng.integers(2, 1 << 62, size=b)]
        e1 = [int(x) for x in rng.integers(1, 1 << 62, size=b)]
        e2 = [int(x) for x in rng.integers(1, 1 << 62, size=b)]
        cpu = ModEngine("cpu").dual_pow_batch(u1, e1, u2, e2)
        eng = ModEngine("cuda", device="cpu", mesh=mesh24)
        assert cpu == eng.dual_pow_batch(u1, e1, u2, e2)
        ref = RefEngine("tpu", mesh=ref_mesh24).dual_pow_batch(u1, e1, u2, e2)
        assert cpu == ref

    def test_pow_agrees_with_cpu(self, mesh24, ref_mesh24):
        from cleisthenes_tpu.ops.modmath import ModEngine as RefEngine
        from cleisthenes_tpu_torch.ops.modmath import G, P, Q, ModEngine

        bases = [G, 9, P - 2, 12345678901234567890 % P]
        exps = [3, Q - 1, 2, 65537]
        cpu = ModEngine("cpu").pow_batch(bases, exps)
        eng = ModEngine("cuda", device="cpu", mesh=mesh24)
        assert cpu == eng.pow_batch(bases, exps)
        # grouped calls flatten under a mesh (no comb, modmath.py:930)
        groups = [(G, [3, Q - 1] * 40), (9, [2, 65537] * 10)]
        assert eng.pow_batch_grouped(groups) == ModEngine("cpu").pow_batch_grouped(groups)
        ref = RefEngine("tpu", mesh=ref_mesh24).pow_batch(bases, exps)
        assert cpu == ref


class TestShardedProtocolE2E:
    def test_hbbft_epoch_with_mesh(self):
        """Full HBBFT over the channel transport with the crypto plane
        sharded over the (2, 4) mesh of CPU handles — Config.mesh_shape
        is a live knob end to end."""
        from tests.test_torch_honeybadger import (
            assert_identical_batches,
            make_hb_network,
            push_txs,
        )

        cfg, net, nodes = make_hb_network(
            4, batch_size=8, crypto_backend="cuda", mesh_shape=(2, 4)
        )
        assert nodes["node0"].crypto.mesh is not None
        assert nodes["node0"].crypto.mesh.shape == (2, 4)
        push_txs(nodes, 8)
        for hb in nodes.values():
            hb.start_epoch()
        net.run()
        assert_identical_batches(nodes)


class TestNonPow2Mesh:
    def test_merkle_bucket_handles_six_devices(self, cpu_handles, jax_cpu_devices):
        """A (3, 2) mesh (6 devices) pads a batch of 5 to a multiple of
        6 and gives the unsharded roots."""
        from cleisthenes_tpu.ops.merkle import XlaMerkle
        from cleisthenes_tpu_torch.ops.merkle import CudaMerkle

        mesh = CryptoMesh((3, 2), devices=cpu_handles)
        m = CudaMerkle(device="cpu", mesh=mesh)
        assert m._bucket(5) % 6 == 0
        rng = np.random.default_rng(11)
        shards = rng.integers(0, 256, size=(5, 4, 64), dtype=np.uint8)
        plain = CudaMerkle(device="cpu").build_batch(shards)
        sharded = m.build_batch(shards)
        ref = XlaMerkle(mesh=RefMesh((3, 2), devices=jax_cpu_devices)).build_batch(shards)
        for t0, t1, tr in zip(plain, sharded, ref):
            assert t0.root == t1.root == tr.root
