"""The port's native host kernels and its ``'cpp'`` backend
(cleisthenes_tpu_torch.native, ops/rs_cpp.py): tests/test_native.py
re-pointed at the port, the codec also held to the reference's
``CppErasureCoder`` byte for byte.

``test_hbbft_epoch_on_cpp_backend`` needs the asynchronous protocol plane
(``HoneyBadger`` over the channel transport), which the port does not
have yet; in its place ``test_lockstep_epoch_on_cpp_backend`` runs the
port's ``LockstepCluster`` at N=4 on ``crypto_backend='cpp'`` against
the reference's on ``'cpp'`` and compares the committed batches byte for
byte."""

import hashlib

import numpy as np
import pytest

from cleisthenes_tpu.ops.rs_cpp import CppErasureCoder as RefCppErasureCoder
from cleisthenes_tpu_torch.ops.rs_cpp import CppErasureCoder
from cleisthenes_tpu_torch.ops.rs_cpu import CpuErasureCoder


def test_native_selftest_passes():
    from cleisthenes_tpu_torch.native import load_gf256, native_available

    assert native_available()
    assert load_gf256().gf256_selftest() == 0


@pytest.mark.parametrize("n,k", [(4, 2), (7, 3), (16, 6), (64, 22)])
def test_cpp_encode_matches_numpy(n, k):
    rng = np.random.default_rng(n * 100 + k)
    data = rng.integers(0, 256, size=(k, 384), dtype=np.uint8)
    ours = CppErasureCoder(n, k).encode(data)
    assert np.array_equal(ours, CpuErasureCoder(n, k).encode(data))
    assert np.array_equal(ours, RefCppErasureCoder(n, k).encode(data))


@pytest.mark.parametrize("seed", range(4))
def test_cpp_decode_roundtrip_any_k_survivors(seed):
    rng = np.random.default_rng(seed)
    n, k = 10, 4
    coder = CppErasureCoder(n, k)
    data = rng.integers(0, 256, size=(k, 200), dtype=np.uint8)
    full = coder.encode(data)
    survivors = sorted(rng.choice(n, size=k, replace=False).tolist())
    out = coder.decode(survivors, full[survivors])
    assert np.array_equal(out, data)


def test_cpp_encode_batch_matches_single():
    rng = np.random.default_rng(3)
    n, k, b = 8, 4, 5
    coder = CppErasureCoder(n, k)
    data = rng.integers(0, 256, size=(b, k, 128), dtype=np.uint8)
    batched = coder.encode_batch(data)
    for i in range(b):
        assert np.array_equal(batched[i], coder.encode(data[i]))
    assert np.array_equal(batched, RefCppErasureCoder(n, k).encode_batch(data))


def test_backend_registry_exposes_cpp():
    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.ops.backend import get_backend
    from cleisthenes_tpu_torch.ops.merkle import CpuMerkle
    from cleisthenes_tpu_torch.ops.rs16 import Cpu16ErasureCoder

    cfg = Config(n=4, crypto_backend="cpp")
    crypto = get_backend(cfg)
    assert crypto.engine_backend == "cpu"
    assert isinstance(crypto.erasure, CppErasureCoder)
    assert isinstance(crypto.merkle, CpuMerkle) and crypto.device is None
    svc = crypto.tpke(_pub())
    assert (svc.backend, svc.device) == ("cpu", None)
    data = np.arange(2 * 128, dtype=np.uint8).reshape(2, 128)
    full = crypto.erasure.encode(data)
    assert np.array_equal(
        crypto.erasure.decode([2, 3], full[2:4]), data
    )
    # past the GF(2^8) ceiling 'cpp' serves the roster from the host's
    # GF(2^16) coder, as the reference does
    wide = get_backend(Config(n=300, crypto_backend="cpp"))
    assert isinstance(wide.erasure, Cpu16ErasureCoder)


def _pub():
    from cleisthenes_tpu_torch.ops import tpke

    return tpke.deal(4, 2, seed=6)[0]


def test_lockstep_epoch_on_cpp_backend():
    from cleisthenes_tpu.protocol.spmd import LockstepCluster as RefCluster
    from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster

    runs = []
    for cls in (RefCluster, LockstepCluster):
        c = cls(n=4, batch_size=8, crypto_backend="cpp", key_seed=11)
        for i in range(8):
            c.submit(b"cpp-tx-%02d" % i)
        stats = c.run_epoch()
        runs.append(([b.contributions for b in c.committed_batches],
                     stats["bba_rounds"]))
    assert runs[0] == runs[1]
    committed = [tx for c in runs[1][0] for v in c.values() for tx in v]
    assert len(committed) == 8


class TestSha256Rows:
    def test_matches_hashlib_fixed_and_var(self):
        from cleisthenes_tpu_torch.ops.hashrows import sha256_rows

        rng = np.random.default_rng(3)
        rows = rng.integers(0, 256, size=(97, 131), dtype=np.uint8)
        got = sha256_rows(rows)
        for i in (0, 50, 96):
            assert got[i].tobytes() == hashlib.sha256(rows[i].tobytes()).digest()
        lens = rng.integers(0, 132, size=97)
        got = sha256_rows(rows, lens)
        for i in (0, 13, 96):
            assert (
                got[i].tobytes()
                == hashlib.sha256(rows[i, : int(lens[i])].tobytes()).digest()
            )

    def test_rejects_out_of_range_lens(self):
        from cleisthenes_tpu_torch.ops.hashrows import sha256_rows

        rows = np.zeros((2, 8), dtype=np.uint8)
        with pytest.raises(ValueError):
            sha256_rows(rows, np.array([1, 9]))
        with pytest.raises(ValueError):
            sha256_rows(rows, np.array([-1, 4]))

    def test_fallback_path_matches_native(self, monkeypatch):
        """With the native library unavailable the hashlib fallback
        produces identical digests."""
        from cleisthenes_tpu_torch.native.build import load_sha256
        from cleisthenes_tpu_torch.ops import hashrows

        assert load_sha256() is not None
        rng = np.random.default_rng(9)
        rows = rng.integers(0, 256, size=(13, 57), dtype=np.uint8)
        lens = rng.integers(0, 58, size=13)
        native = hashrows.sha256_rows(rows, lens)
        monkeypatch.setattr(hashrows, "load_sha256", lambda: None)
        degraded = hashrows.sha256_rows(rows, lens)
        assert (native == degraded).all()
        # independent hashlib checks for BOTH fallback branches
        for i in (0, 7):
            assert (
                degraded[i].tobytes()
                == hashlib.sha256(rows[i, : int(lens[i])].tobytes()).digest()
            )
        full = hashrows.sha256_rows(rows)
        assert full[3].tobytes() == hashlib.sha256(rows[3].tobytes()).digest()
