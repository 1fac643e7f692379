"""tests/test_erasure.py re-pointed at the port: GF(2^8) field math
(ops/gf256.py), the Reed-Solomon codecs behind ``make_erasure_coder`` and
the payload framing (ops/payload.py).

The reference's ``["cpu", "tpu"]`` arms become the port's ``"cpu"``
(numpy tables), ``"cpp"`` (the native host kernel, ops/rs_cpp.py) and
``"cuda"`` on a CPU device (the GF(2^8) kernel's plain PyTorch version,
ops/rs_cuda.py).  Each arm's encode and decode are held to the
reference's numpy coder, and the payload framing to the reference's
bytes, on the same seeded inputs.  The two bit-lifting cases of
``TestGF256`` were ported in slice 6 and live in tests/test_torch_rs.py."""

import numpy as np
import pytest

from cleisthenes_tpu.ops import gf256 as ref_gf256
from cleisthenes_tpu.ops import payload as ref_payload
from cleisthenes_tpu.ops.backend import make_erasure_coder as make_ref_coder
from cleisthenes_tpu_torch.ops import gf256
from cleisthenes_tpu_torch.ops.backend import make_erasure_coder
from cleisthenes_tpu_torch.ops.payload import join_payload, split_payload

BACKENDS = ["cpu", "cpp", "cuda"]

rng = np.random.default_rng(42)


def _coder(backend, n, k):
    return make_erasure_coder(backend, n, k, device="cpu")


class TestGF256:
    def test_field_axioms_sampled(self):
        for _ in range(200):
            a, b, c = (int(x) for x in rng.integers(0, 256, 3))
            assert gf256.gf_mul(a, b) == gf256.gf_mul(b, a)
            assert gf256.gf_mul(a, gf256.gf_mul(b, c)) == gf256.gf_mul(
                gf256.gf_mul(a, b), c
            )
            # distributivity over XOR (field addition)
            assert gf256.gf_mul(a, b ^ c) == gf256.gf_mul(a, b) ^ gf256.gf_mul(a, c)

    def test_inverse(self):
        for a in range(1, 256):
            assert gf256.gf_mul(a, gf256.gf_inv(a)) == 1
        with pytest.raises(ZeroDivisionError):
            gf256.gf_inv(0)

    def test_mul_table_matches_scalar(self):
        a = rng.integers(0, 256, 64)
        b = rng.integers(0, 256, 64)
        for x, y in zip(a, b):
            assert gf256.GF_MUL_TABLE[x, y] == gf256.gf_mul(int(x), int(y))

    def test_mat_inv_roundtrip(self):
        for k in (1, 2, 5, 16):
            m = gf256.systematic_rs_matrix(min(256, 3 * k), k)[k : 2 * k]
            # rows k..2k-1 of a systematic RS matrix are invertible
            inv = gf256.gf_mat_inv(m)
            assert np.array_equal(
                gf256.gf_matmul(m, inv), np.eye(k, dtype=np.uint8)
            )

    def test_mat_inv_singular(self):
        m = np.zeros((3, 3), dtype=np.uint8)
        with pytest.raises(np.linalg.LinAlgError):
            gf256.gf_mat_inv(m)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize(
    "n,f",
    [(4, 1), (7, 2), (16, 5), (128, 42)],
)
class TestErasureCoder:
    def test_roundtrip_random_erasures(self, backend, n, f):
        k = n - 2 * f
        coder = _coder(backend, n, k)
        data = rng.integers(0, 256, (k, 128)).astype(np.uint8)
        shards = coder.encode(data)
        assert shards.shape == (n, 128)
        assert np.array_equal(shards[:k], data)  # systematic
        for _ in range(3):
            survivors = np.sort(rng.choice(n, size=k, replace=False))
            rec = coder.decode([int(i) for i in survivors], shards[survivors])
            assert np.array_equal(rec, data)

    def test_worst_case_erasure(self, backend, n, f):
        """Lose ALL data shards; reconstruct from parity alone where
        possible (2f parity rows can replace up to 2f data rows)."""
        k = n - 2 * f
        coder = _coder(backend, n, k)
        data = rng.integers(0, 256, (k, 64)).astype(np.uint8)
        shards = coder.encode(data)
        lost = min(2 * f, k)
        survivors = list(range(lost, k)) + list(range(k, k + lost))
        rec = coder.decode(survivors, shards[survivors])
        assert np.array_equal(rec, data)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,f", [(4, 1), (16, 5), (128, 42), (300, 99)])
def test_backends_agree(backend, n, f):
    """Encode and decode equal the reference's numpy coder (its GF(2^16)
    one past 256 shards).  Decode also runs on rows that are no codeword,
    so that the decode matrix itself is the reference's, not only the
    data it recovers."""
    k = n - 2 * f
    coder = _coder(backend, n, k)
    ref = make_ref_coder("cpu", n, k)
    if n <= 256:
        assert np.array_equal(gf256.systematic_rs_matrix(n, k),
                              ref_gf256.systematic_rs_matrix(n, k))
    r = np.random.default_rng(n)
    data = r.integers(0, 256, (k, 256)).astype(np.uint8)
    shards = ref.encode(data)
    assert np.array_equal(coder.encode(data), shards)
    patterns = [list(range(n - k, n)), sorted(int(i) for i in r.choice(n, k, replace=False))]
    for survivors in patterns:
        assert np.array_equal(coder.decode(survivors, shards[survivors]), data)
        noise = r.integers(0, 256, (k, 256)).astype(np.uint8)
        assert np.array_equal(coder.decode(survivors, noise), ref.decode(survivors, noise))


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_matches_single(backend):
    n, f = 7, 2
    k = n - 2 * f
    coder = _coder(backend, n, k)
    ref = make_ref_coder("cpu", n, k)
    data = rng.integers(0, 256, (5, k, 128)).astype(np.uint8)
    enc = coder.encode_batch(data)
    assert np.array_equal(enc, ref.encode_batch(data))
    for b in range(5):
        assert np.array_equal(enc[b], coder.encode(data[b]))
    idx = np.stack([np.sort(rng.choice(n, k, replace=False)) for _ in range(5)])
    shards = np.stack([enc[b][idx[b]] for b in range(5)])
    dec = coder.decode_batch(idx, shards)
    for b in range(5):
        assert np.array_equal(dec[b], data[b])
    noise = rng.integers(0, 256, shards.shape).astype(np.uint8)
    assert np.array_equal(coder.decode_batch(idx, noise), ref.decode_batch(idx, noise))


def test_decode_rejects_bad_indices():
    coder = make_erasure_coder("cpu", 4, 2)
    with pytest.raises(ValueError):
        coder.decode([0], np.zeros((1, 8), dtype=np.uint8))
    with pytest.raises(ValueError):
        coder.decode([1, 1], np.zeros((2, 8), dtype=np.uint8))


class TestPayload:
    @pytest.mark.parametrize("length", [0, 1, 123, 124, 1000, 4096])
    @pytest.mark.parametrize("k", [1, 3, 43])
    def test_framing_matches_reference(self, length, k):
        """split_payload gives the reference's bytes, and each package's
        join_payload takes the other's matrix."""
        payload = bytes(np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8))
        m = split_payload(payload, k)
        want = ref_payload.split_payload(payload, k)
        assert m.dtype == want.dtype and m.shape == want.shape
        assert m.tobytes() == want.tobytes()
        assert join_payload(want) == payload == ref_payload.join_payload(m)

    def test_roundtrip(self):
        payload = bytes(rng.integers(0, 256, 1000, dtype=np.uint8))
        m = split_payload(payload, k=5)
        assert m.shape[0] == 5 and m.shape[1] % 128 == 0
        assert join_payload(m) == payload

    def test_empty_payload(self):
        m = split_payload(b"", k=3)
        assert join_payload(m) == b""

    def test_corrupt_length_rejected(self):
        m = split_payload(b"hello", k=2)
        m[0, :4] = 255
        with pytest.raises(ValueError):
            join_payload(m)

    def test_full_rbc_flow(self):
        """split -> encode -> erase -> decode -> join, every backend."""
        n, f = 7, 2
        k = n - 2 * f
        payload = bytes(rng.integers(0, 256, 4096, dtype=np.uint8))
        data = split_payload(payload, k)
        for backend in BACKENDS:
            coder = _coder(backend, n, k)
            shards = coder.encode(data)
            survivors = [1, 3, 6]  # any k of n
            rec = coder.decode(survivors, shards[survivors])
            assert join_payload(rec) == payload
