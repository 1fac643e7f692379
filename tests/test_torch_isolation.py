"""The port stands alone: no JAX, no reference package, no hidden CPU
fallback.

Importing every module of ``cleisthenes_tpu_torch`` (and chip_smoke.py,
wide_sweep.py) in a fresh interpreter, then running the host-side paths
whose imports are deferred to the call — the DKG, the ``'cpp'`` codec
over the native GF(2^8) library, the scalar share ops — must leave
``jax`` and ``cleisthenes_tpu`` out of ``sys.modules``; and on a machine
without a GPU the defaults, which put the work on the card, must raise
rather than run on the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.ops.merkle import CudaMerkle
from cleisthenes_tpu_torch.ops.rs_cuda import CudaErasureCoder
from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import cleisthenes_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke, wide_sweep
import numpy as np
from cleisthenes_tpu_torch.native import load_gf256
from cleisthenes_tpu_torch.ops import coin, dkg, tpke
from cleisthenes_tpu_torch.ops.backend import get_backend
from cleisthenes_tpu_torch.config import Config
assert {"cleisthenes_tpu_torch.ops.dkg", "cleisthenes_tpu_torch.ops.rs_cpp"} <= set(names)
assert load_gf256() is not None
crypto = get_backend(Config(n=4, crypto_backend="cpp"))
crypto.erasure.encode_batch(np.zeros((2, 2, 8), dtype=np.uint8))
pub, shares, _ = dkg.run_dkg(n=4, threshold=2, seed=1, backend="cpu")
sh = coin.CommonCoin(pub, backend="cpu").share(shares[0], b"c")
assert tpke.verify_shares(pub, coin.coin_base(b"c"), [sh], b"coin|c", backend="cpu") == [True]
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "cleisthenes_tpu" or m.startswith("cleisthenes_tpu.")
)
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20, out.stdout
    assert bad == "[]", out.stdout


def test_default_cluster_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default runs there")
    assert Config().crypto_backend == "cuda" and Config().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LockstepCluster()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaErasureCoder(7, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaMerkle()


@pytest.mark.parametrize(
    "kwargs",
    [
        {"crypto_backend": "tpu"},
        {"device": "mps"},
        {"device": "tpu"},
        {"mesh_shape": (2, 2)},
    ],
)
def test_config_refuses_what_the_port_lacks(kwargs):
    with pytest.raises(ValueError):
        Config(**kwargs)


def test_cpu_backend_needs_no_gpu():
    c = LockstepCluster(n=4, crypto_backend="cpu", key_seed=4)
    c.submit(b"host-only")
    c.run_epoch()
    assert c.committed()[0].tx_list() == [b"host-only"]
