"""The port stands alone: no JAX, no reference package, no hidden CPU
fallback.

Importing every module of ``cleisthenes_tpu_torch`` (and chip_smoke.py,
wide_sweep.py) in a fresh interpreter, then running the host-side paths
whose imports are deferred to the call — the DKG, the ``'cpp'`` codec
over the native GF(2^8) library, the scalar share ops, one epoch of an
N=4 ``SimulatedCluster`` on ``device='cpu'``, an equivocator under a
wire coalition, lanes with the mempool and the ingress plane — must leave ``jax`` and
``cleisthenes_tpu`` out of ``sys.modules``; and on a machine without a
GPU the defaults, which put the work on the card, must raise rather than
run on the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.ops.merkle import CudaMerkle
from cleisthenes_tpu_torch.ops.rs_cuda import CudaErasureCoder
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster
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
# the asynchronous plane's modules, and one N=4 epoch on the card's path
# (the kernels' plain versions)
plane = {
    "utils." + m
    for m in (
        "lockcheck", "determinism", "memo", "log", "metrics", "trace", "watchdog"
    )
} | {"core." + m for m in ("queue", "request", "member", "ledger")} | {
    "transport." + m for m in ("message", "base", "wan", "channel", "broadcast")
} | {
    "protocol." + m for m in ("echobank", "votebank", "hub", "rbc", "bba", "acs", "reconfig",
                              "honeybadger", "router", "attest", "cluster")
}
assert len(plane) == 27 and {"cleisthenes_tpu_torch." + m for m in plane} <= set(names)
robust = {"core.merge", "core.mempool", "utils.adversary", "protocol.byzantine",
          "transport.ingress"}
assert {"cleisthenes_tpu_torch." + m for m in robust} <= set(names)
from cleisthenes_tpu_torch.protocol import SimulatedCluster
cluster = SimulatedCluster(n=4, batch_size=8, device="cpu", key_seed=2)
for i in range(8):
    cluster.submit(b"iso-%d" % i)
for hb in cluster.nodes.values():
    hb.start_epoch()
cluster.net.run()
assert cluster.assert_agreement() >= 1 and cluster.pending() == 0
# the robustness planes: an equivocator (its second proposal on the
# kernels' plain versions) under a wire coalition, then lanes, the
# mempool and the ingress plane on the host backend
from cleisthenes_tpu_torch.protocol import make_behavior
from cleisthenes_tpu_torch.utils.adversary import Coalition
liar = make_behavior("equivocator", seed=1)
byz = SimulatedCluster(n=4, batch_size=8, device="cpu", key_seed=2,
                       behaviors={"node003": liar})
byz.fault_filter = Coalition(["node003"], seed=1).drop(0.1).filter
for i in range(6):
    byz.submit(b"byz-%d" % i, node_id=byz.ids[i % 3])
byz.run_until_drained(skip=("node003",))
assert byz.assert_agreement(skip=("node003",)) >= 1 and liar.rewrites > 0
lanes = SimulatedCluster(
    config=Config(n=4, batch_size=8, lanes=2, mempool_capacity=16,
                  crypto_backend="cpu"),
    key_seed=2,
)
gate = lanes.ingress()
from cleisthenes_tpu_torch.transport.message import IngressStatus
for i in range(6):
    ack = gate.submit("c0", i, 5, b"ing-%d" % i)
    assert IngressStatus(ack.status) is IngressStatus.OK
lanes.run_until_drained()
assert lanes.assert_agreement() >= 1
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
    assert int(count) >= 52, out.stdout
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


def test_default_simulated_cluster_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimulatedCluster()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimulatedCluster(config=Config(n=4))


@pytest.mark.parametrize(
    "kwargs",
    [
        {"crypto_backend": "tpu"},
        {"device": "mps"},
        {"device": "tpu"},
    ],
)
def test_config_refuses_what_the_port_lacks(kwargs):
    with pytest.raises(ValueError):
        Config(**kwargs)


@pytest.mark.parametrize("shape", [(0, 2), (2,), (True, True)])
def test_config_takes_a_mesh_shape_and_refuses_bad_ones(shape):
    """Config.mesh_shape is the reference's knob (validate_mesh_shape):
    a (v, l) of positive ints is taken, anything else refused."""
    assert Config(mesh_shape=[2, 2]).mesh_shape == (2, 2)
    with pytest.raises(ValueError):
        Config(mesh_shape=shape)


def test_cpu_backend_needs_no_gpu():
    c = LockstepCluster(n=4, crypto_backend="cpu", key_seed=4)
    c.submit(b"host-only")
    c.run_epoch()
    assert c.committed()[0].tx_list() == [b"host-only"]
