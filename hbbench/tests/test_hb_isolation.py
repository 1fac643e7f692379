"""What the harness loads, and how it refuses to run without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def cuda_card():
    """Skips the test without a CUDA card; decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the cell itself on the card")
    return torch.device("cuda", 0)

REHEARSAL = """
import sys
sys.path.insert(0, {root!r})
from hbbench import harness
import hbbench.control, hbbench.run, hbbench.trace, hbbench.yardstick, hbbench.readers
for name in {mixes!r}:
    mix = harness.load_json("traffic", name)
    cfg = {{"n": 4, "f": 1, "batch_size": 64, "key_seed": 77, "group": harness.load_json("configs", "hb-n64-f21")["group"], "tx_bytes": 250 if mix["loop"] == "closed" else 16}}
    if mix["loop"] == "open":
        mix = dict(mix, rate_tx_per_s=800, warmup_txs_per_epoch=12)
    out = harness.run(cfg, mix, 7, 0.3, True, backend="cpu", device="cpu")
    assert not any(out.checks.values()), out.checks
for m in harness.load_manifest()["end_to_end"] + harness.load_manifest()["per_layer"]:
    harness.load_metric(m["name"])
print(sys.modules["hbbench.run"].forbidden_modules())
"""


def test_a_rehearsal_of_each_mix_loads_no_jax_nor_the_jax_package():
    mixes = sorted(p.stem for p in (ROOT / "hbbench" / "traffic").glob("*.json"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", REHEARSAL.format(root=str(ROOT), mixes=mixes)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from hbbench import run

    monkeypatch.setitem(sys.modules, "cleisthenes_tpu_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "benchmarks.x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cleisthenes_tpu.ops", sys)
    assert run.forbidden_modules() == ["cleisthenes_tpu.ops"]


def test_no_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: this checks the refusal without one")
    out = subprocess.run([sys.executable, "hbbench/run.py", "--workload", "n128-backlog",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout.strip().splitlines()[-1] if out.stdout.strip() else "")


def test_the_control_on_the_card(cuda_card):
    """The control at the cell's own size: correct must read false."""
    out = subprocess.run([sys.executable, "hbbench/control.py", "--workload", "n128-backlog",
                          "--fault", "flip_tx", "--seeds", "2147483999", "--seconds", "2"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is False


# RFC 3526's 2048-bit MODP group 14: K12's 264-byte family
MODP14 = (
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF"
)


def test_a_traced_run_over_modp14_bounds_both_wide_kernels(cuda_card):
    """K12 on the card: a traced window at N=4 over the 2048-bit group
    fills both wide bounds, and every check reads 0."""
    from hbbench import harness

    cfg = {"n": 4, "f": 1, "batch_size": 64, "key_seed": 77, "tx_bytes": 250,
           "group": {"bits": 2048, "p": MODP14, "g": 4}}
    out = harness.run(cfg, harness.load_json("traffic", "backlog"), 2147483999, 0.3, True)
    assert not any(out.checks.values()), out.checks
    assert out.run.wide_pow_bound_ms > 0 and out.run.wide_dual_pow_bound_ms > 0
    assert out.run.dual_pow_bound_ms is None
    for name in ("wide_pow_roofline", "wide_dual_pow_roofline"):
        assert 0 < harness.load_metric(name).read(out.run) < 100
