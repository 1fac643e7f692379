"""The benchmark's reference against the port's ``"cpu"`` arm, through the
harness's own functions, and the faults that must read not correct.

At N=4 (k=2) and N=7 (k=3) a 250-byte transaction moves a proposal's
shard width past 128 bytes, and the port's lockstep epoch fails when the
proposals of one epoch differ in width (PERF.md, open questions).  The
closed loop keeps every proposal full, so it runs the published 250
bytes; the open loop runs 16-byte transactions, which keep every proposal
of these rosters inside one width.
"""

import numpy as np
import pytest

from hbbench import check, harness
from hbbench.control import FAULTS

SEED = 2**31 + 4099  # past 32 signed bits, as the benchmark's seeds are
GROUP = harness.load_json("configs", "hb-n128-f42")["group"]


# a 384-bit safe prime (p = 2q + 1, g = 4): a configuration names its group
GROUP384 = {"bits": 384, "g": 4, "p": "F7E12F10702F5E910CBEC741E84E2608D29D655C81BF7BF0"
            "93B38ED4267537C9249C8FE3A20A0C68153E6DAA5F9A23F3"}


def cpu_run(n, mix_name, faults=(), seconds=0.5, seed=SEED, key_seed=77, group=GROUP):
    mix = harness.load_json("traffic", mix_name)
    closed = mix["loop"] == "closed"
    cfg = {"n": n, "f": (n - 1) // 3, "batch_size": 64, "key_seed": key_seed, "group": group, "tx_bytes": 250 if closed else 16}
    if not closed:
        mix = dict(mix, rate_tx_per_s=800, warmup_txs_per_epoch=12)
    return harness.run(cfg, mix, seed, seconds, False, backend="cpu", device="cpu", faults=faults)


@pytest.mark.parametrize("key_seed", [77, 2**31 + 3])
@pytest.mark.parametrize("mix_name", ["backlog", "light"])
@pytest.mark.parametrize("n", [4, 7])
def test_reference_agrees_with_the_cpu_arm(n, mix_name, key_seed):
    out = cpu_run(n, mix_name, key_seed=key_seed)
    assert out.checks == dict.fromkeys(check.NAMES, 0)
    assert out.attempted > 0 and out.failed == 0
    assert out.info["epochs_in_window"] > 0 and out.info["rbc_checked_epochs"]
    if mix_name == "light":
        assert len(out.run.latencies_ms) == out.attempted
        assert min(out.run.latencies_ms) > 0


def test_the_group_is_the_configuration_s():
    out = cpu_run(4, "backlog", group=GROUP384)
    assert out.checks == dict.fromkeys(check.NAMES, 0) and out.info["rbc_checked_epochs"]


@pytest.mark.parametrize("fault", ["flip_tx", "flip_coin", "drop_half", "stale_epoch"])
@pytest.mark.parametrize("n", [4, 7])
def test_a_planted_fault_reads_not_correct(n, fault):
    out = cpu_run(n, "backlog", faults=(FAULTS[fault],))
    assert any(out.checks[k] > check.LIMITS[k] for k in check.NAMES), out.checks


def test_the_control_fails_the_open_loop_too():
    out = cpu_run(4, "light", faults=(FAULTS["flip_tx"],))
    assert out.checks["ledger_wrong"] > 0 and out.checks["plaintexts"] > 0


@pytest.fixture
def evidence(monkeypatch):
    """A sound run's evidence, held for tampering."""
    seen = {}
    real = check.compare

    def spy(ev):
        seen["ev"] = ev
        return real(ev)

    monkeypatch.setattr(check, "compare", spy)
    cpu_run(7, "backlog")
    return seen["ev"]


def test_one_flipped_shard_byte_root_or_delivery_fails(evidence):
    e, slot = next(iter(evidence.rbc.items()))
    full = slot["full"]
    slot["full"] = full.copy()
    slot["full"][0, -1, 0] ^= 1
    assert check.compare(evidence)[0]["rbc_shards"] == 1
    slot["full"] = full
    slot["roots"] = [bytes(32)] + list(slot["roots"][1:])
    assert check.compare(evidence)[0]["rbc_roots"] == 1
    dec = np.array(slot["decoded"])
    dec[2, 0, 5] ^= 1
    slot["decoded"] = dec
    assert check.compare(evidence)[0]["rbc_decoded"] == 1


def test_a_transaction_committed_twice_fails(evidence):
    batch = evidence.committed[-1]
    evidence.committed[-1] = batch + batch[:1]
    checks = check.compare(evidence)[0]
    assert checks["ledger_duplicate"] == 1 and checks["ledger_wrong"] == 1


def test_one_flipped_coin_or_key_fails(evidence):
    e, tossed = next((e, t) for e, t in evidence.tosses.items() if t)
    cid = next(iter(tossed))
    tossed[cid] = not tossed[cid]
    assert check.compare(evidence)[0]["coin_tosses"] == 1
    tossed[cid] = not tossed[cid]
    master, vks, shares = evidence.port_keys["coin"]
    evidence.port_keys["coin"] = (master, vks, dict(shares, node000=shares["node000"] + 1))
    assert check.compare(evidence)[0]["keys"] == 1


def test_a_wide_group_spreads_its_powers_over_workers():
    import random

    from hbbench.reference import threshold

    p384 = int(GROUP384["p"], 16)
    r = random.Random(3)
    pairs = [(r.randrange(p384), r.randrange(p384)) for _ in range(201)]
    assert check.workers_for(threshold.Group(p=p384, g=4)) >= 1
    assert check.workers_for(threshold.Group(p=(1 << 255) - 19, g=4)) == 1
    assert threshold.pows(pairs, p384, 4) == [pow(b, e, p384) for b, e in pairs]
