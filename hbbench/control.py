"""The benchmark's control and its planted faults, run on many seeds in one
process.

    python3 hbbench/control.py --workload <name> --fault <fault> --seeds 1,2,3 --seconds 5

Each fault breaks the timed path underneath a whole run of the cell: set-up,
warm-up, a window of ``--seconds``, the comparison with the reference.  A
sound benchmark reads ``correct`` false under every fault; ``--fault none``
reads the program as it is.  One JSON line a seed, with every compared
number.  The benchmark's own runs never plant a fault.

- ``flip_tx`` (the control: it breaks validity, a committed transaction
  byte for byte as submitted): the decryption of each epoch's first
  non-empty proposal comes back with its last byte flipped.
- ``flip_coin``: each epoch's first coin toss comes back inverted.
- ``drop_half``: each epoch commits half of every proposer's transactions.
- ``stale_epoch``: every second epoch returns at once, its state unchanged.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def flip_tx(cluster) -> None:
    combine = cluster.tpke.combine
    done = set()

    def w(ct, shares):
        pt = combine(ct, shares)
        if cluster.epoch not in done and len(pt) > 8:
            done.add(cluster.epoch)
            pt = pt[:-1] + bytes([pt[-1] ^ 1])
        return pt

    cluster.tpke.combine = w


def flip_coin(cluster) -> None:
    toss = cluster.coin.toss
    done = set()

    def w(coin_id, shares):
        bit = toss(coin_id, shares)
        if cluster.epoch not in done:
            done.add(cluster.epoch)
            bit = not bit
        return bit

    cluster.coin.toss = w


def drop_half(cluster) -> None:
    from cleisthenes_tpu_torch.core.batch import Batch

    run_epoch = cluster.run_epoch

    def w():
        stats = run_epoch()
        last = cluster.committed_batches[-1]
        cluster.committed_batches[-1] = Batch(contributions={
            p: txs[: len(txs) // 2] for p, txs in last.contributions.items()
        })
        return stats

    cluster.run_epoch = w


def stale_epoch(cluster) -> None:
    run_epoch = cluster.run_epoch
    state = {"calls": 0, "last": None}

    def w():
        state["calls"] += 1
        if state["calls"] % 2 == 0 and state["last"] is not None:
            return dict(state["last"])
        state["last"] = run_epoch()
        return state["last"]

    cluster.run_epoch = w


FAULTS = {"none": None, "flip_tx": flip_tx, "flip_coin": flip_coin,
          "drop_half": drop_half, "stale_epoch": stale_epoch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS), required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from hbbench import check
    from hbbench.harness import resolve, run

    cell = resolve(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    fault = FAULTS[args.fault]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = run(cell.config, cell.mix, seed, args.seconds, False,
                  faults=() if fault is None else (fault,), t_start=T_START if i == 0 else None)
        correct = all(out.checks[k] <= check.LIMITS[k] for k in check.NAMES)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": correct, "attempted": out.attempted, "failed": out.failed,
                          "setup_s": out.run.setup_s, "epochs": out.info["epochs_in_window"],
                          "check_s": out.info["check_s"], "checks": out.checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
