"""Run one cell of the benchmark once and print its result line.

    python3 hbbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  It needs as many CUDA cards as the cell asks
for and never falls back to the CPU.  With ``--trace 0`` the result's
metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, taken under ``torch.profiler``.  The last lines on
standard error, and the result's last key, are the numbers compared with
the reference, each beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# JAX, its libraries and the JAX package; and the repository's scripts and
# tools that measured it.  Compared by whole top-level module name.
FORBIDDEN = ("jax", "jaxlib", "flax", "cleisthenes_tpu", "chip_smoke", "bench", "tools")


def forbidden_modules():
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def short(name: str) -> str:
    """A device op's name without its namespaces, return type and
    argument list: ``dual_pow_kernel<Plan<8, 32, 1, 4, 4, 32, 6> >``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            return name[:i]
    return name


def result_line(cell, out, trace: bool, device: dict) -> dict:
    from hbbench import check
    from hbbench.harness import load_metric

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_metric(m["name"]).read(out.run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {name: {"value": out.checks[name], "limit": check.LIMITS[name]} for name in check.NAMES}
    correct = all(out.checks[name] <= check.LIMITS[name] for name in check.NAMES)
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    prof = out.run.profile
    if trace and prof is not None:
        ops = {}
        for k, v in prof["kernels_us"].items():
            ops[short(k)] = ops.get(short(k), 0.0) + v
        for k, v in prof["copies_us"].items():
            ops["Memcpy " + k] = v
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(prof["idle_by_label_us"].items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[k, v / 1e6] for k, v in top],
                             "idle_gaps": [[k, v / 1e6] for k, v in gaps]}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches of the libraries PyTorch may build, at fixed paths in the checkout
    cache = ROOT / ".hbbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))

    from hbbench.harness import resolve, run

    cell = resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"hbbench: {args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    trace = bool(args.trace)
    out = run(cell.config, cell.mix, args.seed, args.seconds, trace, t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"hbbench: modules of JAX, the JAX package or its scripts were loaded: {bad}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    if trace:
        prof = out.run.profile
        if prof is None or prof["busy_us"] <= 0:
            print("hbbench: the profiler gave no device time in the traced window", file=sys.stderr)
            return 4
        device["busy_s"] = prof["busy_us"] / 1e6
        device["window_s"] = prof["window_us"] / 1e6
    line = result_line(cell, out, trace, device)
    print(f"hbbench: card {card_line()}", file=sys.stderr)
    for key, value in out.info.items():
        print(f"hbbench: {key} {json.dumps(value)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}={c['value']} limit={c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
