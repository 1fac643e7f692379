#!/usr/bin/env python3
"""Time K4 (``sha256_rows``) and K10 (``mont_mul``) beside an earlier
tree's kernels of the same C entry points, in one process on one card.

With ``--parent DIR`` (an earlier tree, e.g. a ``git archive`` in a
git-ignored directory) it compiles ``DIR``'s
``cleisthenes_tpu_torch/csrc/sha256.cu`` and ``modexp.cu`` (with its
``mont_team.cuh``) with the build's ``nvcc`` flags into
``cleisthenes_tpu_torch/_build/parent/``, loads them with the argument
types of ``csrc/build.py``'s ``SIGNATURES`` and, at each of
``chip_smoke.py``'s ``ROWS_SHAPES`` and ``MUL_SHAPES``, calls the parent's
and this tree's C entry point on the same inputs: their outputs must be
byte-equal (K10 on values below p, the parent's contract), or the script
exits 1.  Each design is timed in turns (parent, this tree, this tree,
parent) as ``chip_smoke.py`` times an entry point, through the same
Python call (an output allocated, the ctypes call on the current stream):
CUDA events around one call, median of 20 (``entry_ms``), and a replay of
20 calls captured in a CUDA graph (``alone_ms``).  K5's forest and K6's
branch verify, which build their leaves' message words with K4's
``staged_block``, are timed the same way at the N=128 and N=512 epochs'
shapes (random rows and branches).  Without ``--parent`` it times this
tree's kernels alone.

Run from the repository root on a machine with one CUDA card and
``nvcc``:

    python3 rows_sweep.py [--parent DIR]

It prints the card, one line per (shape, design, turn) and last a JSON
object of every reading.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))


def build_parent(parent: Path) -> dict:
    """{stem: CDLL} of the parent's sha256.cu and modexp.cu, built
    together."""
    from cleisthenes_tpu_torch.csrc import build

    out_dir = build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    src_dir = parent / "cleisthenes_tpu_torch" / "csrc"
    jobs = {}
    for stem in ("sha256", "modexp"):
        lib = out_dir / f"lib{stem}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(src_dir), "-o", str(lib),
               str(src_dir / f"{stem}.cu")]
        jobs[stem] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for stem, (lib, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"parent {stem}.cu:\n{log.decode(errors='replace')}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in build.SIGNATURES[stem].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs[stem] = cdll
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="an earlier tree whose kernels are timed beside")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("rows_sweep: torch sees no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cleisthenes_tpu_torch.csrc import build
    from cleisthenes_tpu_torch.ops import modexp_cuda as mx
    from cleisthenes_tpu_torch.ops.modmath import P

    print(f"card: {cs.card_line()}", flush=True)
    designs = {"change": {stem: build.load(stem) for stem in ("sha256", "modexp")}}
    if args.parent:
        designs["parent"] = build_parent(args.parent)
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(2026)
    spec = mx.mont_spec(P)

    def stream():
        return torch._C._cuda_getCurrentRawStream(dev.index)

    def sha_call(lib, msgs, prefix):
        def run():
            out = torch.empty((msgs.shape[0], 32), dtype=torch.uint8, device=dev)
            build.check(lib.sha256_rows(msgs.data_ptr(), msgs.shape[0], msgs.shape[1],
                                        -1 if prefix is None else prefix, out.data_ptr(),
                                        stream()), "sha256_rows")
            return out
        return run

    def mul_call(lib, x, y):
        def run():
            out = torch.empty_like(x)
            build.check(lib.mont_mul(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.shape[0],
                                     spec.ptr, stream()), "mont_mul")
            return out
        return run

    def forest_call(lib, shards, pad):
        b, n, L = shards.shape
        p = 1 << (n - 1).bit_length()

        def run():
            out = torch.empty((b, 2 * p - 1, 32), dtype=torch.uint8, device=dev)
            build.check(lib.merkle_forest(shards.data_ptr(), b, n, L, out.data_ptr(),
                                          pad.data_ptr(), stream()), "merkle_forest")
            return out
        return run

    def verify_call(lib, roots, leaves, br, idx):
        def run():
            ok = torch.empty((leaves.shape[0],), dtype=torch.uint8, device=dev)
            build.check(lib.merkle_verify(roots.data_ptr(), leaves.data_ptr(), leaves.shape[1],
                                          br.data_ptr(), br.shape[1], idx.data_ptr(),
                                          ok.data_ptr(), leaves.shape[0], stream()),
                        "merkle_verify")
            return ok
        return run

    cases = {}
    # the leaf path whose message words K5 and K6 build with K4's code, at the
    # N=128 and N=512 epochs' shapes (random rows and branches: the work
    # does not depend on the verdicts)
    pad = torch.zeros(32, dtype=torch.uint8, device=dev)
    for n in (128, 512):
        depth = (n - 1).bit_length()
        shards = torch.from_numpy(rng.integers(0, 256, (n, n, 128), dtype=np.uint8)).to(dev)
        cases[f"merkle_forest@n{n}"] = {
            name: forest_call(libs["sha256"], shards, pad) for name, libs in designs.items()}
        leaves = shards.reshape(n * n, 128)
        roots = torch.from_numpy(rng.integers(0, 256, (n * n, 32), dtype=np.uint8)).to(dev)
        br = torch.from_numpy(rng.integers(0, 256, (n * n, depth, 32), dtype=np.uint8)).to(dev)
        idx = torch.arange(n * n, dtype=torch.int64, device=dev) % n
        cases[f"merkle_verify@n{n}"] = {
            name: verify_call(libs["sha256"], roots, leaves, br, idx)
            for name, libs in designs.items()}
    for tag, b, L, prefix in cs.ROWS_SHAPES:
        msgs = torch.from_numpy(rng.integers(0, 256, (b, L), dtype=np.uint8)).to(dev)
        cases[f"sha256_rows@{tag}"] = {
            name: sha_call(libs["sha256"], msgs, prefix) for name, libs in designs.items()}
    for n in cs.MUL_SHAPES:
        x_np, y_np = cs.mul_rows(np, rng, P, n)
        x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
        cases[f"mont_mul@{n}"] = {
            name: mul_call(libs["modexp"], x, y) for name, libs in designs.items()}

    ok = True
    readings = {}
    order = ("parent", "change", "change", "parent") if args.parent else ("change", "change")
    for key, calls in cases.items():
        outs = {name: run() for name, run in calls.items()}
        torch.cuda.synchronize()
        equal = all(torch.equal(o, outs["change"]) for o in outs.values())
        ok &= equal
        rec = readings.setdefault(key, {"equal": equal})
        for turn, name in enumerate(order):
            entry = cs.time_ms(torch, calls[name], 20)
            alone = cs.graph_ms(torch, calls[name], 20)
            rec.setdefault(name, []).append({"turn": turn, "entry_ms": entry, "alone_ms": alone})
            print(f"rows_sweep {key} {name} turn={turn}: equal={equal} entry_ms={entry} "
                  f"alone_ms={alone}", flush=True)
    print(json.dumps(readings), flush=True)
    if not ok:
        print("rows_sweep: the designs disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
