#!/usr/bin/env python3
"""Time the 256-bit comb (K9) and dual pow (K8) under other plans.

``cleisthenes_tpu_torch/csrc/modexp.cu`` ships two plans of K8
(``DualSmallPlan`` for a call that fits one wave of its blocks,
``DualPlan`` for a longer one: team of T lanes a row, a 2^WD-entry table
per base, THREADS lanes a block) and one of K9 (``CombPlan``: the chain's
team T, the comb's width W, the blocks' lanes).  This script
compiles the same kernel templates under the other plans of
``DUAL_VARIANTS`` and ``COMB_VARIANTS`` (a generated source that includes
``modexp.cu`` and adds a C entry point per plan; one ``nvcc`` for each
kernel's variants, all started together), holds every variant byte for
byte against the shipped kernel and the shipped kernel against Python's
``pow`` on a sample, and times each at both epochs' round-0 shapes
(``chip_smoke.MODEXP_SHAPES``: at N=128 a comb of 98,304 exponents over
257 bases and a dual pow of 22,016 rows; at N=512 1,572,864 exponents over
1,025 bases and 350,208 rows; half the dual-pow rows Lagrange rows), with
``chip_smoke.py``'s rows and timer (CUDA events around the C entry points,
median of ``REPS`` calls after a warm-up; a comb call is its two
launches, also timed one by one).

With ``--parent DIR`` it also builds ``DIR``'s
``cleisthenes_tpu_torch/csrc/modexp.cu`` (an earlier tree unpacked from
``git archive``, whose entry points take the same arguments; its comb
table is 4 bits wide) and times its kernels beside these, byte for byte
against the shipped ones.

It prints ptxas's registers, stack and spills for every variant, one line
per (variant, shape) and last a JSON object of all of them; it exits 1 if
any variant disagrees.  Run from the repository root on a machine with one
CUDA card and ``nvcc``:

    python3 modexp_sweep.py [--parent DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import random
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

# (tag, T, WD, THREADS, MIN_BLOCKS) of K8's DualPlan and DualSmallPlan
DUAL_VARIANTS = (
    ("t1_wd3_b64", 1, 3, 64, 6),
    ("t1_wd4_b32", 1, 4, 32, 6),
    ("t1_wd3_b128", 1, 3, 128, 3),
    ("t1_wd4_b64", 1, 4, 64, 3),
    ("t2_wd4", 2, 4, 128, 3),
)
# (tag, T, W, THREADS, MIN_BLOCKS) of K9's CombPlan: the chain's team, the
# comb's width and the blocks' lanes
COMB_VARIANTS = (
    ("t1_w7", 1, 7, 128, 4),
    ("t2_w7", 2, 7, 128, 4),
    ("t8_w7", 8, 7, 128, 4),
    ("t4_w6", 4, 6, 128, 4),
    ("t4_w8", 4, 8, 128, 4),
    ("t4_w7_b256", 4, 7, 256, 2),
)
REPS = 10


def _source(kind: str) -> str:
    lines = ['#include "modexp.cu"', ""]
    if kind == "dual":
        for tag, t, wd, threads, minb in DUAL_VARIANTS:
            plan = f"Plan<8, 32, {t}, {wd}, {wd}, {threads}, {minb}>"
            lines += [
                f'extern "C" int sweep_dual_{tag}(const void* u1, const void* e1,',
                "    const void* u2, const void* e2, void* o, long long n, const void* s,",
                "    void* st) {",
                f"  return launch_dual<{plan}>(u1, e1, u2, e2, o, n, s, st);",
                "}",
            ]
    else:
        for tag, t, w, threads, minb in COMB_VARIANTS:
            plan = f"Plan<8, 32, {t}, {w}, {w}, {threads}, {minb}>"
            lines += [
                f'extern "C" int sweep_table_{tag}(const void* b, void* t, long long n,',
                "    const void* s, void* st) {",
                f"  return launch_comb_table<{plan}>(b, t, n, s, st);",
                "}",
                f'extern "C" int sweep_apply_{tag}(const void* e, const void* r, const void* t,',
                "    void* o, long long n, const void* s, void* st) {",
                f"  return launch_comb_apply<{plan}>(e, r, t, o, n, s, st);",
                "}",
            ]
    return "\n".join(lines) + "\n"


def build(parent) -> dict:
    """Compile the variants' libraries (and the parent's modexp.cu), in
    parallel; {"dual" | "comb" | "parent": CDLL}, printing ptxas's lines."""
    from cleisthenes_tpu_torch.csrc.build import BUILD_DIR, NVCC_FLAGS, SIGNATURES, _CSRC, nvcc_path

    work = BUILD_DIR / "modexp_sweep"
    work.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kind in ("dual", "comb"):
        src = work / f"sweep_{kind}.cu"
        src.write_text(_source(kind))
        jobs[kind] = (work / f"libsweep_{kind}.so", src, ["-I", str(_CSRC)])
    if parent:
        jobs["parent"] = (work / "libparent_modexp.so",
                          Path(parent) / "cleisthenes_tpu_torch" / "csrc" / "modexp.cu", [])
    procs = {
        kind: subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", *inc, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for kind, (lib, src, inc) in jobs.items()
    }
    sig = SIGNATURES["modexp"]
    libs = {}
    for kind, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {kind} sweep:\n{log}")
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas sweep_{kind}: {line.strip()}", flush=True)
        cdll = ctypes.CDLL(str(jobs[kind][0]))
        if kind == "dual":
            for tag, *_ in DUAL_VARIANTS:
                getattr(cdll, f"sweep_dual_{tag}").argtypes = sig["dual_pow_fused"]
        elif kind == "comb":
            for tag, *_ in COMB_VARIANTS:
                getattr(cdll, f"sweep_table_{tag}").argtypes = sig["comb_table"]
                getattr(cdll, f"sweep_apply_{tag}").argtypes = sig["comb_apply"]
        else:
            for fn in ("dual_pow_fused", "comb_table", "comb_apply"):
                getattr(cdll, fn).argtypes = sig[fn]
        libs[kind] = cdll
    return libs


def main() -> int:
    import numpy as np
    import torch

    from cleisthenes_tpu_torch.csrc.build import load
    from cleisthenes_tpu_torch.ops import modexp_cuda as mx
    from cleisthenes_tpu_torch.ops.modmath import P, exps_to_bytes, ints_to_bytes33

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an earlier tree whose modexp.cu is timed beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("modexp_sweep: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    shipped = load("modexp")
    libs = build(args.parent)
    stream = torch.cuda.current_stream().cuda_stream
    spec = mx.mont_spec(P)
    sw = spec.words.ctypes.data
    rnd = random.Random(2026)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def comb_runner(lib, table_fn, apply_fn, width, bases, ex, rows, out):
        table = torch.empty((bases.shape[0], -(-256 // width), 1 << width, 8),
                            dtype=torch.int32, device=dev)

        def build_table():
            return getattr(lib, table_fn)(bases.data_ptr(), table.data_ptr(), bases.shape[0], sw, stream)

        def apply():
            return getattr(lib, apply_fn)(ex.data_ptr(), rows.data_ptr(), table.data_ptr(),
                                          out.data_ptr(), ex.shape[0], sw, stream)

        def run():
            return build_table() or apply()
        run.parts = {"table_ms": build_table, "apply_ms": apply}
        return run

    results = []
    for shape, (n_g, n_b, g_b, n_dual) in cs.MODEXP_SHAPES.items():
        for kind in ("comb", "dual"):
            if kind == "comb":
                bases_i, exps_i, rows_i = cs.comb_inputs(rnd, P, n_g, n_b, g_b)
                bases = put(ints_to_bytes33([b % P for b in bases_i]))
                ex, rows = put(exps_to_bytes(exps_i)), put(np.array(rows_i, np.int32))
                out = torch.empty((ex.shape[0], 33), dtype=torch.uint8, device=dev)
                cands = [("shipped", comb_runner(shipped, "comb_table", "comb_apply",
                                                 mx.COMB_WIDTH, bases, ex, rows, out))]
                cands += [(tag, comb_runner(libs["comb"], f"sweep_table_{tag}", f"sweep_apply_{tag}",
                                            w, bases, ex, rows, out))
                          for tag, _t, w, *_ in COMB_VARIANTS]
                if "parent" in libs:
                    cands.append(("parent", comb_runner(libs["parent"], "comb_table", "comb_apply",
                                                        4, bases, ex, rows, out)))

                def want(i):
                    return pow(bases_i[rows_i[i]], exps_i[i], P)
            else:
                u1, e1, u2, e2 = cs.dual_inputs(rnd, P, n_dual)
                ins = [put(ints_to_bytes33(u1)), put(exps_to_bytes(e1)),
                       put(ints_to_bytes33(u2)), put(exps_to_bytes(e2))]
                ptrs = [t.data_ptr() for t in ins]
                out = torch.empty((n_dual, 33), dtype=torch.uint8, device=dev)

                def runner(fn):
                    return lambda: fn(*ptrs, out.data_ptr(), n_dual, sw, stream)
                cands = [("shipped", runner(shipped.dual_pow_fused))]
                cands += [(tag, runner(getattr(libs["dual"], f"sweep_dual_{tag}")))
                          for tag, *_ in DUAL_VARIANTS]
                if "parent" in libs:
                    cands.append(("parent", runner(libs["parent"].dual_pow_fused)))

                def want(i):
                    return pow(u1[i], e1[i], P) * pow(u2[i], e2[i], P) % P
            if cands[0][1]() != 0:
                raise RuntimeError(f"shipped {kind} failed at {shape}")
            torch.cuda.synchronize()
            ref = out.clone()
            res = ref.cpu().numpy()
            n = res.shape[0]
            idx = list(range(5)) + rnd.sample(range(n), 24)
            ok = all(int.from_bytes(res[i].tobytes(), "little") == want(i) for i in idx)
            for tag, fn in cands:
                out.zero_()
                rc = fn()
                torch.cuda.synchronize()
                rec = {"shape": shape, "kind": kind, "rows": n, "variant": tag, "rc": rc,
                       "equal": rc == 0 and ok and torch.equal(out, ref)}
                rec["ms"] = cs.time_ms(torch, fn, REPS) if rc == 0 else None
                for part, part_fn in getattr(fn, "parts", {}).items():
                    rec[part] = cs.time_ms(torch, part_fn, REPS) if rc == 0 else None
                print("sweep " + json.dumps(rec), flush=True)
                results.append(rec)
    print(json.dumps({"sweep": results}))
    return 0 if all(r["equal"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
