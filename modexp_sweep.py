#!/usr/bin/env python3
"""Time the 256-bit generic pow (K7), comb (K9) and dual pow (K8) under
other plans.

``cleisthenes_tpu_torch/csrc/modexp.cu`` ships two plans of K7
(``PowSmallPlan`` for a call that fits one wave of its blocks, ``PowPlan``
for a longer one: team of T lanes a row, a table of up to 2^W entries,
THREADS lanes a block), two of K8 (``DualSmallPlan``, ``DualPlan``: team,
a 2^WD-entry table per base, block) and one of K9 (``CombPlan``: the
chain's team T, the comb's width W, the blocks' lanes).  This script
compiles the same kernel templates under the other plans of
``POW_VARIANTS`` (each with and without K7's row ordering),
``DUAL_VARIANTS`` and ``COMB_VARIANTS`` (a generated source that includes
``modexp.cu`` and adds a C entry point per plan; one ``nvcc`` for each
kernel's variants, all started together), holds every variant byte for
byte against the shipped kernel and the shipped kernel against Python's
``pow`` on a sample, and times each (CUDA events around the C entry
points, median of ``REPS`` calls after a warm-up; a comb call is its two
launches, also timed one by one): K7 at the N=128 roster's DKG steps
(``chip_smoke.dkg_step_rows``: ``finalize`` 704,512 rows,
``verify_pedersen_shares`` 737,280, ``verify_dealer_shares`` 720,896) and
the decrypt-combine shape (5,504 rows of full-length exponents, the edge
rows first); K8 and K9 at both epochs' round-0 shapes
(``chip_smoke.MODEXP_SHAPES``: at N=128 a comb of 98,304 exponents over
257 bases and a dual pow of 22,016 rows; at N=512 1,572,864 exponents over
1,025 bases and 350,208 rows; half the dual-pow rows Lagrange rows).

With ``--parent DIR`` it also builds ``DIR``'s
``cleisthenes_tpu_torch/csrc/modexp.cu`` (an earlier tree unpacked from
``git archive``; its ``pow_fused`` is called with or without the
workspace argument, as its source declares it; its comb table as wide as
its ``CombPlan`` says) and times its kernels beside these, byte for byte
against the shipped ones.  ``--kernels pow`` (or ``dual``, ``comb``, a
comma list) times only those.

It prints ptxas's registers, stack and spills for every variant, one line
per (variant, shape) and last a JSON object of all of them; it exits 1 if
any variant disagrees.  Run from the repository root on a machine with one
CUDA card and ``nvcc``:

    python3 modexp_sweep.py [--parent DIR] [--kernels pow,dual,comb] [--reps N]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import random
import re
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

# (tag, T, W, THREADS, MIN_BLOCKS) of K7's PowPlan and PowSmallPlan; each
# is built with the row ordering ("_o") and without it ("_u")
POW_VARIANTS = (
    ("t1_w4_b64", 1, 4, 64, 6),
    ("t1_w4_b128", 1, 4, 128, 3),
    ("t1_w3_b64", 1, 3, 64, 8),
    ("t1_w5_b64", 1, 5, 64, 3),
    ("t1_w4_b32", 1, 4, 32, 12),
    ("t2_w4_b32", 2, 4, 32, 16),
    ("t4_w4_b32", 4, 4, 32, 16),
    ("t8_w4_b32", 8, 4, 32, 16),
)
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
    if kind == "pow":
        for tag, t, w, threads, minb in POW_VARIANTS:
            plan = f"Plan<8, 32, {t}, {w}, {w}, {threads}, {minb}>"
            for suffix, order in (("o", "true"), ("u", "false")):
                lines += [
                    f'extern "C" int sweep_pow_{tag}_{suffix}(const void* b, const void* e,',
                    "    void* o, void* ws, long long n, const void* s, void* st) {",
                    "  int dev = 0;",
                    "  if (cudaGetDevice(&dev) != cudaSuccess) return 1;",
                    f"  return launch_pow<{plan}>(b, e, o, ws, n, s, st, dev, {order});",
                    "}",
                ]
    elif kind == "dual":
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


def parent_comb_width(parent) -> int:
    """The comb width of the parent's ``CombPlan`` (4 in the first design,
    which declared none)."""
    src = (Path(parent) / "cleisthenes_tpu_torch" / "csrc" / "modexp.cu").read_text()
    m = re.search(r"using CombPlan = Plan<\d+, \d+, \d+, (\d+),", src)
    return int(m.group(1)) if m else 4


def parent_pow_takes_ws(parent) -> bool:
    """Whether the parent's ``pow_fused`` takes the workspace argument
    (since the row-ordered design)."""
    src = (Path(parent) / "cleisthenes_tpu_torch" / "csrc" / "modexp.cu").read_text()
    return "pow_fused(const void* base, const void* exp, void* out, void* ws" in src


def build(parent, kinds) -> dict:
    """Compile the variants' libraries of ``kinds`` (and the parent's
    modexp.cu), in parallel; {"pow" | "dual" | "comb" | "parent": CDLL},
    printing ptxas's lines."""
    import ctypes as c

    from cleisthenes_tpu_torch.csrc.build import BUILD_DIR, NVCC_FLAGS, SIGNATURES, _CSRC, nvcc_path

    work = BUILD_DIR / "modexp_sweep"
    work.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kind in kinds:
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
        if kind == "pow":
            for tag, *_ in POW_VARIANTS:
                for suffix in ("o", "u"):
                    getattr(cdll, f"sweep_pow_{tag}_{suffix}").argtypes = sig["pow_fused"]
        elif kind == "dual":
            for tag, *_ in DUAL_VARIANTS:
                getattr(cdll, f"sweep_dual_{tag}").argtypes = sig["dual_pow_fused"]
        elif kind == "comb":
            for tag, *_ in COMB_VARIANTS:
                getattr(cdll, f"sweep_table_{tag}").argtypes = sig["comb_table"]
                getattr(cdll, f"sweep_apply_{tag}").argtypes = sig["comb_apply"]
        else:
            for fn in ("dual_pow_fused", "comb_table", "comb_apply", "pow_fused"):
                getattr(cdll, fn).argtypes = sig[fn]
            if not parent_pow_takes_ws(parent):
                cdll.pow_fused.argtypes = [c.c_void_p] * 3 + [c.c_longlong] + [c.c_void_p] * 2
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
    ap.add_argument("--kernels", default="pow,dual,comb",
                    help="a comma list of the kernels to time: pow, dual, comb")
    ap.add_argument("--reps", type=int, default=REPS, help="timed calls a median")
    args = ap.parse_args()
    kinds = [k for k in ("pow", "dual", "comb") if k in args.kernels.split(",")]
    if not torch.cuda.is_available():
        print("modexp_sweep: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    shipped = load("modexp")
    libs = build(args.parent, kinds)
    stream = torch.cuda.current_stream().cuda_stream
    spec = mx.mont_spec(P)
    sw = spec.words.ctypes.data
    rnd = random.Random(2026)

    def put(a):
        return torch.from_numpy(np.array(a)).to(dev)

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

    def held_and_timed(shape, kind, cands, out, want):
        """Run the shipped candidate, hold it to ``want`` on a sample and
        every candidate to it byte for byte, time each; records."""
        if cands[0][1]() != 0:
            raise RuntimeError(f"shipped {kind} failed at {shape}")
        torch.cuda.synchronize()
        ref = out.clone()
        res = ref.cpu().numpy()
        n = res.shape[0]
        idx = sorted(set(range(min(n, 5))) | set(rnd.sample(range(n), min(n, 24))))
        ok = all(int.from_bytes(res[i].tobytes(), "little") == want(i) for i in idx)
        recs = []
        for tag, fn in cands:
            out.zero_()
            rc = fn()
            torch.cuda.synchronize()
            rec = {"shape": shape, "kind": kind, "rows": n, "variant": tag, "rc": rc,
                   "equal": rc == 0 and ok and torch.equal(out, ref)}
            rec["ms"] = cs.time_ms(torch, fn, args.reps) if rc == 0 else None
            for part, part_fn in getattr(fn, "parts", {}).items():
                rec[part] = cs.time_ms(torch, part_fn, args.reps) if rc == 0 else None
            print("sweep " + json.dumps(rec), flush=True)
            recs.append(rec)
        return recs

    if "pow" in kinds:
        gen = np.random.default_rng(2026)
        shapes = {step: cs.dkg_step_rows(np, gen, P, 128, 43, step)
                  for step in ("finalize", "verify_pedersen_shares", "verify_dealer_shares")}
        q = (P - 1) // 2
        edge_b, edge_e = [0, 1, P - 1, P + 5, 2**264 - 1], [0, 1, q, 2**256 - 1, 3]
        shapes["decrypt_combine"] = (
            ints_to_bytes33(edge_b + [rnd.randrange(P) for _ in range(5499)]),
            exps_to_bytes(edge_e + [rnd.randrange(q) for _ in range(5499)]))
        # the shipped kernel first (the reference), then the parent first
        # and last, the change's plans between
        parent = ["parent"] if "parent" in libs else []
        order = ["shipped"] + parent + ["shipped"] + [
            f"{tag}_{o}" for tag, *_ in POW_VARIANTS for o in ("o", "u")] + parent
        for shape, (b_np, e_np) in shapes.items():
            base, ex = put(b_np), put(e_np)
            n = base.shape[0]
            out = torch.empty((n, 33), dtype=torch.uint8, device=dev)
            ws = torch.empty(n + mx.POW_SORT_WORDS, dtype=torch.int32, device=dev)

            def pow_runner(fn, with_ws=True):
                if with_ws:
                    return lambda: fn(base.data_ptr(), ex.data_ptr(), out.data_ptr(),
                                      ws.data_ptr(), n, sw, stream)
                return lambda: fn(base.data_ptr(), ex.data_ptr(), out.data_ptr(), n, sw, stream)
            runners = {"shipped": pow_runner(shipped.pow_fused)}
            if "parent" in libs:
                runners["parent"] = pow_runner(libs["parent"].pow_fused,
                                               parent_pow_takes_ws(args.parent))
            for tag, *_ in POW_VARIANTS:
                for o in ("o", "u"):
                    runners[f"{tag}_{o}"] = pow_runner(getattr(libs["pow"], f"sweep_pow_{tag}_{o}"))
            cands = [(t, runners[t]) for t in order]

            def want(i, b_np=b_np, e_np=e_np):
                return pow(int.from_bytes(b_np[i].tobytes(), "little"),
                           int.from_bytes(e_np[i].tobytes(), "big"), P)
            results += held_and_timed(shape, "pow", cands, out, want)

    for shape, (n_g, n_b, g_b, n_dual) in cs.MODEXP_SHAPES.items():
        for kind in [k for k in ("comb", "dual") if k in kinds]:
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
                                                        parent_comb_width(args.parent),
                                                        bases, ex, rows, out)))

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
            results += held_and_timed(shape, kind, cands, out, want)
    print(json.dumps({"sweep": results}))
    return 0 if all(r["equal"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
