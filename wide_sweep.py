#!/usr/bin/env python3
"""Time the wide Montgomery kernels (K12) under other team sizes and windows.

``cleisthenes_tpu_torch/csrc/modexp_wide.cu`` ships one ``Plan`` per family
(team of T lanes, pow window W, dual-pow window WD, THREADS lanes a block).
This script compiles the same kernel templates under the other plans of
``VARIANTS`` (a generated source that includes ``modexp_wide.cu`` and adds a
C entry point per plan, one ``nvcc`` a family, all started together), holds
every variant byte for byte against the shipped kernel and the shipped
kernel against Python's ``pow`` on a sample, and times each at the shapes of
``chip_smoke.py``'s ``wide_phase``, with its rows and its timer (CUDA events
around the C entry point, median of ``REPS`` calls after a warm-up):

- 384 bits: the GROUP384 epoch's round-0 wide pow (98,304 exponents over
  257 bases), its CP-verify/combine dual pow (22,016 rows, half of them
  Lagrange rows u2 = 1, e2 = 0), and ``bench.py``'s batch of 2,048;
- 768 bits: ``bench.py``'s batch of 512;
- 2048 bits (MODP-14, the 2112-bit family): ``bench.py``'s batch of 128.

It prints ptxas's registers, stack and spills for every variant, one line
per (variant, shape) and last a JSON object of all of them; it exits 1 if
any variant disagrees.  Run from the repository root on a machine with one
CUDA card and ``nvcc``:

    python3 wide_sweep.py
"""

from __future__ import annotations

import ctypes
import json
import random
import subprocess
import sys

import chip_smoke as cs

# (tag, NW, VB, T, W, WD, THREADS, MIN_BLOCKS); the shipped plans are the
# entry points wide_pow_fused / wide_dual_pow_fused themselves
VARIANTS = (
    ("t1_wd4", 12, 48, 1, 4, 4, 128, 1),
    ("t2", 12, 48, 2, 4, 3, 128, 2),
    ("t4", 12, 48, 4, 4, 4, 128, 4),
    ("t4_w5", 12, 48, 4, 5, 4, 128, 4),
    ("t8", 12, 48, 8, 4, 4, 128, 4),
    ("t8", 25, 99, 8, 5, 4, 128, 3),
    ("t16", 25, 99, 16, 5, 4, 128, 3),
    ("t32_w4", 25, 99, 32, 4, 4, 128, 4),
    ("t8", 66, 264, 8, 4, 4, 128, 1),
    ("t16", 66, 264, 16, 5, 4, 128, 2),
    ("t32_w4", 66, 264, 32, 4, 4, 128, 2),
    ("t32_w6", 66, 264, 32, 6, 5, 128, 1),
    ("t32_b64", 66, 264, 32, 5, 5, 64, 4),
)
REPS = 10


def _source(nw: int) -> str:
    lines = ['#include "modexp_wide.cu"', ""]
    for tag, n, vb, t, w, wd, threads, minb in VARIANTS:
        if n != nw:
            continue
        plan = f"Plan<{n}, {vb}, {t}, {w}, {wd}, {threads}, {minb}>"
        lines += [
            f'extern "C" int sweep_pow_{n}_{tag}(const void* b, const void* e, void* o,',
            "    long long n, const void* s, void* st) {",
            f"  return launch_pow<{plan}>(b, e, o, n, s, st);",
            "}",
            f'extern "C" int sweep_dual_{n}_{tag}(const void* u1, const void* e1,',
            "    const void* u2, const void* e2, void* o, long long n, const void* s,",
            "    void* st) {",
            f"  return launch_dual<{plan}>(u1, e1, u2, e2, o, n, s, st);",
            "}",
        ]
    return "\n".join(lines) + "\n"


def build() -> dict:
    """Compile one library per family, in parallel; {nw: CDLL}, printing
    ptxas's lines."""
    from cleisthenes_tpu_torch.csrc.build import BUILD_DIR, NVCC_FLAGS, SIGNATURES, _CSRC, nvcc_path

    work = BUILD_DIR / "sweep"
    work.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for nw in (12, 25, 66):
        src = work / f"sweep_{nw}.cu"
        src.write_text(_source(nw))
        lib = work / f"libsweep_{nw}.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_CSRC),
               "-o", str(lib), str(src)]
        jobs[nw] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    pw = SIGNATURES["modexp_wide"]["wide_pow_fused"]
    dual = SIGNATURES["modexp_wide"]["wide_dual_pow_fused"]
    libs = {}
    for nw, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {nw}-word sweep:\n{log}")
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas sweep_{nw}: {line.strip()}", flush=True)
        cdll = ctypes.CDLL(str(lib))
        for tag, n, *_ in VARIANTS:
            if n == nw:
                # the shipped entry points' arguments without the family word count
                getattr(cdll, f"sweep_pow_{n}_{tag}").argtypes = pw[:4] + pw[5:]
                getattr(cdll, f"sweep_dual_{n}_{tag}").argtypes = dual[:6] + dual[7:]
        libs[nw] = cdll
    return libs


def shapes(rnd):
    """(name, p, pow rows or None, dual rows or None) per timed shape."""
    p384 = cs.WIDE_GROUPS[0][1]
    out = [("384_epoch_pow", p384, cs.epoch_pow_rows(rnd, p384), None),
           ("384_epoch_dual", p384, None, cs.wide_rows(rnd, p384, cs.EPOCH_DUAL, True))]
    for bits, p, batch in cs.WIDE_GROUPS:
        rows = cs.wide_rows(rnd, p, batch, True)
        out.append((f"{bits}_bench", p, rows[:2], rows))
    return out


def main() -> int:
    import numpy as np
    import torch

    from cleisthenes_tpu_torch.csrc.build import load
    from cleisthenes_tpu_torch.ops import modexp_cuda as mx

    if not torch.cuda.is_available():
        print("wide_sweep: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    shipped = load("modexp_wide")
    libs = build()
    stream = torch.cuda.current_stream().cuda_stream
    rnd = random.Random(2026)
    results = []
    for name, p, pw, dual in shapes(rnd):
        vb = mx.family_bytes(p)
        spec = mx.wide_spec(p, vb)
        sw = spec.words.ctypes.data

        def rows_to(xs, order):
            return torch.from_numpy(np.frombuffer(
                b"".join(x.to_bytes(vb, order) for x in xs), np.uint8
            ).reshape(-1, vb).copy()).to(dev)

        for kind, rows in (("pow", pw), ("dual", dual)):
            if rows is None:
                continue
            ins = [rows_to(x, o) for x, o in zip(rows, ("little", "big", "little", "big"))]
            n = ins[0].shape[0]
            out = torch.empty_like(ins[0])
            ptrs = [t.data_ptr() for t in ins]
            entry = shipped.wide_pow_fused if kind == "pow" else shipped.wide_dual_pow_fused
            cands = [("shipped", lambda entry=entry: entry(
                *ptrs, out.data_ptr(), n, spec.nw, sw, stream))]
            if cands[0][1]() != 0:
                raise RuntimeError(f"shipped {kind} failed at {name}")
            torch.cuda.synchronize()
            want = out.clone()
            res = [int.from_bytes(r.tobytes(), "little") for r in want.cpu().numpy()]
            idx = rnd.sample(range(n), min(n, 24))
            if kind == "pow":
                ok = all(res[i] == pow(rows[0][i], rows[1][i], p) for i in idx)
            else:
                ok = all(res[i] == pow(rows[0][i], rows[1][i], p) * pow(rows[2][i], rows[3][i], p) % p
                         for i in idx)
            for tag, nw, *_ in VARIANTS:
                if nw == spec.nw:
                    fn = getattr(libs[nw], f"sweep_{kind}_{nw}_{tag}")
                    cands.append((tag, lambda fn=fn: fn(*ptrs, out.data_ptr(), n, sw, stream)))
            for tag, fn in cands:
                out.zero_()
                rc = fn()
                torch.cuda.synchronize()
                rec = {"shape": name, "kind": kind, "rows": n, "variant": tag, "rc": rc,
                       "equal": rc == 0 and ok and torch.equal(out, want)}
                rec["ms"] = cs.time_ms(torch, fn, REPS) if rc == 0 else None
                print("sweep " + json.dumps(rec), flush=True)
                results.append(rec)
    print(json.dumps({"sweep": results}))
    return 0 if all(r["equal"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
