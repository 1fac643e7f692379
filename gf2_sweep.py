#!/usr/bin/env python3
"""Measure the H100's binary tensor-core rate, the yardstick of K11, and
where K11's and K5's time goes.

NVIDIA publishes no rate for ``mma.sync ... .b1`` on Hopper.  The GF(2^16)
codec (K11, ``cleisthenes_tpu_torch/csrc/gf65536.cu``) computes its
products as GF(2) products of a lifted 0/1 matrix with the symbols' bits,
one ``mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc`` per
16 x 8 x 256 bit products.  This script runs the register-only loops of
``cleisthenes_tpu_torch/csrc/mma_probe.py`` (that instruction, and the
s8 form of the same product beside it) on every SM at 1, 2, 4 and 8
blocks of 256 threads an SM and prints each rate in bit products a
second; ``chip_smoke.py`` takes K11's yardstick from the same helper.

With ``--ablate`` it also builds copies of ``csrc/gf65536.cu`` and
``csrc/sha256.cu`` with one part of a kernel taken out (``ABLATIONS``: a
text substitution each; their results are wrong, their times say what the
part costs) and times each copy's C entry point, CUDA events around 20
launches, at K11's N=512 encode and shared decode shapes and K5's N=512
and N=128 forests, twice in turn.

Run from the repository root on a machine with one CUDA card and
``nvcc``:

    python3 gf2_sweep.py [--ablate]

It prints the card, one line per (instruction, blocks an SM), one line
per (round, ablation) and last a JSON object of the best rate of each
instruction.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

_K11_MMA = "for (int t = 0; t < kNTiles; ++t) mma_b1(acc[i][t], alo, ahi, bf[t][0], bf[t][1]);"
# (source stem, ablation, [(text, replacement)])
ABLATIONS = (
    ("gf65536", "shipped", []),
    ("gf65536", "no_mma", [(_K11_MMA, "for (int t = 0; t < kNTiles; ++t) "
                            "acc[i][t][0] += alo.x ^ ahi.y ^ bf[t][0] ^ bf[t][1];")]),
    ("gf65536", "no_staging", [("if (st + 1 < steps) load_step(st + 1);", ""),
                               ("if (st + 1 < steps) stage(st + 1);", "")]),
    ("gf65536", "no_step_barrier", [("if (st + 1 < steps) stage(st + 1);  // the other buffer: "
                                     "read a step ago\n        __syncthreads();",
                                     "if (st + 1 < steps) stage(st + 1);")]),
    ("gf65536", "no_epilogue", [("if (r >= m) continue;  // warp-uniform\n      uint32_t mine = 0;",
                                 "if (r >= m || acc[i][0][0] != 12345) continue;\n"
                                 "      uint32_t mine = 0;")]),
    ("sha256", "shipped", []),
    ("sha256", "no_levels", [("for (int width = p; width > 1; width >>= 1) {",
                              "for (int width = p; width > p; width >>= 1) {")]),
    ("sha256", "no_leaf_hash", [("        sha256_leaf_staged(rows + t * pitch_w, (int)lw4, (int)L, st);",
                                 "        for (int z = 0; z < 8; ++z) st[z] = rows[t * pitch_w + z];")]),
)


def ablations(torch) -> None:
    """Build every copy of ``ABLATIONS`` (one nvcc each, all started
    together) and print each one's times."""
    import numpy as np

    from cleisthenes_tpu_torch.csrc import build
    from cleisthenes_tpu_torch.ops import gf65536 as gf
    from cleisthenes_tpu_torch.ops.sha256_cuda import EMPTY_LEAF_DIGEST

    work = build.BUILD_DIR / "gf2_sweep"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem, name, subs in ABLATIONS:
        text = (build._CSRC / f"{stem}.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"ablation {stem}/{name}: text not found: {old!r}")
            text = text.replace(old, new)
        src = work / f"{stem}_{name}.cu"
        src.write_text(text)
        procs[(stem, name)] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (stem, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {stem}/{name}:\n{log}")
        lib = ctypes.CDLL(str(work / f"{stem}_{name}.so"))
        fn = "gf65536_apply" if stem == "gf65536" else "merkle_forest"
        getattr(lib, fn).argtypes = build.SIGNATURES[stem][fn]
        libs[(stem, name)] = lib

    rng = np.random.default_rng(7)

    def put(a):
        return torch.from_numpy(np.array(a, copy=True)).to("cuda")

    def timed(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    n, k, b, s = 512, 172, 512, 64
    a = gf.systematic_rs_matrix(n, k)
    enc, inv = put(a[k:]), put(gf.gf_mat_inv(a[:k]))
    x = put(rng.integers(0, 1 << 16, (b, k, s)).astype(np.uint16))
    out = torch.empty((b, n, s), dtype=torch.uint16, device="cuda")
    trees = {m: put(rng.integers(0, 256, (m, m, 128)).astype(np.uint8)) for m in (512, 128)}
    forests = {m: torch.empty((m, 2 * m - 1, 32), dtype=torch.uint8, device="cuda") for m in (512, 128)}
    pad = put(np.frombuffer(EMPTY_LEAF_DIGEST, np.uint8))
    stream = torch.cuda.current_stream().cuda_stream
    for rnd in range(2):
        for (stem, name), lib in libs.items():
            if stem == "gf65536":
                t = {
                    "encode_ms": timed(lambda: lib.gf65536_apply(
                        enc.data_ptr(), 0, x.data_ptr(), out.data_ptr(), b, n - k, k, s, k, stream)),
                    "decode_ms": timed(lambda: lib.gf65536_apply(
                        inv.data_ptr(), 0, x.data_ptr(), out.data_ptr(), b, k, k, s, 0, stream)),
                }
            else:
                t = {f"n{m}_ms": timed(lambda m=m: lib.merkle_forest(
                    trees[m].data_ptr(), m, m, 128, forests[m].data_ptr(), pad.data_ptr(), stream))
                    for m in (512, 128)}
            print(f"ablate round={rnd} {stem} {name}: "
                  + " ".join(f"{key}={val}" for key, val in t.items()), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gf2_sweep: torch sees no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cleisthenes_tpu_torch.csrc import mma_probe

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ablate", action="store_true",
                        help="also time the kernels with one part taken out")
    args = parser.parse_args()
    print(f"card: {cs.card_line()}", flush=True)
    rates = mma_probe.mma_rates(torch)
    if args.ablate:
        ablations(torch)
    print(json.dumps({"mma_bit_products_per_s": rates}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
