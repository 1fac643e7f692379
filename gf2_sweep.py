#!/usr/bin/env python3
"""Measure the H100's binary tensor-core rate, the yardstick of the GF
codecs, and where the codec and Merkle kernels' time goes.

NVIDIA publishes no rate for ``mma.sync ... .b1`` on Hopper.  The GF(2^16)
codec (K11, ``cleisthenes_tpu_torch/csrc/gf65536.cu``) and the GF(2^8)
codec (K1/K2, ``csrc/gf256.cu``) compute their products as GF(2) products
of a lifted 0/1 matrix with the symbols' bits, one
``mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc`` per
16 x 8 x 256 bit products.  This script runs the register-only loops of
``cleisthenes_tpu_torch/csrc/mma_probe.py`` (that instruction, and the
s8 form of the same product beside it) on every SM at 1, 2, 4 and 8
blocks of 256 threads an SM and prints each rate in bit products a
second; ``chip_smoke.py`` takes the codecs' yardstick from the same
helper.

With ``--ablate`` it also builds copies of ``csrc/gf65536.cu``,
``csrc/gf256.cu`` and ``csrc/sha256.cu`` with one part of a kernel taken
out or one launch choice fixed (``VARIANTS``: a text substitution each, one
``nvcc`` each, all started together) and times each copy's C entry points,
the kernel alone without the Python wrapper, twice in turn: CUDA events
around 20 launches back to back (``<key>_ms``: at a few microseconds a
kernel the host's ctypes call and launch set this pace) and around a
replay of the same 20 launches captured in a CUDA graph
(``<key>_graph_ms``: the device's time):

- K11 encode and shared decode at the N=512 epoch's shapes (B=512, k=172,
  n=512, 64 symbols);
- K1 encode (parity rows), K2 shared and per-instance decode and K3's
  three launches at the N=128 epoch's shapes (B=128, k=44, n=128, L=128);
- K5's forest at N=512 and N=128, and K6's branch verify at N=128 (16,384
  branches, D=7) and N=512 (262,144 branches, D=9), as chip_smoke.py's
  kernel phase builds them.

An ablation's results are wrong, and its time says what the part costs;
a variant that only fixes a launch choice (``exact``) must give the
shipped kernel's bytes, or the script exits 1.  For every copy of
``sha256.cu`` it prints the ALU instructions of ``merkle_verify_kernel``
in the SASS (``sass_ops.count``): the shipped kernel holds one Merkle
node's code, the divergent one two.  It then times the shipped entry
points through their Python wrappers at the same shapes: CUDA events
around one call (median of 20, as ``chip_smoke.py`` times them) and the
host's time a call over 200 calls in a row.

With ``--parent DIR`` (an earlier tree, e.g. a ``git archive`` in a
git-ignored directory) it also builds ``DIR``'s ``gf256.cu`` and
``sha256.cu`` and times them beside.  The parent's ``gf256_apply`` is
called as its source declares it: with ``row0`` as ``build.SIGNATURES``
has it, or, in the first design's form, with exp/log table pointers and
the whole systematic matrix (``gf256_abi``).

Run from the repository root on a machine with one CUDA card and
``nvcc``:

    python3 gf2_sweep.py [--ablate [--parent DIR]]

It prints the card, one line per (instruction, blocks an SM), one line
per (round, variant) and last a JSON object of the best rate of each
instruction.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# the product loop of both GF codecs (csrc/gf65536.cu, csrc/gf256.cu), and
# the same loop without the tensor cores
_MMA = "for (int t = 0; t < kNTiles; ++t) mma_b1(acc[i][t], alo, ahi, bf[t][0], bf[t][1]);"
_NO_MMA = "for (int t = 0; t < kNTiles; ++t) acc[i][t][0] += alo.x ^ ahi.y ^ bf[t][0] ^ bf[t][1];"
_K6_SELECT = """    const bool right = idx & 1u;  // cur is the right child
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l[j] = right ? sib[j] : cur[j];
      r[j] = right ? cur[j] : sib[j];
    }
    sha256_node(l, r, cur);"""
_K6_THREADS = "  const int threads = verify_threads(B, sms);"
_COMPRESS_LOOP = "#pragma unroll\n  for (int t = 0; t < 64; ++t) {"
_SHFL = ("          v |= __shfl_xor_sync(0xFFFFFFFFu, v, 4);\n"
         "          v |= __shfl_xor_sync(0xFFFFFFFFu, v, 8);\n"
         "          v |= __shfl_xor_sync(0xFFFFFFFFu, v, 16);\n")
# (source stem, variant, [(text, replacement)], exact: must equal the shipped bytes)
VARIANTS = (
    ("gf65536", "shipped", [], True),
    ("gf65536", "no_mma", [(_MMA, _NO_MMA)], False),
    ("gf65536", "no_staging", [("if (st + 1 < steps) load_step(st + 1);", ""),
                               ("if (st + 1 < steps) stage(st + 1);", "")], False),
    ("gf65536", "no_step_barrier", [("if (st + 1 < steps) stage(st + 1);  // the other buffer: "
                                     "read a step ago\n        __syncthreads();",
                                     "if (st + 1 < steps) stage(st + 1);")], False),
    ("gf65536", "no_epilogue", [("if (r >= m) continue;  // warp-uniform\n      uint32_t mine = 0;",
                                 "if (r >= m || acc[i][0][0] != 12345) continue;\n"
                                 "      uint32_t mine = 0;")], False),
    ("gf256", "shipped", [], True),
    ("gf256", "no_staging", [("for (int u = tid; u < kw * (kCols / 4); u += kThreads) {",
                              "for (int u = tid; u < 0; u += kThreads) {")], False),
    ("gf256", "no_epilogue_shuffles", [(_SHFL, "")], False),
    ("gf256", "no_mma", [(_MMA, _NO_MMA)], False),
    # the grid launched with its shared memory, every block returning at once
    ("gf256", "launch_only", [("  extern __shared__ uint4 smem[];\n  const int steps",
                               "  extern __shared__ uint4 smem[];\n  if (B > 0) return;\n  const int steps")],
     False),
    # one unit a warp at a time (the first design)
    ("gf256", "single_units", [("      const int nu = unit + kWarps < units ? 2 : 1;  // warp-uniform",
                                "      const int nu = 1;"),
                               ("unit < units; unit += 2 * kWarps) {", "unit < units; unit += kWarps) {")],
     True),
    ("gf256", "no_lift", [("    if (lifted != mi) {", "    if (lifted != mi && mi < 0) {")], False),
    # 8-warp blocks of at most 64 rows: two blocks an SM at the N=128 encode
    ("gf256", "threads_256_rows_64", [("constexpr int kThreads = 512;", "constexpr int kThreads = 256;"),
                                      ("constexpr int kMaxRows = 128;", "constexpr int kMaxRows = 64;"),
                                      ("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads)")],
     True),
    ("sha256", "shipped", [], True),
    ("sha256", "no_levels", [("for (int width = p; width > 1; width >>= 1) {",
                              "for (int width = p; width > p; width >>= 1) {")], False),
    ("sha256", "no_leaf_hash", [("      leaf_digest(rows, t, pitch_w, L, src + (i0 + t) * L, st);",
                                 "      for (int z = 0; z < 8; ++z) st[z] = rows[t * pitch_w + z];")],
     False),
    ("sha256", "divergent_branch", [(_K6_SELECT, "    if (idx & 1u) sha256_node(sib, cur, l);\n"
                                                 "    else sha256_node(cur, sib, l);\n"
                                                 "    for (int j = 0; j < 8; ++j) cur[j] = l[j];")],
     True),
    ("sha256", "bytewise_leaf", [("  const LeafPlan plan = leaf_plan(leaf_len, threads, leaves);",
                                  "  const LeafPlan plan = {threads, 0, 0};")], True),
    ("sha256", "byte_siblings", [("  const int vec = (((uintptr_t)roots | (uintptr_t)branches) & 15) == 0;",
                                  "  const int vec = 0;")], True),
    # a quarter of the compression's code: whether instruction fetch holds
    # back the N=128 verify's one warp an SM sub-partition
    ("sha256", "compress_unroll_16", [(_COMPRESS_LOOP, "#pragma unroll 16\n  for (int t = 0; t < 64; ++t) {")],
     True),
) + tuple(
    ("sha256", f"verify_threads_{t}", [(_K6_THREADS, f"  const int threads = {t};")], True)
    for t in (32, 64, 128, 256)
)


def gf256_abi(src: str) -> str:
    """The form of a ``gf256.cu``'s C entry point: "row0" for
    ``gf256_apply(mat, bstride, x, out, B, m, k, L, row0, stream)`` (the
    GF(2) product, ``build.SIGNATURES``), "tables" for the first design's
    ``gf256_apply(mat, bstride, exp, log, x, out, B, m, k, L, stream)``,
    which applies the whole systematic matrix."""
    sig = re.search(r'extern "C" int gf256_apply\(([^)]*)\)', src)
    params = re.findall(r"(\w+)\s*(?:,|$)", sig.group(1).strip()) if sig else []
    if params == ["mat", "mat_bstride", "x", "out", "B", "m", "k", "L", "row0", "stream"]:
        return "row0"
    if params == ["mat", "mat_bstride", "exp_tab", "log_tab", "x", "out", "B", "m", "k", "L",
                  "stream"]:
        return "tables"
    raise RuntimeError(f"gf256.cu: unknown gf256_apply parameters {params}")


def _build(parent):
    """Compile every copy (and the parent's sources), all nvcc's at once;
    ({(stem, variant): CDLL}, the parent's ``gf256_abi`` or None)."""
    from cleisthenes_tpu_torch.csrc import build

    work = build.BUILD_DIR / "gf2_sweep"
    work.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stem, name, subs, _exact in VARIANTS:
        text = (build._CSRC / f"{stem}.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {stem}/{name}: text not found: {old!r}")
            text = text.replace(old, new)
        jobs[(stem, name)] = text
    abi = None
    if parent:
        for stem in ("gf256", "sha256"):
            jobs[(stem, "parent")] = (Path(parent) / "cleisthenes_tpu_torch" / "csrc"
                                      / f"{stem}.cu").read_text()
        abi = gf256_abi(jobs[("gf256", "parent")])
    procs = {}
    for (stem, name), text in jobs.items():
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
        libs[(stem, name)] = ctypes.CDLL(str(work / f"{stem}_{name}.so"))
    for (stem, name), lib in libs.items():
        for fn, argtypes in build.SIGNATURES[stem].items():
            if stem == "gf256" and name == "parent" and abi == "tables":
                P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
                argtypes = [P, LL, P, P, P, P, I, I, I, I, P]
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return libs, abi


def _verify_alu(lib_path: Path) -> int:
    """ALU instructions of merkle_verify_kernel in a library's SASS."""
    from cleisthenes_tpu_torch.csrc import sass_ops

    sass = subprocess.run([sass_ops._cuobjdump(), "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    hist = next(h for fn, h in sass_ops.count(sass).items() if "merkle_verify_kernel" in fn)
    return sum(n for op, n in hist.items() if op not in sass_ops._NOT_ALU)


def _inputs(torch):
    """Device inputs of every timed shape, made from seeds."""
    import numpy as np

    import chip_smoke as cs
    from cleisthenes_tpu_torch.ops import gf256, gf65536 as gf
    from cleisthenes_tpu_torch.ops import sha256_cuda as sh

    rng = np.random.default_rng(7)

    def put(a):
        return torch.from_numpy(np.array(a, copy=True)).to("cuda")

    x = {}
    n, k, b, s = 512, 172, 512, 64
    a = gf.systematic_rs_matrix(n, k)
    x["k11"] = dict(enc=put(a[k:]), inv=put(gf.gf_mat_inv(a[:k])), b=b, n=n, k=k, s=s,
                    x=put(rng.integers(0, 1 << 16, (b, k, s)).astype(np.uint16)),
                    out=torch.empty((b, n, s), dtype=torch.uint16, device="cuda"))
    n, k, b, L = 128, 44, 128, 128
    a = gf256.systematic_rs_matrix(n, k)
    pats = [sorted(rng.choice(n, k, replace=False).tolist()) for _ in range(b)]
    x["k1"] = dict(full=put(a), enc=put(a[k:]), inv=put(gf256.gf_mat_inv(a[:k])), a=a,
                   invs=put(np.stack([gf256.gf_mat_inv(a[q]) for q in pats])), b=b, n=n, k=k,
                   L=L, x=put(rng.integers(0, 256, (b, k, L), dtype=np.uint8)),
                   out=torch.empty((b, n, L), dtype=torch.uint8, device="cuda"),
                   dec=torch.empty((b, k, L), dtype=torch.uint8, device="cuda"),
                   exp=put(gf256.GF_EXP), log=put(gf256.GF_LOG.astype(np.int16)))
    x["pad"] = put(np.frombuffer(sh.EMPTY_LEAF_DIGEST, np.uint8))
    for m in (512, 128):
        trees = put(rng.integers(0, 256, (m, m, 128)).astype(np.uint8))
        forest = sh.build_forest(trees)
        br, idx = cs.tree_branches(np, forest.cpu().numpy(), m)
        x[f"tree{m}"] = dict(
            trees=trees, forest=torch.empty_like(forest), m=m,
            roots=forest[:, -1].repeat_interleave(m, 0).contiguous(),
            leaves=trees.reshape(m * m, 128), br=put(br), idx=put(idx),
            ok=torch.empty((m * m,), dtype=torch.uint8, device="cuda"))
    return x


def _calls(lib, stem, x, stream, tables=False):
    """{timing key: (launch, output tensor)} of one library at every shape
    (``tables``: its ``gf256_apply`` has the first design's form)."""
    if stem == "gf65536":
        k = x["k11"]
        return {
            "encode_ms": (lambda: lib.gf65536_apply(
                k["enc"].data_ptr(), 0, k["x"].data_ptr(), k["out"].data_ptr(), k["b"],
                k["n"] - k["k"], k["k"], k["s"], k["k"], stream), k["out"]),
            "decode_ms": (lambda: lib.gf65536_apply(
                k["inv"].data_ptr(), 0, k["x"].data_ptr(), k["out"].data_ptr(), k["b"], k["k"],
                k["k"], k["s"], 0, stream), k["out"]),
        }
    if stem == "gf256":
        k = x["k1"]
        b, n, kk, L = k["b"], k["n"], k["k"], k["L"]
        if tables:  # the whole matrix, log/exp tables
            t = (k["exp"].data_ptr(), k["log"].data_ptr())
            return {
                "encode_ms": (lambda: lib.gf256_apply(k["full"].data_ptr(), 0, *t, k["x"].data_ptr(),
                                                      k["out"].data_ptr(), b, n, kk, L, stream), k["out"]),
                "decode_ms": (lambda: lib.gf256_apply(k["inv"].data_ptr(), 0, *t, k["x"].data_ptr(),
                                                      k["dec"].data_ptr(), b, kk, kk, L, stream), k["dec"]),
                "decode_pi_ms": (lambda: lib.gf256_apply(k["invs"].data_ptr(), kk * kk, *t,
                                                         k["x"].data_ptr(), k["dec"].data_ptr(), b,
                                                         kk, kk, L, stream), k["dec"]),
            }
        return {
            "encode_ms": (lambda: lib.gf256_apply(k["enc"].data_ptr(), 0, k["x"].data_ptr(),
                                                  k["out"].data_ptr(), b, n - kk, kk, L, kk, stream),
                          k["out"]),
            "decode_ms": (lambda: lib.gf256_apply(k["inv"].data_ptr(), 0, k["x"].data_ptr(),
                                                  k["dec"].data_ptr(), b, kk, kk, L, 0, stream), k["dec"]),
            "decode_pi_ms": (lambda: lib.gf256_apply(k["invs"].data_ptr(), kk * kk, k["x"].data_ptr(),
                                                     k["dec"].data_ptr(), b, kk, kk, L, 0, stream),
                             k["dec"]),
        }
    out = {}
    for m in (512, 128):
        t = x[f"tree{m}"]
        out[f"forest_n{m}_ms"] = (lambda t=t: lib.merkle_forest(
            t["trees"].data_ptr(), t["m"], t["m"], 128, t["forest"].data_ptr(), x["pad"].data_ptr(),
            stream), t["forest"])
        out[f"verify_n{m}_ms"] = (lambda t=t: lib.merkle_verify(
            t["roots"].data_ptr(), t["leaves"].data_ptr(), 128, t["br"].data_ptr(),
            t["br"].shape[1], t["idx"].data_ptr(), t["ok"].data_ptr(), t["m"] ** 2, stream), t["ok"])
    return out


def _timed(torch, fn, side, reps=20):
    """ms a launch of ``fn`` (its launches on the stream ``side``): CUDA
    events around ``reps`` launches back to back from the host, and around
    a replay of the same launches captured in a CUDA graph, the device's
    time without the host's launch cost (which bounds the first from
    below at ~5-9 us a launch of a small kernel: ``launch_only``)."""
    import chip_smoke as cs

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(side):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        launches = start.elapsed_time(end) / reps
    return launches, cs.graph_ms(torch, fn, reps, side)


def ablations(torch, parent) -> bool:
    """Build and time every copy of ``VARIANTS`` (and the parent's); True
    if every exact variant gave the shipped kernel's bytes."""
    from cleisthenes_tpu_torch.csrc import build

    libs, abi = _build(parent)

    def old(stem, name):
        """Whether this copy's gf256_apply has the first design's form."""
        return stem == "gf256" and name == "parent" and abi == "tables"

    work = build.BUILD_DIR / "gf2_sweep"
    for (stem, name) in libs:
        if stem == "sha256":
            print(f"sass {stem} {name}: merkle_verify_kernel alu={_verify_alu(work / f'{stem}_{name}.so')}",
                  flush=True)
    x = _inputs(torch)
    side = torch.cuda.Stream()  # every copy's launches; a graph captures on it
    stream = side.cuda_stream
    exact = {(stem, name) for stem, name, _subs, ex in VARIANTS if ex} | {
        (stem, "parent") for stem in ("gf256", "sha256")}
    # the shipped bytes of every call, to hold the exact variants to
    shipped = {}
    for stem in ("gf65536", "gf256", "sha256"):
        for key, (fn, out) in _calls(libs[(stem, "shipped")], stem, x, stream).items():
            build.check(fn(), f"{stem} {key}")
            torch.cuda.synchronize()
            shipped[(stem, key)] = out.clone()
    ok = True
    for (stem, name), lib in libs.items():
        if (stem, name) not in exact:
            continue
        for key, (fn, out) in _calls(lib, stem, x, stream, old(stem, name)).items():
            build.check(fn(), f"{stem}/{name} {key}")
            torch.cuda.synchronize()
            same = torch.equal(out, shipped[(stem, key)])
            ok &= same
            if not same:
                print(f"sweep: {stem}/{name} {key} differs from the shipped kernel", flush=True)
    k1, t128 = x["k1"], x["tree128"]

    def k3(lib1, lib5, full):
        """K3's three launches: decode, re-encode, forest (N=128)."""
        b, n, kk, L = k1["b"], k1["n"], k1["k"], k1["L"]
        if full:  # the first design's entry: log/exp tables, the whole matrix
            t = (k1["exp"].data_ptr(), k1["log"].data_ptr())
            lib1.gf256_apply(k1["inv"].data_ptr(), 0, *t, k1["x"].data_ptr(), k1["dec"].data_ptr(),
                             b, kk, kk, L, stream)
            lib1.gf256_apply(k1["full"].data_ptr(), 0, *t, k1["dec"].data_ptr(),
                             k1["out"].data_ptr(), b, n, kk, L, stream)
        else:
            lib1.gf256_apply(k1["inv"].data_ptr(), 0, k1["x"].data_ptr(), k1["dec"].data_ptr(),
                             b, kk, kk, L, 0, stream)
            lib1.gf256_apply(k1["enc"].data_ptr(), 0, k1["dec"].data_ptr(), k1["out"].data_ptr(),
                             b, n - kk, kk, L, kk, stream)
        return lib5.merkle_forest(k1["out"].data_ptr(), b, n, L, t128["forest"].data_ptr(),
                                  x["pad"].data_ptr(), stream)

    for rnd in range(2):
        for (stem, name), lib in libs.items():
            t = {key: _timed(torch, fn, side)
                 for key, (fn, _out) in _calls(lib, stem, x, stream, old(stem, name)).items()}
            if (stem, name) in (("gf256", "shipped"), ("gf256", "parent")):
                five = libs[("sha256", name)]
                t["k3_ms"] = _timed(torch, lambda: k3(lib, five, old(stem, name)), side)
            print(f"ablate round={rnd} {stem} {name}: " + " ".join(
                f"{key}={launched} {key[:-3]}_graph_ms={graphed}"
                for key, (launched, graphed) in t.items()), flush=True)
    entry_times(torch, x)
    return ok


def entry_times(torch, x) -> None:
    """The shipped entry points through their Python wrappers: CUDA events
    around one call (median of 20) and the host's seconds a call over
    200 calls in a row, at the N=128 shapes (and K6 at N=512)."""
    from cleisthenes_tpu_torch.ops import rs_cuda as rs
    from cleisthenes_tpu_torch.ops import sha256_cuda as sh

    import chip_smoke as cs

    k1 = x["k1"]
    enc = k1["full"].clone()
    rs.mark_systematic(enc, k1["a"])
    shards = k1["x"]
    calls = {
        "rs_encode": lambda: rs.rs_encode(enc, k1["x"]),
        "rs_decode": lambda: rs.rs_decode(k1["inv"], shards),
        "rs_decode_per_instance": lambda: rs.rs_decode(k1["invs"], shards),
        "decode_recheck": lambda: rs.decode_recheck(k1["inv"], enc, shards),
    }
    for m in (128, 512):
        t = x[f"tree{m}"]
        calls[f"merkle_verify_n{m}"] = lambda t=t: sh.verify_branches(t["roots"], t["leaves"], t["br"], t["idx"])
    for name, fn in calls.items():
        events_ms = cs.time_ms(torch, fn, 20)
        torch.cuda.synchronize()
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host.append((time.perf_counter() - t0) / 200 * 1e3)
            torch.cuda.synchronize()
        print(f"entry {name}: events_ms={events_ms} host_ms_per_call={statistics.median(host)}",
              flush=True)


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
    parser.add_argument("--parent", help="an earlier tree whose gf256.cu and sha256.cu are timed beside")
    args = parser.parse_args()
    print(f"card: {cs.card_line()}", flush=True)
    rates = mma_probe.mma_rates(torch)
    ok = ablations(torch, args.parent) if args.ablate else True
    print(json.dumps({"mma_bit_products_per_s": rates}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
