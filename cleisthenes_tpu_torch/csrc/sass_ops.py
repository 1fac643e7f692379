"""Count the instructions sm_90a issues for the kernels' unit of work.

The bounds that ``chip_smoke.py`` reports for the SHA-256 and modexp
kernels are operations over the card's rates, so they rest on a count
of the 32-bit operations in one SHA-256 compression and in one
Montgomery product.  This script takes those counts from the machine
code: it compiles probe kernels against the sources with the build's
flags, disassembles them with ``cuobjdump -sass`` and prints, per
kernel, the instructions by opcode and the integer ALU ones
(everything but loads, stores, moves and control flow).  For SHA-256 it
also splits them by pipe (``sha_ops``: the ones that issue on the INT32
pipe, ``INT32_PIPE``, and all of them), since nvcc puts part of the
adds on the FMA pipe as IMADs: ``chip_smoke.py`` bounds the SHA kernels
by the larger of the INT32-pipe count over that pipe's rate and the
whole count over the issue rate (``SHA_BLOCK_OPS``, ``SHA_NODE_OPS``);
the script exits 1 when a probe now counts fewer than they record.

- ``probe_compress``: one ``sha256_compress`` on state and words read
  from memory, so nothing folds (``csrc/sha256.cu``);
- ``probe_node``: one ``sha256_node`` (the two compressions of a
  65-byte Merkle node message, whose padding words are constants);
- ``probe_leaf``: one ``leaf_digest`` (a leaf from its staged words or,
  past the staging budget, from global memory), the leaf part of
  ``merkle_verify_kernel``.  The script prints ``merkle_verify_nodes``:
  the kernel's ALU instructions less the leaf probe's, over the node
  probe's, which must round to 1: the level loop holds one node's code,
  its left/right order chosen by selects; the script exits 1 if a second
  copy of the node appears (a branch on the index bit that nvcc did not
  if-convert; measured at 2.1 with the branch put back);
- ``probe_team_prod_8``: one team product of K8's ``DualPlan``
  (``csrc/mont_team.cuh``, 8 x 32-bit CIOS with its conditional
  subtract; every kernel of ``csrc/modexp.cu`` runs it, with one lane
  or a team) on operands and a modulus read from memory, counted as the
  wide probes below are.  The script prints ``mont_team_prod`` (its ALU
  instructions per lane and per team) and ``mont_ops``:
  ``MONT_FIRST_OPS`` (the first design's one-thread product, 429),
  ``MONT_TEAM_OPS`` and ``MONT_OPS``, the lesser of the two (the 256-bit
  bounds' count before they were split by pipe); it exits 1 when the
  team product now counts fewer instructions than ``MONT_TEAM_OPS``.
  Beside them, ``mont_pipe_ops``: the product's instructions split by pipe
  (``pipe_split``, ``fma_pipe``: INT32 pipe, FMA pipe, all issued), which
  ``chip_smoke.py`` bounds 256-bit products by (``MONT_PIPE_OPS``; the
  script exits 1 when a pipe's count falls below it);
- ``probe_team_prod_NW`` for NW = 12, 25 and 66
  (``csrc/modexp_wide.cu``): one ``team_prod`` of the family's plan on
  one lane's words of the operands and of p read from memory, its loop
  over the team's lanes unrolled as in the kernels.  The script prints
  ``wide_team_prod``: the ALU instructions one lane issues for a
  product (the probe's, plus its loop body's once for every further
  iteration), per team (times the team's T lanes), and the warp
  exchanges (shuffles and votes, left out of the ALU count) in the
  probe's code.  Beside them it prints ``wide_mont_ops``, the earlier
  one-thread-per-exponentiation kernel's instructions per product
  (1,013 / 4,068 / 26,987 at 12 / 25 / 66 words), and
  ``wide_bound_ops``, the count per product that the K12 bounds in
  ``chip_smoke.py`` use: the lesser of the two.  It exits 1 when a
  product now takes fewer instructions a team than ``WIDE_TEAM_OPS``
  records, so that the bounds are brought down with it.

It also prints ``ptxas -v``'s registers, shared memory and spill bytes
for every kernel of ``csrc/gf256.cu``, ``csrc/gf65536.cu``,
``csrc/sha256.cu``, ``csrc/modexp.cu`` and ``csrc/modexp_wide.cu``, and
for the last two a ``ptxas_modexp`` and a
``ptxas_wide`` summary: registers, stack and spill bytes per kernel (and
family).

Run from the repository root on a machine with ``nvcc`` and
``cuobjdump`` (no card needed):

    python3 -m cleisthenes_tpu_torch.csrc.sass_ops
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
from typing import Dict

from cleisthenes_tpu_torch.csrc.build import BUILD_DIR, NVCC_FLAGS, _CSRC, nvcc_path

_PROBES = {}
_PROBES["sha256"] = r"""
#include "sha256.cu"

extern "C" __global__ void probe_compress(const uint32_t* __restrict__ in,
                                          uint32_t* __restrict__ out) {
  uint32_t st[8], w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = in[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = in[8 + i];
  sha256_compress(st, w);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = st[i];
}

extern "C" __global__ void probe_node(const uint32_t* __restrict__ in,
                                      uint32_t* __restrict__ out) {
  uint32_t l[8], r[8], st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) { l[i] = in[i]; r[i] = in[8 + i]; }
  sha256_node(l, r, st);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = st[i];
}

extern "C" __global__ void probe_leaf(const uint32_t* __restrict__ rows,
                                      const uint8_t* __restrict__ global,
                                      long long L, int pitch_w,
                                      uint32_t* __restrict__ out) {
  uint32_t st[8];
  leaf_digest(rows, threadIdx.x, pitch_w, L, global + threadIdx.x * L, st);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[8 * threadIdx.x + i] = st[i];
}
"""

_PROBES["modexp"] = r"""
#include "modexp.cu"

// One team product of K8's DualPlan (one lane; K9's table chain runs the
// product as a team of CombPlan::T lanes), as the kernels run it.
extern "C" __global__ void probe_team_prod_8(const uint32_t* __restrict__ in,
                                             uint32_t* __restrict__ out) {
  using P = DualPlan;
  Lane<P> L;
  L.tl = (int)(threadIdx.x % P::T);
  L.lane = threadIdx.x & 31u;
  L.top = L.tl == P::T - 1;
  L.pinv = in[0];
  uint32_t a[P::K], b[P::K];
  __syncthreads(); /* converged, as in the kernels */
  const uint32_t* at = in + 1 + 3 * P::K * threadIdx.x;
#pragma unroll
  for (int k = 0; k < P::K; ++k) {
    L.p[k] = at[k];
    a[k] = at[P::K + k];
    b[k] = at[2 * P::K + k];
  }
  team_prod<P>(a, a, b, L);
#pragma unroll
  for (int k = 0; k < P::K; ++k) out[P::K * threadIdx.x + k] = a[k];
}
"""

_PROBES["modexp_wide"] = r"""
#include "modexp_wide.cu"

// One team product of each family's plan, as the kernels run it (its loop
// over the team's lanes unrolled by the plan's STEP_UNROLL).
#define WIDE_PROBE(NW, PLAN)                                                   \
  extern "C" __global__ void probe_team_prod_##NW(                             \
      const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {           \
    using P = PLAN;                                                            \
    Lane<P> L;                                                                 \
    L.tl = (int)(threadIdx.x % P::T);                                          \
    L.lane = threadIdx.x & 31u;                                                \
    L.top = L.tl == P::T - 1;                                                  \
    L.pinv = in[0];                                                            \
    uint32_t a[P::K], b[P::K];                                                 \
    __syncthreads(); /* converged, as in the kernels */                        \
    const uint32_t* at = in + 1 + 3 * P::K * threadIdx.x;                      \
    _Pragma("unroll") for (int k = 0; k < P::K; ++k) {                         \
      L.p[k] = at[k];                                                          \
      a[k] = at[P::K + k];                                                     \
      b[k] = at[2 * P::K + k];                                                 \
    }                                                                          \
    team_prod<P>(a, a, b, L);                                                  \
    _Pragma("unroll") for (int k = 0; k < P::K; ++k)                           \
        out[P::K * threadIdx.x + k] = a[k];                                    \
  }

WIDE_PROBE(12, Plan12)
WIDE_PROBE(25, Plan25)
WIDE_PROBE(66, Plan66)
"""

# opcodes that are not 32-bit ALU work: memory, moves, control flow
_NOT_ALU = {
    "LDG", "STG", "LDC", "ULDC", "LDS", "STS", "LD", "ST", "S2R", "S2UR",
    "MOV", "UMOV", "CS2R", "EXIT", "BRA", "RET", "NOP", "BAR", "BSSY",
    "BSYNC", "IMAD.MOV", "LDL", "STL",
} | {"SHFL", "VOTE", "REDUX", "WARPSYNC", "ENDCOLLECTIVE"}
# warp exchanges (shuffles, votes, reductions), counted on their own
_WARP = {"SHFL", "VOTE", "REDUX"}
# opcodes that issue on sm_90a's INT32 pipe (16 lanes an SM sub-partition).
# IMAD and IMUL issue on the FMA pipe, the uniform datapath's U* opcodes on
# their own; an opcode not listed (VIADD among them) counts only as issued.
INT32_PIPE = {"IADD3", "IABS", "IMNMX", "ISETP", "LEA", "LOP3", "PLOP3", "PRMT", "SEL",
              "SHF", "SGXT", "BMSK"}
# opcodes that issue on the FMA pipe: the integer multiplies (IMAD and its
# forms .WIDE, .HI, .X, .SHL, .IADD, which ``count`` folds into IMAD; not
# IMAD.MOV, a move) and IMUL
FMA_PIPE = {"IMAD", "IMUL"}
# SHA-256's 32-bit instructions as (INT32 pipe, issued): one compression of
# words that do not fold (``probe_compress``: 672 SHF, 352 LOP3 and 241
# IADD3 on the INT32 pipe, 118 IMAD on the FMA pipe) and the two
# compressions of a 65-byte Merkle node, whose second block is mostly
# constant padding (``probe_node``: 1,284 SHF, 683 LOP3, 453 IADD3 and one
# LEA; 228 IMAD, 26 VIADD)
SHA_BLOCK_OPS = (1265, 1383)
SHA_NODE_OPS = (2421, 2675)
# 32-bit instructions of one wide Montgomery product per family word count,
# as counted in the SASS of csrc/modexp_wide.cu's first design (one thread
# per exponentiation, its CIOS product not shared across lanes) ...
WIDE_MONT_OPS = {12: 1013, 25: 4068, 66: 26987}
# ... and of the shipped plans' team product (``wide_team_prod``'s
# ``alu_per_team``: a lane's count times the team's T lanes).
WIDE_TEAM_OPS = {12: 950, 25: 11680, 66: 65536}
# The bound of a wide product (chip_smoke.py's K12 bounds): the fewest
# instructions any of the two products has been seen to need.
WIDE_BOUND_OPS = {nw: min(WIDE_MONT_OPS[nw], WIDE_TEAM_OPS[nw]) for nw in WIDE_MONT_OPS}
# 32-bit instructions of one 256-bit Montgomery product: the first design's
# one-thread CIOS product (counted in its SASS before csrc/modexp.cu moved
# onto the team product) and the team product of K8's plan
# (``probe_team_prod_8``, per team) ...
MONT_FIRST_OPS = 429
MONT_TEAM_OPS = 431
# ... and the lesser of the two, the count the 256-bit bounds used before
# they were split by pipe.
MONT_OPS = min(MONT_FIRST_OPS, MONT_TEAM_OPS)
# The team product of K8's plan (``probe_team_prod_8``, one lane) by pipe:
# (INT32 pipe, FMA pipe, all issued): 187 IADD3, 16 SHF, 8 SEL and an
# ISETP on the INT32 pipe, 202 IMAD (.WIDE, .X, .HI) on the FMA pipe, and
# 17 HFMA2 moves besides.  chip_smoke.py bounds a 256-bit product by the
# largest of INT32-pipe / 16.7 T/s, FMA-pipe / 16.7 T/s and issued /
# 33.4 T/s: the issued count binds.
MONT_PIPE_OPS = (212, 202, 431)
# address, opcode and operands of one SASS line
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)")


def _cuobjdump() -> str:
    return os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")


def loop_alu(sass: str, fn: str):
    """(ALU instructions of ``fn``, ALU instructions of its loop body) from
    ``cuobjdump -sass`` text: the body is the span from the target of the
    first backward branch to that branch (0 when ``fn`` has no loop)."""
    insns, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = line.split("Function :")[1].strip() == fn
            continue
        m = _INSN.search(line) if inside else None
        if m:
            op = m.group(2)
            op = "IMAD.MOV" if op.startswith("IMAD.MOV") else op.split(".")[0]
            insns.append((int(m.group(1), 16), op, m.group(3)))
    total = sum(op not in _NOT_ALU for _, op, _ in insns)
    for addr, op, rest in insns:
        t = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if t and int(t.group(1), 16) < addr:
            lo = int(t.group(1), 16)
            return total, sum(op2 not in _NOT_ALU for a, op2, _ in insns if lo <= a <= addr)
    return total, 0


def verify_nodes(alu: Dict[str, int]) -> float:
    """Copies of the Merkle node's code in ``merkle_verify_kernel`` (the
    probes' source includes csrc/sha256.cu, so their cubin holds its
    kernels, by mangled name): the kernel's ALU instructions less the
    leaf probe's, over the node probe's.  About 1.1 for one node (the
    level loop's selects, loads and index shifts add the tenth); a branch
    on the index bit that nvcc did not if-convert makes it about 2.1."""
    kern = next(fn for fn in alu if "merkle_verify_kernel" in fn)
    return (alu[kern] - alu["probe_leaf"]) / alu["probe_node"]


def pipe_split(hist: Dict[str, int]):
    """(INT32-pipe instructions, ALU instructions issued) of an opcode
    histogram from ``count``."""
    return (sum(n for op, n in hist.items() if op in INT32_PIPE),
            sum(n for op, n in hist.items() if op not in _NOT_ALU))


def fma_pipe(hist: Dict[str, int]) -> int:
    """Instructions of an opcode histogram from ``count`` that issue on the
    FMA pipe (``FMA_PIPE``)."""
    return sum(n for op, n in hist.items() if op in FMA_PIPE)


def count(sass: str) -> Dict[str, Dict[str, int]]:
    """{function: {opcode: count}} from ``cuobjdump -sass`` text; an
    opcode keeps its first suffix only for ``IMAD.MOV``."""
    out: Dict[str, Dict[str, int]] = {}
    hist = None
    for line in sass.splitlines():
        if "Function :" in line:
            hist = out.setdefault(line.split("Function :")[1].strip(), collections.Counter())
            continue
        m = _INSN.search(line)
        if hist is None or m is None:
            continue
        op = m.group(2)
        hist["IMAD.MOV" if op.startswith("IMAD.MOV") else op.split(".")[0]] += 1
    return {fn: dict(h) for fn, h in out.items()}


def main() -> int:
    work = BUILD_DIR / "sass"
    work.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    sass = ""
    for name, probe in _PROBES.items():
        src = work / f"probe_{name}.cu"
        src.write_text(probe)
        cubin = work / f"probe_{name}.cubin"
        subprocess.run(
            [nvcc_path(), *flags, "-cubin", "-I", str(_CSRC), "-o", str(cubin), str(src)],
            check=True,
        )
        sass += subprocess.run(
            [_cuobjdump(), "-sass", str(cubin)], check=True, capture_output=True, text=True
        ).stdout
    (work / "probe.sass").write_text(sass)
    for name in ("gf256", "gf65536", "sha256", "modexp", "modexp_wide"):
        log = subprocess.run(
            [nvcc_path(), *flags, "-cubin", "-Xptxas", "-v", "-o",
             str(work / f"{name}.cubin"), str(_CSRC / f"{name}.cu")],
            check=True, capture_output=True, text=True,
        )
        text = log.stdout + log.stderr
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
        if name == "modexp_wide":
            print("ptxas_wide " + json.dumps(ptxas_summary(text)))
        if name == "modexp":
            print("ptxas_modexp " + json.dumps(ptxas_summary(text, whole_plan=True)))
    result = {}
    for fn, hist in count(sass).items():
        alu = sum(n for op, n in hist.items() if op not in _NOT_ALU)
        result[fn] = {"alu": alu, "all": sum(hist.values()), "by_opcode": hist}
        print(f"{fn}: alu={alu} all={sum(hist.values())} "
              + json.dumps(dict(sorted(hist.items(), key=lambda kv: -kv[1]))))
    print("sass_ops " + json.dumps({fn: r["alu"] for fn, r in result.items()}))
    nodes = verify_nodes({fn: r["alu"] for fn, r in result.items()})
    print(f"merkle_verify_nodes {nodes}")
    if round(nodes) != 1:
        print("sass_ops: merkle_verify_kernel does not hold exactly one node's code")
        return 1
    sha = {"block": pipe_split(result["probe_compress"]["by_opcode"]),
           "node": pipe_split(result["probe_node"]["by_opcode"])}
    print("sha_ops " + json.dumps({
        **{k: {"int32_pipe": v[0], "issued": v[1]} for k, v in sha.items()},
        "SHA_BLOCK_OPS": SHA_BLOCK_OPS, "SHA_NODE_OPS": SHA_NODE_OPS}))
    if any(m < r for m, r in zip(sha["block"] + sha["node"], SHA_BLOCK_OPS + SHA_NODE_OPS)):
        print("sass_ops: SHA_BLOCK_OPS or SHA_NODE_OPS is above the measured count")
        return 1
    team = {}
    for nw, plan in wide_plans().items():
        fn = f"probe_team_prod_{nw}"
        total, body = loop_alu(sass, fn)
        t = plan["team"]
        k = -(-nw // t)  # Plan::K, the words a lane holds
        # team_prod's outer loop: NW / K steps, unrolled by Plan::STEP_UNROLL
        iters = -(-nw // k) // (t if t <= 4 else 1)
        lane = total + (iters - 1) * body if body else total
        warp = sum(n for op, n in result[fn]["by_opcode"].items() if op in _WARP)
        team[nw] = {"team": t, "alu_per_lane": lane, "alu_per_team": lane * t,
                    "loop_body_alu": body, "loop_iterations": iters if body else 1,
                    "warp_ops_static": warp}
    print("wide_team_prod " + json.dumps(team))
    print("wide_mont_ops " + json.dumps(WIDE_MONT_OPS))
    print("wide_bound_ops " + json.dumps(WIDE_BOUND_OPS))
    stale = [nw for nw, r in team.items() if r["alu_per_team"] < WIDE_TEAM_OPS[nw]]
    if stale:
        print(f"sass_ops: WIDE_TEAM_OPS is above the measured count at {stale} words")
        return 1
    t = modexp_plans()["DualPlan"]["team"]
    total, body = loop_alu(sass, "probe_team_prod_8")
    iters = -(-8 // -(-8 // t)) // (t if t <= 4 else 1)
    lane = total + (iters - 1) * body if body else total
    print("mont_team_prod " + json.dumps({"team": t, "alu_per_lane": lane, "alu_per_team": lane * t}))
    print("mont_ops " + json.dumps({"MONT_FIRST_OPS": MONT_FIRST_OPS,
                                    "MONT_TEAM_OPS": MONT_TEAM_OPS, "MONT_OPS": MONT_OPS}))
    if lane * t < MONT_TEAM_OPS:
        print("sass_ops: MONT_TEAM_OPS is above the measured count")
        return 1
    hist = result["probe_team_prod_8"]["by_opcode"]
    i32, issued = pipe_split(hist)
    mont_pipe = (i32, fma_pipe(hist), issued)
    print("mont_pipe_ops " + json.dumps({
        "int32_pipe": mont_pipe[0], "fma_pipe": mont_pipe[1], "issued": mont_pipe[2],
        "MONT_PIPE_OPS": MONT_PIPE_OPS}))
    if any(m < r for m, r in zip(mont_pipe, MONT_PIPE_OPS)):
        print("sass_ops: MONT_PIPE_OPS is above the measured count")
        return 1
    return 0


_PLAN = re.compile(r"using Plan(\d+) = Plan<([\d,\s]+)>;")
_PLAN_FIELDS = ("nw", "val_bytes", "team", "window", "dual_window", "threads", "min_blocks")


def wide_plans() -> Dict[int, Dict[str, int]]:
    """{NW: plan} as csrc/modexp_wide.cu declares ``Plan12/25/66``: the
    template's arguments by name (``_PLAN_FIELDS``)."""
    src = (_CSRC / "modexp_wide.cu").read_text()
    return {
        int(m.group(1)): dict(zip(_PLAN_FIELDS, (int(x) for x in m.group(2).split(","))))
        for m in _PLAN.finditer(src)
    }


_MODEXP_PLAN = re.compile(r"using (\w+Plan) = Plan<([\d,\s]+)>;")


def modexp_plans() -> Dict[str, Dict[str, int]]:
    """{"PowPlan": plan, ..., "CombPlan": plan} as csrc/modexp.cu declares
    them: the template's arguments by name (``_PLAN_FIELDS``)."""
    src = (_CSRC / "modexp.cu").read_text()
    return {
        m.group(1): dict(zip(_PLAN_FIELDS, (int(x) for x in m.group(2).split(","))))
        for m in _MODEXP_PLAN.finditer(src)
    }


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_KERNEL = re.compile(r"(dual_pow|comb_table|comb_apply|mont_mul|pow_keys|pow_scatter|pow)_kernel")


def ptxas_summary(log: str, whole_plan: bool = False) -> Dict[str, Dict[str, int]]:
    """{"<kernel>@<NW>": registers, stack and spill bytes} from ``ptxas
    -v`` output of csrc/modexp_wide.cu's or csrc/modexp.cu's kernels
    (kernel: pow, pow_keys, pow_scatter, dual, comb_table, comb_apply or
    mont_mul); with
    ``whole_plan`` the key names every argument of the kernel's plan
    ("dual@8,32,1,4,4,32,6")."""
    out: Dict[str, Dict[str, int]] = {}
    key = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            plan = re.search(r"PlanI((?:Li\d+E)+)E", m.group(1))
            args = re.findall(r"Li(\d+)E", plan.group(1)) if plan else ["8"]
            kind = _KERNEL.search(m.group(1)).group(1).replace("dual_pow", "dual")
            key = f"{kind}@{','.join(args) if whole_plan else args[0]}"
            continue
        if key is None:
            continue
        m = _PROPS.search(line)
        if m:
            out.setdefault(key, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


if __name__ == "__main__":
    raise SystemExit(main())
