"""Count the instructions sm_90a issues for the kernels' unit of work.

The bounds that ``chip_smoke.py`` reports for the SHA-256 and modexp
kernels are operations over the card's INT32 rate, so they rest on a
count of the 32-bit operations in one SHA-256 compression and in one
Montgomery product.  This script takes those counts from the machine
code: it compiles probe kernels against the sources with the build's
flags, disassembles them with ``cuobjdump -sass`` and prints, per
kernel, the instructions by opcode and the integer ALU ones
(everything but loads, stores, moves and control flow).

- ``probe_compress``: one ``sha256_compress`` on state and words read
  from memory, so nothing folds (``csrc/sha256.cu``);
- ``probe_node``: one ``sha256_node`` (the two compressions of a
  65-byte Merkle node message, whose padding words are constants);
- ``probe_mont``: one ``mont_prod`` (``csrc/modexp.cu``, 8 x 32-bit
  CIOS with its conditional subtract) on operands and a modulus read
  from memory;
- ``probe_wide_prod_NW`` and ``probe_wide_step_NW`` for NW = 12 and 25
  (``csrc/modexp_wide.cu``): one ``wide_prod``, whose outer loop of NW
  CIOS steps is not unrolled, and one ``cios_step``.  A wide product
  issues the first's instructions plus NW - 1 more steps, so the script
  prints ``wide_mont_ops``: alu(prod) + (NW - 1) * alu(step) per family
  (the loop counter's few instructions a step are left out, so the
  count stays a lower bound).  The 66-word family's word loops are only
  partly unrolled, so its static SASS is no count of what it issues:
  its step and the rest of its product are extrapolated linearly in NW
  from the two fully unrolled families.

It also prints ``ptxas -v``'s registers, shared memory and spill bytes
for every kernel of ``csrc/gf65536.cu`` and ``csrc/modexp_wide.cu``
(the wide families spill at 66 words).

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
"""

_PROBES["modexp"] = r"""
#include "modexp.cu"

extern "C" __global__ void probe_mont(const uint32_t* __restrict__ in,
                                      uint32_t* __restrict__ out) {
  MontSpec s;
#pragma unroll
  for (int i = 0; i < 8; ++i) s.p[i] = in[16 + i];
  s.pinv = in[24];
  uint32_t a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) { a[i] = in[i]; b[i] = in[8 + i]; }
  mont_prod(a, a, b, s);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = a[i];
}
"""

_PROBES["modexp_wide"] = r"""
#include "modexp_wide.cu"

#define WIDE_PROBES(NW)                                                        \
  extern "C" __global__ void probe_wide_step_##NW(                             \
      const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {           \
    WideSpec<NW> s;                                                            \
    for (int i = 0; i < NW; ++i) s.p[i] = in[i];                               \
    s.pinv = in[NW];                                                           \
    uint32_t t[NW + 2], b[NW];                                                 \
    _Pragma("unroll") for (int i = 0; i < NW + 2; ++i) t[i] = in[NW + 1 + i];  \
    _Pragma("unroll") for (int i = 0; i < NW; ++i) b[i] = in[2 * NW + 3 + i];  \
    cios_step<NW>(t, in[3 * NW + 3], b, s);                                    \
    _Pragma("unroll") for (int i = 0; i < NW + 2; ++i) out[i] = t[i];          \
  }                                                                            \
  extern "C" __global__ void probe_wide_prod_##NW(                             \
      const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {           \
    WideSpec<NW> s;                                                            \
    for (int i = 0; i < NW; ++i) s.p[i] = in[i];                               \
    s.pinv = in[NW];                                                           \
    uint32_t a[NW], b[NW];                                                     \
    _Pragma("unroll") for (int i = 0; i < NW; ++i) a[i] = in[NW + 1 + i];      \
    _Pragma("unroll") for (int i = 0; i < NW; ++i) b[i] = in[2 * NW + 1 + i];  \
    wide_prod<NW>(b, a, b, s);                                                 \
    _Pragma("unroll") for (int i = 0; i < NW; ++i) out[i] = b[i];              \
  }

WIDE_PROBES(12)
WIDE_PROBES(25)
"""

# opcodes that are not 32-bit ALU work: memory, moves, control flow
_NOT_ALU = {
    "LDG", "STG", "LDC", "ULDC", "LDS", "STS", "LD", "ST", "S2R", "S2UR",
    "MOV", "UMOV", "CS2R", "EXIT", "BRA", "RET", "NOP", "BAR", "BSSY",
    "BSYNC", "IMAD.MOV", "LDL", "STL",
}
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _cuobjdump() -> str:
    return os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")


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
        op = m.group(1)
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
    for name in ("gf65536", "modexp_wide"):
        log = subprocess.run(
            [nvcc_path(), *flags, "-cubin", "-Xptxas", "-v", "-o",
             str(work / f"{name}.cubin"), str(_CSRC / f"{name}.cu")],
            check=True, capture_output=True, text=True,
        )
        for line in (log.stdout + log.stderr).splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    result = {}
    for fn, hist in count(sass).items():
        alu = sum(n for op, n in hist.items() if op not in _NOT_ALU)
        result[fn] = {"alu": alu, "all": sum(hist.values()), "by_opcode": hist}
        print(f"{fn}: alu={alu} all={sum(hist.values())} "
              + json.dumps(dict(sorted(hist.items(), key=lambda kv: -kv[1]))))
    print("sass_ops " + json.dumps({fn: r["alu"] for fn, r in result.items()}))
    print("wide_mont_ops " + json.dumps(wide_mont_ops({fn: r["alu"] for fn, r in result.items()})))
    return 0


def wide_mont_ops(alu: Dict[str, int]) -> Dict[int, int]:
    """{NW: 32-bit ALU instructions one wide product issues}: counted for
    the fully unrolled 12- and 25-word families, extrapolated linearly
    in NW (a step, and the rest of a product) for the 66-word one."""
    step = {nw: alu[f"probe_wide_step_{nw}"] for nw in (12, 25)}
    rest = {nw: alu[f"probe_wide_prod_{nw}"] - step[nw] for nw in (12, 25)}

    def line(v: Dict[int, int], nw: int) -> float:
        return v[12] + (v[25] - v[12]) * (nw - 12) / 13

    out = {nw: nw * step[nw] + rest[nw] for nw in (12, 25)}
    out[66] = round(66 * line(step, 66) + line(rest, 66))
    return out


if __name__ == "__main__":
    raise SystemExit(main())
