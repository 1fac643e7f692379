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
  from memory.

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

# opcodes that are not 32-bit ALU work: memory, moves, control flow
_NOT_ALU = {
    "LDG", "STG", "LDC", "ULDC", "LDS", "STS", "LD", "ST", "S2R", "S2UR",
    "MOV", "UMOV", "CS2R", "EXIT", "BRA", "RET", "NOP", "BAR", "BSSY",
    "BSYNC", "IMAD.MOV",
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
    result = {}
    for fn, hist in count(sass).items():
        alu = sum(n for op, n in hist.items() if op not in _NOT_ALU)
        result[fn] = {"alu": alu, "all": sum(hist.values()), "by_opcode": hist}
        print(f"{fn}: alu={alu} all={sum(hist.values())} "
              + json.dumps(dict(sorted(hist.items(), key=lambda kv: -kv[1]))))
    print("sass_ops " + json.dumps({fn: r["alu"] for fn, r in result.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
