"""Measure the tensor cores' binary and s8 ``mma.sync`` rates.

NVIDIA publishes no rate for ``mma.sync ... .b1`` on Hopper, the
instruction of the GF(2^16) codec (K11, ``csrc/gf65536.cu``): one
``mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc`` per
16 x 8 x 256 bit products.  The probe below is a register-only loop of
that instruction, and of ``mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32``
beside it (the same product with 0/1 bytes; a product of two bytes
counts as one bit product), 8 independent accumulator chains a warp, so
that the loop is bound by the tensor cores' issue rate, not their
latency.  It is a source of its own, built with the kernels' flags into
``_build/`` on first use, so that no kernel library carries it.

``mma_rates`` runs both on every SM at 1, 2, 4 and 8 blocks of 256
threads an SM and returns each instruction's best rate in bit products a
second.  ``chip_smoke.py`` takes K11's tensor-core yardstick from it and
``gf2_sweep.py`` prints it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import statistics
import subprocess

from cleisthenes_tpu_torch.csrc import build

THREADS = 256
CHAINS = 8
ITERS = 4096
BLOCKS_PER_SM = (1, 2, 4, 8)
# (name, probe kind, K of the instruction)
INSTRS = (("b1_m16n8k256_and_popc", 0, 256), ("s8_m16n8k32", 1, 32))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = %(threads)d;
constexpr int kChains = %(chains)d;

template <int KIND>
__global__ void __launch_bounds__(kThreads) mma_rate_probe_kernel(int iters, int* sink) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 2654435761u + 977u * i;
#pragma unroll
  for (int i = 0; i < 2; ++i) b[i] = threadIdx.x * 40503u + 7919u * i;
  int acc[kChains][4];
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%%0,%%1,%%2,%%3}, {%%4,%%5,%%6,%%7}, {%%8,%%9}, {%%0,%%1,%%2,%%3};\n"
            : "+r"(acc[c][0]), "+r"(acc[c][1]), "+r"(acc[c][2]), "+r"(acc[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%%0,%%1,%%2,%%3}, {%%4,%%5,%%6,%%7}, {%%8,%%9}, {%%0,%%1,%%2,%%3};\n"
            : "+r"(acc[c][0]), "+r"(acc[c][1]), "+r"(acc[c][2]), "+r"(acc[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) s ^= acc[c][i];
  if (s == 0x7FFFFFFF) sink[0] = s;  // keeps the chains live
}

}  // namespace

// kind 0: the b1 loop, 1: the s8 loop; `blocks` blocks of kThreads threads,
// `iters` iterations of kChains instructions a warp.
extern "C" int mma_rate_probe(int kind, int blocks, int iters, void* sink,
                              void* stream) {
  if (blocks < 1 || iters < 1 || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  if (kind == 0)
    mma_rate_probe_kernel<0><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        iters, (int*)sink);
  else
    mma_rate_probe_kernel<1><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        iters, (int*)sink);
  return (int)cudaGetLastError();
}
""" % {"threads": THREADS, "chains": CHAINS}


def build_probe() -> str:
    """Compile the probe if its library is missing; return its path."""
    h = hashlib.sha256(SOURCE.encode())
    h.update(" ".join(build.NVCC_FLAGS).encode())
    out = build.BUILD_DIR / f"libmma_probe-{h.hexdigest()[:16]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_name(f"mma_probe.{os.getpid()}.cu")
        src.write_text(SOURCE)
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        proc = subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the mma probe:\n{proc.stdout}{proc.stderr}")
        tmp.replace(out)
    return str(out)


def mma_rates(torch) -> dict:
    """{instruction: best bit products a second over ``BLOCKS_PER_SM``},
    printing a line per run (median of 5 after a warm-up, CUDA events)."""
    lib = ctypes.CDLL(build_probe())
    lib.mma_rate_probe.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.mma_rate_probe.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    best = {}
    for name, kind, k in INSTRS:
        for per_sm in BLOCKS_PER_SM:
            blocks = sms * per_sm

            def run():
                build.check(lib.mma_rate_probe(kind, blocks, ITERS, sink.data_ptr(), stream), name)

            run()
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            ms = statistics.median(times)
            instrs = blocks * (THREADS // 32) * ITERS * CHAINS
            rate = instrs * 16 * 8 * k / (ms * 1e-3)
            print(f"rate {name}: blocks={blocks} ({per_sm}/SM) threads={THREADS} "
                  f"chains={CHAINS} iters={ITERS} ms={ms} instr_per_s={instrs / (ms * 1e-3)} "
                  f"bit_products_per_s={rate}", flush=True)
            best[name] = max(best.get(name, 0.0), rate)
    return best


__all__ = ["SOURCE", "build_probe", "mma_rates"]
