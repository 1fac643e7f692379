// GF(2^16) matrix application for the wide Reed-Solomon codec, on Hopper
// (sm_90a).
//
// Replaces the TPU kernels of cleisthenes_tpu/ops/rs16_xla_kernels.py (K11):
//   _encode_kernel / encode_kernel_batch (:47, :57)   systematic encode
//   _decode_kernel / decode_kernel_shared (:53, :58)  decode by a host-inverted matrix
// with their bit-plane helpers (_unpack_bits16, _pack_bits16, _apply_bits16,
// :16-44).  Each is out[b, r, s] = XOR_j gf_mul(M_b[r, j], x[b, j, s]) over
// GF(2^16) (polynomial 0x1100B, generator 2) on uint16 symbols, with M shared
// by every instance or one per instance.
//
// The TPU lifts M to a (16m, 16k) 0/1 matrix and multiplies bit-planes on the
// MXU in bf16.  Here the product is computed directly with a log/exp table:
// gf_mul(c, v) = exp[(log c + log v) mod 65535], exact integer work.  Encode
// applies the full (n, k) systematic matrix, identity rows included, so one
// launch writes every row.
//
// Tables.  A doubled exp table (256 KiB) does not fit a block's 227 KiB of
// shared memory, so the block holds one period (65,535 entries) plus a zero
// slot at index 65535: 128 KiB.  The log sum is reduced mod 65535 with two
// unsigned minimums, and a zero factor maps to a log sentinel kZeroLog whose
// every sum clamps to the zero slot, so the inner loop has no branch.  The log
// table (128 KiB) stays in global memory, in L2: a block turns each matrix
// entry and each input symbol into its log once per tile.
//
// Tiling.  k reaches 172 at N=512 and may reach 65,535, so the block walks the
// k axis in chunks of kChunk: the logs of its kRows x kChunk matrix entries
// and kChunk x kCols input symbols go to shared memory, and each thread keeps
// kRowsPerThread accumulators for one symbol column.  A tile is kRows rows x
// kCols columns; the 256 threads map to (row group, column), so at the N=512
// shapes (S = 64 symbols) every lane works.  The block is persistent: 128 KiB
// of exp table allows one block per SM, so the grid is one block per SM and
// each block loads the table once and then walks tiles (instance, row tile,
// column tile) with a stride of the grid size.
//
// Bound on the H100: at the N=512/f=170 epoch (B=512 instances, k=172, n=512,
// S=64) encode is B*n*k*S = 2.9 G multiply-accumulates on ~11 MB in and
// ~34 MB out: bound by operations (four integer ops a product: add, two
// minimums, XOR, against ~14 us of HBM traffic).  In practice the random exp
// lookups conflict in shared-memory banks (about 3.5 ways for 32 random
// indices), which this simple design does not avoid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 64;                       // symbol columns per tile
constexpr int kRowGroups = kThreads / kCols;    // 4
constexpr int kRowsPerThread = 16;              // accumulators per thread
constexpr int kRows = kRowGroups * kRowsPerThread;  // 64 rows per tile
constexpr int kChunk = 64;                      // k per shared-memory chunk
constexpr uint32_t kOrder = 65535;              // multiplicative group order
constexpr uint32_t kZeroLog = 0x40000000u;      // log sentinel of 0
constexpr int kExpEntries = 65536;              // one period + zero slot
constexpr size_t kSmemBytes = kExpEntries * sizeof(uint16_t) +
                              (size_t)kRows * kChunk * sizeof(uint32_t) +
                              (size_t)kChunk * kCols * sizeof(uint32_t);

// exp index of a product from two logs, either of which may be kZeroLog:
// a valid sum lies in [0, 2 * 65534] and reduces mod 65535; a sum with a
// sentinel is >= kZeroLog and clamps to the zero slot 65535.
__device__ __forceinline__ uint32_t prod_index(uint32_t la, uint32_t lb) {
  uint32_t e = la + lb;
  e = min(e, e - kOrder);
  return min(e, kOrder);
}

__global__ void __launch_bounds__(kThreads, 1)
gf65536_apply_kernel(const uint16_t* __restrict__ mat, long long mat_bstride,
                     const uint16_t* __restrict__ exp_tab,
                     const uint16_t* __restrict__ log_tab,
                     const uint16_t* __restrict__ x, uint16_t* __restrict__ out,
                     int B, int m, int k, int S) {
  extern __shared__ uint4 smem[];
  uint16_t* s_exp = reinterpret_cast<uint16_t*>(smem);
  uint32_t* s_mlog = reinterpret_cast<uint32_t*>(s_exp + kExpEntries);  // [kRows][kChunk]
  uint32_t* s_xlog = s_mlog + kRows * kChunk;                           // [kChunk][kCols]

  const uint4* src = reinterpret_cast<const uint4*>(exp_tab);
  for (int i = threadIdx.x; i < kExpEntries * 2 / 16; i += kThreads) smem[i] = src[i];

  const int col = threadIdx.x % kCols;
  const int rg = threadIdx.x / kCols;
  const int row_tiles = (m + kRows - 1) / kRows;
  const int col_tiles = (S + kCols - 1) / kCols;
  const long long per_b = (long long)row_tiles * col_tiles;
  const long long items = (long long)B * per_b;

  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const long long b = w / per_b;
    const int rem = (int)(w - b * per_b);
    const int r0 = (rem / col_tiles) * kRows;
    const int c0 = (rem % col_tiles) * kCols;
    const uint16_t* mb = mat + b * mat_bstride;
    const uint16_t* xb = x + b * (long long)k * S;
    uint32_t acc[kRowsPerThread];
#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr) acc[rr] = 0;

    for (int j0 = 0; j0 < k; j0 += kChunk) {
      const int kc = min(kChunk, k - j0);
      __syncthreads();  // the table is loaded; the last chunk's readers are done
      for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
        const int rr = i / kChunk;
        const int jj = i - rr * kChunk;
        const int r = r0 + rr;
        uint32_t lg = kZeroLog;
        if (r < m && jj < kc) {
          const uint16_t c = mb[(long long)r * k + j0 + jj];
          if (c) lg = log_tab[c];
        }
        s_mlog[i] = lg;
      }
      for (int i = threadIdx.x; i < kChunk * kCols; i += kThreads) {
        const int jj = i / kCols;
        const int s = c0 + (i - jj * kCols);
        uint32_t lg = kZeroLog;
        if (jj < kc && s < S) {
          const uint16_t v = xb[(long long)(j0 + jj) * S + s];
          if (v) lg = log_tab[v];
        }
        s_xlog[i] = lg;
      }
      __syncthreads();
      const uint32_t* ml = s_mlog + rg * kRowsPerThread * kChunk;
#pragma unroll 4
      for (int jj = 0; jj < kc; ++jj) {
        const uint32_t lx = s_xlog[jj * kCols + col];
#pragma unroll
        for (int rr = 0; rr < kRowsPerThread; ++rr)
          acc[rr] ^= s_exp[prod_index(ml[rr * kChunk + jj], lx)];
      }
    }

    const int s = c0 + col;
    if (s < S) {
      uint16_t* ob = out + b * (long long)m * S + s;
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr) {
        const int r = r0 + rg * kRowsPerThread + rr;
        if (r < m) ob[(long long)r * S] = (uint16_t)acc[rr];
      }
    }
  }
}

}  // namespace

// out (B, m, S) = M (*) x for x (B, k, S) uint16 symbols; M is (m, k) uint16
// at mat + b * mat_bstride (mat_bstride 0: one matrix shared by every
// instance).  exp_tab is the 65,536-entry exp table (exp_tab[i] = 2^i for
// i < 65535, exp_tab[65535] = 0), log_tab the 65,536-entry log table (entry 0
// unused).  Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gf65536_apply(const void* mat, long long mat_bstride,
                             const void* exp_tab, const void* log_tab,
                             const void* x, void* out, int B, int m, int k,
                             int S, void* stream) {
  if (B < 1 || m < 1 || k < 1 || S < 1) return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gf65536_apply_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmemBytes);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  const long long items = (long long)B * ((m + kRows - 1) / kRows) *
                          ((S + kCols - 1) / kCols);
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  gf65536_apply_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const uint16_t*)mat, mat_bstride, (const uint16_t*)exp_tab,
      (const uint16_t*)log_tab, (const uint16_t*)x, (uint16_t*)out, B, m, k, S);
  return (int)cudaGetLastError();
}
