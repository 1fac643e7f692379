// GF(2^8) matrix application for the Reed-Solomon codec, on Hopper (sm_90a).
//
// Replaces the TPU kernels of cleisthenes_tpu/ops/rs_xla.py:
//   K1 _encode_kernel / _encode_kernel_batch (:59, :71)   systematic encode
//   K2 _decode_kernel / _decode_kernel_batch /
//      _decode_kernel_shared (:65, :72, :76)              decode by a host-inverted matrix
//   K3 _decode_recheck_kernel (:80), its two codec steps  (the forest half is sha256.cu)
// Each is out[b, r, l] = XOR_j gf_mul(M_b[r, j], x[b, j, l]) over GF(2^8)
// (polynomial 0x11D), with M shared by every instance or one per instance.
//
// The TPU lifts M to a 0/1 bit matrix and runs the product on the MXU in
// bf16.  Here the product is computed directly with log/exp tables in shared
// memory: every output byte is k table lookups and XORs, exact integer work.
// Encode applies the full (n, k) systematic matrix, whose top k rows are the
// identity, so one launch writes the whole (n, L) shard set.
//
// Bound on the H100: at the N=128/f=42 epoch (B=128 instances, k=44, L=128)
// the data is ~0.7 MB in and ~2 MB out, ~1 us of HBM traffic at 3.35 TB/s,
// while the multiply-accumulates are B*(n-k)*k*L = 60.6 M, two int ops each
// (table product, XOR): ~7 us at the 16.7 T int32 ops/s of the SM's INT32
// lanes, so the kernel is bound by operations.  The design keeps everything
// the inner loop touches on chip: the tables and this block's rows of M (as
// logs) sit in shared memory, each thread owns one byte column l of kRows
// output rows in registers, and the x column is read once per block with
// neighbouring threads on neighbouring bytes (coalesced).  A zero factor maps
// to a log sentinel whose every sum indexes a zero entry, so the inner loop
// has no branch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // byte columns per block
constexpr int kRows = 16;      // output rows per block, accumulated in registers
constexpr int kMaxK = 256;     // GF(2^8) codes have at most 256 shards
constexpr int kZeroLog = 511;  // log sentinel: kZeroLog + anything >= 511 -> 0
constexpr int kExpLen = 1024;  // exp table padded with zeros past index 509

__global__ void gf256_apply_kernel(const uint8_t* __restrict__ mat,
                                   long long mat_bstride,
                                   const uint8_t* __restrict__ exp_tab,
                                   const int16_t* __restrict__ log_tab,
                                   const uint8_t* __restrict__ x,
                                   uint8_t* __restrict__ out, int m, int k,
                                   int L) {
  __shared__ uint8_t s_exp[kExpLen];
  __shared__ int16_t s_log[256];
  __shared__ int16_t s_mlog[kRows * kMaxK];

  const long long b = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int l = blockIdx.z * kThreads + threadIdx.x;
  const uint8_t* mb = mat + b * mat_bstride;

  for (int i = threadIdx.x; i < kExpLen; i += kThreads)
    s_exp[i] = i < 510 ? exp_tab[i] : 0;
  for (int i = threadIdx.x; i < 256; i += kThreads) s_log[i] = log_tab[i];
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * k; i += kThreads) {
    const int rr = i / k;
    const int j = i - rr * k;
    const int r = r0 + rr;
    const uint8_t c = r < m ? mb[(long long)r * k + j] : 0;
    s_mlog[rr * kMaxK + j] = c ? s_log[c] : kZeroLog;
  }
  __syncthreads();
  if (l >= L) return;

  const uint8_t* xb = x + b * k * (long long)L + l;
  uint8_t acc[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0;
  for (int j = 0; j < k; ++j) {
    const uint8_t v = xb[(long long)j * L];
    const int lv = v ? s_log[v] : kZeroLog;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) acc[rr] ^= s_exp[lv + s_mlog[rr * kMaxK + j]];
  }
  uint8_t* ob = out + b * m * (long long)L + l;
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = r0 + rr;
    if (r < m) ob[(long long)r * L] = acc[rr];
  }
}

}  // namespace

// out (B, m, L) = M (*) x for x (B, k, L); M is (m, k) at mat + b * mat_bstride
// (mat_bstride 0: one matrix shared by every instance).  exp_tab is the
// 512-entry GF(2^8) exp table, log_tab the 256-entry log table as int16.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gf256_apply(const void* mat, long long mat_bstride,
                           const void* exp_tab, const void* log_tab,
                           const void* x, void* out, int B, int m, int k, int L,
                           void* stream) {
  if (B < 1 || m < 1 || k < 1 || k > kMaxK || L < 1 ||
      (m + kRows - 1) / kRows > 65535 || (L + kThreads - 1) / kThreads > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, (m + kRows - 1) / kRows, (L + kThreads - 1) / kThreads);
  gf256_apply_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mat, mat_bstride, (const uint8_t*)exp_tab,
      (const int16_t*)log_tab, (const uint8_t*)x, (uint8_t*)out, m, k, L);
  return (int)cudaGetLastError();
}
