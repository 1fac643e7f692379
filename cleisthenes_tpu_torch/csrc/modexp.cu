// Batched Montgomery modular exponentiation on Hopper (sm_90a).
//
// Replaces the TPU kernels of cleisthenes_tpu/ops/modmath.py:
//   K7  _pow_fused (:551)          pow_fused: b^e mod p, square-and-multiply
//   K8  _dual_pow_fused (:592)     dual_pow_fused: u1^e1 * u2^e2 mod p
//                                  (Shamir's trick: one square and one
//                                  select-multiply per exponent bit)
//   K9  _pow_fused_grouped (:639)  comb_table + comb_apply: the fixed-base
//                                  comb, T[k][j] = base^(j * 16^k) per
//                                  distinct base, then 64 table multiplies
//                                  per exponent, each exponent naming its
//                                  base's table by an int32 row index
//   K10 mont_mul_batch (:504)      mont_mul: one Montgomery product
// all on the Montgomery core the reference builds in _make_mont_mul (:425).
//
// Byte contract (the reference's): values are 33-byte little-endian rows
// (264-bit capacity), exponents 32-byte big-endian rows, results 33-byte
// little-endian rows in [0, p).  The group is an argument (MontSpec: p,
// -p^-1 mod 2^32, R mod p, R^2 mod p, R^3 mod p for R = 2^256), so one
// library serves every odd modulus of 256 bits or fewer.
//
// Layout.  The reference's 22 x 12-bit lazy-carry limbs are shaped for the
// TPU's int32 vector unit.  Here a value is 8 x 32-bit limbs in registers,
// one thread per exponentiation, and the product is CIOS Montgomery with
// 32 x 32 -> 64-bit multiplies.  Two hazards of that layout:
// - p's top bit may be set (the default p = 0xFFB2...), so with R = 2^256 the
//   CIOS intermediate reaches 2p > 2^256: it keeps a ninth (carry) word and
//   the final conditional subtract compares all 257 bits;
// - an input value may lie in [p, 2^264) (the reference's device path passes
//   such bases through unreduced): to_mont folds the 33rd byte h as
//   x*R = lo*R + h*R^2, i.e. mont(lo, R^2) + mont(h, R^3) mod p.
//
// Bound on the H100: integer multiply work.  One Montgomery product is the
// number of 32-bit instructions csrc/sass_ops.py counts in probe_mont; an
// exponentiation is ~512 products on ~100 bytes of I/O, so every kernel here
// is bound by operations at the INT32 rate (132 SMs x 64 lanes x 1.98 GHz;
// 32-bit IMAD issues at 64 per clock per SM on compute capability 9.0, the
// CUDA C++ Programming Guide's arithmetic-throughput table), never by bytes.
// The design keeps every limb of every operand in registers: the exponent is
// read one 32-bit word at a time from global memory, the comb table (32 KiB
// per base, L2-resident) is read as two 16-byte loads per multiply, and no
// value touches local memory.  The comb's table build is a chain of 252
// dependent squarings per base (one thread), so it is bound by latency, not
// by throughput; the 64 threads of a block then fill the base's 64 rows.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWords = 8;          // 8 x 32-bit limbs: R = 2^256
constexpr int kSpecWords = 33;     // p, pinv, one, r2, r3
constexpr int kCombRows = 64;      // nibble positions of a 256-bit exponent
constexpr int kCombCols = 16;      // nibble values

struct MontSpec {
  uint32_t p[kWords];
  uint32_t pinv;  // -p^-1 mod 2^32
  uint32_t one[kWords];  // R mod p: 1 in the Montgomery domain
  uint32_t r2[kWords];   // R^2 mod p: into the Montgomery domain
  uint32_t r3[kWords];   // R^3 mod p: folds an input's 33rd byte
};

// r = a * b / R mod p, for a < 2^256 and b < p; r may alias a or b.
__device__ __forceinline__ void mont_prod(uint32_t r[kWords],
                                         const uint32_t a[kWords],
                                         const uint32_t b[kWords],
                                         const MontSpec& s) {
  uint32_t t[kWords + 2];
#pragma unroll
  for (int j = 0; j < kWords + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      c += (uint64_t)a[i] * b[j] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[kWords];
    t[kWords] = (uint32_t)c;
    t[kWords + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * s.pinv;
    c = ((uint64_t)m * s.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < kWords; ++j) {
      c += (uint64_t)m * s.p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[kWords];
    t[kWords - 1] = (uint32_t)c;
    t[kWords] = t[kWords + 1] + (uint32_t)(c >> 32);
  }
  // t < 2p < 2^257: subtract p once if t >= p, over all 257 bits
  uint32_t d[kWords];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t x = (uint64_t)t[j] - s.p[j] - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  const bool ge = t[kWords] >= borrow;
#pragma unroll
  for (int j = 0; j < kWords; ++j) r[j] = ge ? d[j] : t[j];
}

// r = (x + y) mod p for x, y < p.
__device__ __forceinline__ void mod_add(uint32_t r[kWords],
                                        const uint32_t x[kWords],
                                        const uint32_t y[kWords],
                                        const MontSpec& s) {
  uint32_t t[kWords];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)x[j] + y[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  const uint32_t top = (uint32_t)c;
  uint32_t d[kWords];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t v = (uint64_t)t[j] - s.p[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const bool ge = top >= borrow;
#pragma unroll
  for (int j = 0; j < kWords; ++j) r[j] = ge ? d[j] : t[j];
}

__device__ __forceinline__ void copy8(uint32_t r[kWords], const uint32_t x[kWords]) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) r[j] = x[j];
}

// A 33-byte little-endian value: low 256 bits into lo, byte 32 into hi.
__device__ __forceinline__ void load33(const uint8_t* src, uint32_t lo[kWords],
                                       uint32_t& hi) {
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    lo[w] = (uint32_t)src[4 * w] | ((uint32_t)src[4 * w + 1] << 8) |
            ((uint32_t)src[4 * w + 2] << 16) | ((uint32_t)src[4 * w + 3] << 24);
  hi = src[32];
}

// x < p as a 33-byte little-endian row (byte 32 is zero).
__device__ __forceinline__ void store33(uint8_t* dst, const uint32_t x[kWords]) {
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    dst[4 * w] = (uint8_t)x[w];
    dst[4 * w + 1] = (uint8_t)(x[w] >> 8);
    dst[4 * w + 2] = (uint8_t)(x[w] >> 16);
    dst[4 * w + 3] = (uint8_t)(x[w] >> 24);
  }
  dst[32] = 0;
}

// Word wi (0 = most significant) of a 32-byte big-endian exponent row.
__device__ __forceinline__ uint32_t exp_word(const uint8_t* e, int wi) {
  const uint8_t* q = e + 4 * wi;
  return ((uint32_t)q[0] << 24) | ((uint32_t)q[1] << 16) |
         ((uint32_t)q[2] << 8) | (uint32_t)q[3];
}

// x * R mod p for the 264-bit value lo + hi * 2^256.
__device__ __forceinline__ void to_mont(uint32_t r[kWords], const uint32_t lo[kWords],
                                        uint32_t hi, const MontSpec& s) {
  uint32_t h[kWords] = {hi, 0, 0, 0, 0, 0, 0, 0};
  uint32_t a[kWords], b[kWords];
  mont_prod(a, lo, s.r2, s);
  mont_prod(b, h, s.r3, s);
  mod_add(r, a, b, s);
}

// x / R mod p: leave the Montgomery domain.
__device__ __forceinline__ void from_mont(uint32_t r[kWords], const uint32_t x[kWords],
                                          const MontSpec& s) {
  const uint32_t one[kWords] = {1, 0, 0, 0, 0, 0, 0, 0};
  mont_prod(r, x, one, s);
}

__global__ void mont_mul_kernel(const uint8_t* __restrict__ a,
                                const uint8_t* __restrict__ b,
                                uint8_t* __restrict__ out, long long n,
                                MontSpec s) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t x[kWords], y[kWords], hx, hy;
  load33(a + i * 33, x, hx);
  load33(b + i * 33, y, hy);
  mont_prod(x, x, y, s);
  store33(out + i * 33, x);
}

__global__ void pow_kernel(const uint8_t* __restrict__ base,
                           const uint8_t* __restrict__ exp,
                           uint8_t* __restrict__ out, long long n, MontSpec s) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t lo[kWords], hi, bm[kWords], acc[kWords], m[kWords];
  load33(base + i * 33, lo, hi);
  to_mont(bm, lo, hi, s);
  copy8(acc, s.one);
  const uint8_t* e = exp + i * 32;
#pragma unroll 1
  for (int wi = 0; wi < kWords; ++wi) {
    const uint32_t word = exp_word(e, wi);
#pragma unroll 1
    for (int bit = 31; bit >= 0; --bit) {
      mont_prod(acc, acc, acc, s);
      const bool set = (word >> bit) & 1u;
#pragma unroll
      for (int j = 0; j < kWords; ++j) m[j] = set ? bm[j] : s.one[j];
      mont_prod(acc, acc, m, s);
    }
  }
  from_mont(acc, acc, s);
  store33(out + i * 33, acc);
}

__global__ void dual_pow_kernel(const uint8_t* __restrict__ u1,
                                const uint8_t* __restrict__ e1,
                                const uint8_t* __restrict__ u2,
                                const uint8_t* __restrict__ e2,
                                uint8_t* __restrict__ out, long long n,
                                MontSpec s) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t lo[kWords], hi, a1[kWords], a2[kWords], a12[kWords], acc[kWords],
      m[kWords];
  load33(u1 + i * 33, lo, hi);
  to_mont(a1, lo, hi, s);
  load33(u2 + i * 33, lo, hi);
  to_mont(a2, lo, hi, s);
  mont_prod(a12, a1, a2, s);
  copy8(acc, s.one);
  const uint8_t* x1 = e1 + i * 32;
  const uint8_t* x2 = e2 + i * 32;
#pragma unroll 1
  for (int wi = 0; wi < kWords; ++wi) {
    const uint32_t w1 = exp_word(x1, wi);
    const uint32_t w2 = exp_word(x2, wi);
#pragma unroll 1
    for (int bit = 31; bit >= 0; --bit) {
      mont_prod(acc, acc, acc, s);
      const bool b1 = (w1 >> bit) & 1u;
      const bool b2 = (w2 >> bit) & 1u;
#pragma unroll
      for (int j = 0; j < kWords; ++j)
        m[j] = b1 ? (b2 ? a12[j] : a1[j]) : (b2 ? a2[j] : s.one[j]);
      mont_prod(acc, acc, m, s);
    }
  }
  from_mont(acc, acc, s);
  store33(out + i * 33, acc);
}

// One block of kCombRows threads per base row: thread 0 walks the chain
// s_k = base^(16^k) (4 squarings a step) into shared memory, then thread k
// writes row k of the table, T[k][j] = s_k^j (Montgomery domain).
__global__ void comb_table_kernel(const uint8_t* __restrict__ bases,
                                  uint32_t* __restrict__ table, MontSpec s) {
  __shared__ uint32_t s_pow[kCombRows][kWords];
  const long long row = blockIdx.x;
  const int k = threadIdx.x;
  if (k == 0) {
    uint32_t lo[kWords], hi, x[kWords];
    load33(bases + row * 33, lo, hi);
    to_mont(x, lo, hi, s);
#pragma unroll 1
    for (int kk = 0; kk < kCombRows; ++kk) {
      if (kk > 0) {
#pragma unroll 1
        for (int q = 0; q < 4; ++q) mont_prod(x, x, x, s);
      }
#pragma unroll
      for (int j = 0; j < kWords; ++j) s_pow[kk][j] = x[j];
    }
  }
  __syncthreads();
  uint32_t sk[kWords], cur[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) sk[j] = s_pow[k][j];
  uint4* dst = reinterpret_cast<uint4*>(
      table + (row * kCombRows + k) * (long long)(kCombCols * kWords));
  dst[0] = make_uint4(s.one[0], s.one[1], s.one[2], s.one[3]);
  dst[1] = make_uint4(s.one[4], s.one[5], s.one[6], s.one[7]);
  dst[2] = make_uint4(sk[0], sk[1], sk[2], sk[3]);
  dst[3] = make_uint4(sk[4], sk[5], sk[6], sk[7]);
  copy8(cur, sk);
#pragma unroll 1
  for (int j = 2; j < kCombCols; ++j) {
    mont_prod(cur, cur, sk, s);
    dst[2 * j] = make_uint4(cur[0], cur[1], cur[2], cur[3]);
    dst[2 * j + 1] = make_uint4(cur[4], cur[5], cur[6], cur[7]);
  }
}

// One thread per exponent: acc = prod_k T[rows[i]][k][nibble_k(e_i)], where
// nibble k holds exponent bits [4k, 4k + 4).  The select is an integer
// index into the table, never a float contraction.
__global__ void comb_apply_kernel(const uint8_t* __restrict__ exps,
                                  const int32_t* __restrict__ rows,
                                  const uint32_t* __restrict__ table,
                                  uint8_t* __restrict__ out, long long n,
                                  MontSpec s) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4* t = reinterpret_cast<const uint4*>(
      table + (long long)rows[i] * (kCombRows * kCombCols * kWords));
  const uint8_t* e = exps + i * 32;
  uint32_t acc[kWords], m[kWords];
  copy8(acc, s.one);
#pragma unroll 1
  for (int byte = 0; byte < 32; ++byte) {
    const uint32_t v = e[byte];
    const int k_lo = 2 * (31 - byte);  // byte 31 is the least significant
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = k_lo + half;
      const uint32_t nib = half ? (v >> 4) : (v & 15u);
      const long long at = 2 * ((long long)k * kCombCols + nib);
      const uint4 q0 = __ldg(t + at);
      const uint4 q1 = __ldg(t + at + 1);
      m[0] = q0.x; m[1] = q0.y; m[2] = q0.z; m[3] = q0.w;
      m[4] = q1.x; m[5] = q1.y; m[6] = q1.z; m[7] = q1.w;
      mont_prod(acc, acc, m, s);
    }
  }
  from_mont(acc, acc, s);
  store33(out + i * 33, acc);
}

inline bool spec_from(const void* words, MontSpec* s) {
  if (words == nullptr) return false;
  static_assert(sizeof(MontSpec) == kSpecWords * sizeof(uint32_t), "spec layout");
  memcpy(s, words, sizeof(MontSpec));
  return (s->p[0] & 1u) != 0;
}

inline bool grid_ok(long long n) {
  return n >= 1 && (n + kThreads - 1) / kThreads <= 0x7FFFFFFFll;
}

inline unsigned grid_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Every entry point takes the group as `spec`, a host array of 33 uint32
// words (p, -p^-1 mod 2^32, R mod p, R^2 mod p, R^3 mod p; each value 8
// little-endian words, R = 2^256), launches on `stream` and returns
// cudaGetLastError() (0 on success).

// out[i] = a[i] * b[i] / 2^256 mod p, for a[i], b[i] in [0, p).
extern "C" int mont_mul(const void* a, const void* b, void* out, long long n,
                        const void* spec, void* stream) {
  MontSpec s;
  if (!grid_ok(n) || !spec_from(spec, &s)) return (int)cudaErrorInvalidValue;
  mont_mul_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, (uint8_t*)out, n, s);
  return (int)cudaGetLastError();
}

// out[i] = base[i]^exp[i] mod p (base in [0, 2^264)).
extern "C" int pow_fused(const void* base, const void* exp, void* out,
                         long long n, const void* spec, void* stream) {
  MontSpec s;
  if (!grid_ok(n) || !spec_from(spec, &s)) return (int)cudaErrorInvalidValue;
  pow_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)base, (const uint8_t*)exp, (uint8_t*)out, n, s);
  return (int)cudaGetLastError();
}

// out[i] = u1[i]^e1[i] * u2[i]^e2[i] mod p.
extern "C" int dual_pow_fused(const void* u1, const void* e1, const void* u2,
                              const void* e2, void* out, long long n,
                              const void* spec, void* stream) {
  MontSpec s;
  if (!grid_ok(n) || !spec_from(spec, &s)) return (int)cudaErrorInvalidValue;
  dual_pow_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)u1, (const uint8_t*)e1, (const uint8_t*)u2,
      (const uint8_t*)e2, (uint8_t*)out, n, s);
  return (int)cudaGetLastError();
}

// table (n_rows, 64, 16, 8) uint32: T[r][k][j] = bases[r]^(j * 16^k) * R mod p.
extern "C" int comb_table(const void* bases, void* table, long long n_rows,
                          const void* spec, void* stream) {
  MontSpec s;
  if (n_rows < 1 || n_rows > 0x7FFFFFFFll || !spec_from(spec, &s))
    return (int)cudaErrorInvalidValue;
  comb_table_kernel<<<(unsigned)n_rows, kCombRows, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bases, (uint32_t*)table, s);
  return (int)cudaGetLastError();
}

// out (n, 33): out[i] = bases[rows[i]]^exps[i] mod p from comb_table's
// table; every rows[i] must lie in [0, n_rows) of that table.
extern "C" int comb_apply(const void* exps, const void* rows, const void* table,
                          void* out, long long n, const void* spec,
                          void* stream) {
  MontSpec s;
  if (!grid_ok(n) || !spec_from(spec, &s)) return (int)cudaErrorInvalidValue;
  comb_apply_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)exps, (const int32_t*)rows, (const uint32_t*)table,
      (uint8_t*)out, n, s);
  return (int)cudaGetLastError();
}
