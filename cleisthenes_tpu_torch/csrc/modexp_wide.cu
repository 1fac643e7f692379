// Batched Montgomery exponentiation for groups wider than 256 bits, on
// Hopper (sm_90a).
//
// Replaces the TPU kernels of cleisthenes_tpu/ops/modmath.py (K12):
//   _wide_kernels(lay) (:313) -> pow_fused (:351)       wide_pow_fused: b^e mod p
//                             -> dual_pow_fused (:378)  wide_dual_pow_fused:
//                                                       u1^e1 * u2^e2 mod p (Shamir)
// on the reference's Montgomery core (_make_mont_mul, :425), for its three
// wide limb families: <= 384 bits (48-byte values; GROUP384, the width of
// BLS12-381's base field), <= 792 bits (99 bytes; the 768-bit Oakley group)
// and <= 2112 bits (264 bytes; the 2048-bit MODP-14 group).
//
// Byte contract (the reference's): values are val_bytes little-endian rows,
// already reduced mod p on the host; exponents are val_bytes big-endian rows;
// results are val_bytes little-endian rows in [0, p).  The group is an
// argument (WideSpec: p, -p^-1 mod 2^32, R mod p, R^2 mod p for
// R = 2^(32 NW)), so one build of a family serves every odd modulus that fits
// it.
//
// Layout.  The reference's lazy-carry 12- and 11-bit limbs are shaped for the
// TPU's int32 vector unit.  Here a value is NW = 12, 25 or 66 32-bit words,
// one thread per exponentiation, and the product is csrc/modexp.cu's CIOS
// with 32 x 32 -> 64-bit multiplies, one template over NW.  The 99-byte
// family pads its top word (25 words = 800 bits), so its radix 2^800 differs
// from the reference's 2^792; only the normal-domain result has to match.
// Two hazards:
// - p's top bit may be set (P384 fills its 12 words), so the CIOS sum reaches
//   2p > R: it keeps an extra carry word and the final conditional subtract
//   compares all 32 NW + 1 bits;
// - registers.  The product's left operand is read one word per outer step
//   from a per-thread array in local memory (L1-resident), so only the right
//   operand and the running sum need registers.  The word loops unroll fully
//   up to 32 words (the 12- and 25-word families keep every value in
//   registers); at 66 words they unroll by kPartialUnroll, so the sum and the
//   operands live in local memory.  Fully unrolled, the 66-word product
//   crashes NVVM (cicc, CUDA 12.9) and would not fit 255 registers anyway.
//   ptxas's registers and stack per family are in PERF.md
//   (csrc/sass_ops.py).
// The exponent loop starts at the first nonzero exponent byte, so a Lagrange
// row's e2 = 0 or a short exponent costs no leading squarings of one.
//
// Bound on the H100: integer multiply work, as for csrc/modexp.cu.  A product
// is NW CIOS steps and a final subtract; csrc/sass_ops.py counts the SASS of
// both per family.  An exponentiation is ~1.5 * 32 NW products on 2-3 values
// of I/O, so these kernels are bound by operations at the INT32 rate, never by
// bytes.  Blocks are one warp (kThreads = 32), so a 2048-bit batch of 128
// spreads over four SMs instead of one; a warp per exponentiation is a later
// redesign.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 32;
constexpr int kFullUnrollWords = 32;
constexpr int kPartialUnroll = 6;

// Unroll factor of a loop over the words of an NW-word value.
template <int NW>
struct WordUnroll {
  static constexpr int value = NW <= kFullUnrollWords ? NW : kPartialUnroll;
};

template <int NW>
struct WideSpec {
  uint32_t p[NW];
  uint32_t pinv;     // -p^-1 mod 2^32
  uint32_t one[NW];  // R mod p: 1 in the Montgomery domain
  uint32_t r2[NW];   // R^2 mod p: into the Montgomery domain
};

// One CIOS step: t = (t + ai * b + m * p) / 2^32, with m = t0 * pinv making
// the division exact.  t has NW + 2 words.
template <int NW>
__device__ __forceinline__ void cios_step(uint32_t t[NW + 2], uint32_t ai,
                                          const uint32_t b[NW],
                                          const WideSpec<NW>& s) {
  uint64_t c = 0;
#pragma unroll (WordUnroll<NW>::value)
  for (int j = 0; j < NW; ++j) {
    c += (uint64_t)ai * b[j] + t[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  c += t[NW];
  t[NW] = (uint32_t)c;
  t[NW + 1] = (uint32_t)(c >> 32);
  const uint32_t m = t[0] * s.pinv;
  c = ((uint64_t)m * s.p[0] + t[0]) >> 32;
#pragma unroll (WordUnroll<NW>::value)
  for (int j = 1; j < NW; ++j) {
    c += (uint64_t)m * s.p[j] + t[j];
    t[j - 1] = (uint32_t)c;
    c >>= 32;
  }
  c += t[NW];
  t[NW - 1] = (uint32_t)c;
  t[NW] = t[NW + 1] + (uint32_t)(c >> 32);
}

// r = t - p if t >= p else t, for t < 2p held in NW + 1 words.
template <int NW>
__device__ __forceinline__ void cios_final(uint32_t r[NW],
                                           const uint32_t t[NW + 2],
                                           const WideSpec<NW>& s) {
  uint32_t borrow = 0;
#pragma unroll (WordUnroll<NW>::value)
  for (int j = 0; j < NW; ++j) {
    const uint64_t x = (uint64_t)t[j] - s.p[j] - borrow;
    borrow = (uint32_t)(x >> 63);
  }
  const bool ge = t[NW] >= borrow;
  borrow = 0;
#pragma unroll (WordUnroll<NW>::value)
  for (int j = 0; j < NW; ++j) {
    const uint64_t x = (uint64_t)t[j] - s.p[j] - borrow;
    borrow = (uint32_t)(x >> 63);
    r[j] = ge ? (uint32_t)x : t[j];
  }
}

// r = a * b / R mod p for a < R and b < p; r may alias b (not a).  a is
// read one word per step (a runtime index: it lives in local memory).
template <int NW>
__device__ __forceinline__ void wide_prod(uint32_t r[NW], const uint32_t* a,
                                          const uint32_t b[NW],
                                          const WideSpec<NW>& s) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll 1
  for (int i = 0; i < NW; ++i) cios_step<NW>(t, a[i], b, s);
  cios_final<NW>(r, t, s);
}

template <int NW>
__device__ __forceinline__ void copy_words(uint32_t* r, const uint32_t* x) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = x[j];
}

// The unit 1 (normal domain): multiplying by it leaves the Montgomery domain.
template <int NW>
__device__ __forceinline__ void set_unit(uint32_t* r) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = j == 0 ? 1u : 0u;
}

// A VB-byte little-endian value into NW words (the top word zero-padded).
template <int NW, int VB>
__device__ __forceinline__ void load_val(const uint8_t* src, uint32_t* w) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    uint32_t x = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * k + b < VB) x |= (uint32_t)src[4 * k + b] << (8 * b);
    w[k] = x;
  }
}

// x < p as a VB-byte little-endian row.
template <int NW, int VB>
__device__ __forceinline__ void store_val(uint8_t* dst, const uint32_t x[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * k + b < VB) dst[4 * k + b] = (uint8_t)(x[k] >> (8 * b));
  }
}

template <int NW, int VB>
__global__ void __launch_bounds__(kThreads)
wide_pow_kernel(const uint8_t* __restrict__ base, const uint8_t* __restrict__ exp,
                uint8_t* __restrict__ out, long long n, const WideSpec<NW> s) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t a[NW];  // the next product's left operand (local memory)
  uint32_t bm[NW], acc[NW];
  load_val<NW, VB>(base + i * VB, a);
  copy_words<NW>(bm, s.r2);
  wide_prod<NW>(bm, a, bm, s);  // base * R mod p
  copy_words<NW>(acc, s.one);
  const uint8_t* e = exp + i * VB;
  int byte = 0;
  while (byte < VB && e[byte] == 0) ++byte;
#pragma unroll 1
  for (; byte < VB; ++byte) {
    const uint32_t v = e[byte];
#pragma unroll 1
    for (int bit = 7; bit >= 0; --bit) {
      copy_words<NW>(a, acc);
      wide_prod<NW>(acc, a, acc, s);
      if ((v >> bit) & 1u) {
        copy_words<NW>(a, bm);
        wide_prod<NW>(acc, a, acc, s);
      }
    }
  }
  set_unit<NW>(a);
  wide_prod<NW>(acc, a, acc, s);
  store_val<NW, VB>(out + i * VB, acc);
}

template <int NW, int VB>
__global__ void __launch_bounds__(kThreads)
wide_dual_pow_kernel(const uint8_t* __restrict__ u1, const uint8_t* __restrict__ e1,
                     const uint8_t* __restrict__ u2, const uint8_t* __restrict__ e2,
                     uint8_t* __restrict__ out, long long n, const WideSpec<NW> s) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t a[NW];  // the next product's left operand (local memory)
  uint32_t a1[NW], a2[NW], a12[NW], acc[NW];
  load_val<NW, VB>(u1 + i * VB, a);
  copy_words<NW>(a1, s.r2);
  wide_prod<NW>(a1, a, a1, s);
  load_val<NW, VB>(u2 + i * VB, a);
  copy_words<NW>(a2, s.r2);
  wide_prod<NW>(a2, a, a2, s);
  copy_words<NW>(a, a1);
  copy_words<NW>(a12, a2);
  wide_prod<NW>(a12, a, a12, s);
  copy_words<NW>(acc, s.one);
  const uint8_t* x1 = e1 + i * VB;
  const uint8_t* x2 = e2 + i * VB;
  int byte = 0;
  while (byte < VB && (x1[byte] | x2[byte]) == 0) ++byte;
#pragma unroll 1
  for (; byte < VB; ++byte) {
    const uint32_t v1 = x1[byte];
    const uint32_t v2 = x2[byte];
#pragma unroll 1
    for (int bit = 7; bit >= 0; --bit) {
      copy_words<NW>(a, acc);
      wide_prod<NW>(acc, a, acc, s);
      const uint32_t sel = ((v1 >> bit) & 1u) | (((v2 >> bit) & 1u) << 1);
      if (sel) {
#pragma unroll
        for (int j = 0; j < NW; ++j)
          a[j] = sel == 3u ? a12[j] : (sel == 1u ? a1[j] : a2[j]);
        wide_prod<NW>(acc, a, acc, s);
      }
    }
  }
  set_unit<NW>(a);
  wide_prod<NW>(acc, a, acc, s);
  store_val<NW, VB>(out + i * VB, acc);
}

inline bool grid_ok(long long n) {
  return n >= 1 && (n + kThreads - 1) / kThreads <= 0x7FFFFFFFll;
}

template <int NW>
inline bool spec_from(const void* words, WideSpec<NW>* s) {
  if (words == nullptr) return false;
  static_assert(sizeof(WideSpec<NW>) == (3 * NW + 1) * sizeof(uint32_t),
                "spec layout");
  memcpy(s, words, sizeof(WideSpec<NW>));
  return (s->p[0] & 1u) != 0;
}

template <int NW, int VB>
int launch_pow(const void* base, const void* exp, void* out, long long n,
               const void* spec, void* stream) {
  WideSpec<NW> s;
  if (!spec_from<NW>(spec, &s)) return (int)cudaErrorInvalidValue;
  wide_pow_kernel<NW, VB><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                            0, (cudaStream_t)stream>>>(
      (const uint8_t*)base, (const uint8_t*)exp, (uint8_t*)out, n, s);
  return (int)cudaGetLastError();
}

template <int NW, int VB>
int launch_dual(const void* u1, const void* e1, const void* u2, const void* e2,
                void* out, long long n, const void* spec, void* stream) {
  WideSpec<NW> s;
  if (!spec_from<NW>(spec, &s)) return (int)cudaErrorInvalidValue;
  wide_dual_pow_kernel<NW, VB><<<(unsigned)((n + kThreads - 1) / kThreads),
                                 kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)u1, (const uint8_t*)e1, (const uint8_t*)u2,
      (const uint8_t*)e2, (uint8_t*)out, n, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point takes the family as `nw` (12, 25 or 66 words: 48-, 99- and
// 264-byte rows) and the group as `spec`, a host array of 3 nw + 1 uint32
// words (p, -p^-1 mod 2^32, R mod p, R^2 mod p; each value nw little-endian
// words, R = 2^(32 nw)); it launches on `stream` and returns
// cudaGetLastError() (0 on success).

// out[i] = base[i]^exp[i] mod p, base[i] in [0, p).
extern "C" int wide_pow_fused(const void* base, const void* exp, void* out,
                              long long n, int nw, const void* spec,
                              void* stream) {
  if (!grid_ok(n)) return (int)cudaErrorInvalidValue;
  switch (nw) {
    case 12: return launch_pow<12, 48>(base, exp, out, n, spec, stream);
    case 25: return launch_pow<25, 99>(base, exp, out, n, spec, stream);
    case 66: return launch_pow<66, 264>(base, exp, out, n, spec, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// out[i] = u1[i]^e1[i] * u2[i]^e2[i] mod p, u1[i], u2[i] in [0, p).
extern "C" int wide_dual_pow_fused(const void* u1, const void* e1,
                                   const void* u2, const void* e2, void* out,
                                   long long n, int nw, const void* spec,
                                   void* stream) {
  if (!grid_ok(n)) return (int)cudaErrorInvalidValue;
  switch (nw) {
    case 12: return launch_dual<12, 48>(u1, e1, u2, e2, out, n, spec, stream);
    case 25: return launch_dual<25, 99>(u1, e1, u2, e2, out, n, spec, stream);
    case 66: return launch_dual<66, 264>(u1, e1, u2, e2, out, n, spec, stream);
  }
  return (int)cudaErrorInvalidValue;
}
