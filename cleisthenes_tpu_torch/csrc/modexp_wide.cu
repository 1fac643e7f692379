// Batched Montgomery exponentiation for groups wider than 256 bits, on
// Hopper (sm_90a): a team of lanes per exponentiation, a fixed window,
// tables and exponents in shared memory.
//
// Replaces the TPU kernels of cleisthenes_tpu/ops/modmath.py (K12):
//   _wide_kernels(lay) (:313) -> pow_fused (:351)       wide_pow_fused: b^e mod p
//                             -> dual_pow_fused (:378)  wide_dual_pow_fused:
//                                                       u1^e1 * u2^e2 mod p
// on the reference's Montgomery core (_make_mont_mul, :425), for its three
// wide limb families: <= 384 bits (48-byte values; GROUP384, the width of
// BLS12-381's base field), <= 792 bits (99 bytes; the 768-bit Oakley group)
// and <= 2112 bits (264 bytes; the 2048-bit MODP-14 group).
//
// Byte contract (the reference's): values are VB-byte little-endian rows,
// already reduced mod p on the host; exponents are VB-byte big-endian rows;
// results are VB-byte little-endian rows in [0, p).  The group is an
// argument (WideSpec: p, -p^-1 mod 2^32, R mod p, R^2 mod p for
// R = 2^(32 NW)), so one build of a family serves every odd modulus that
// fits it.  A value is NW = 12, 25 or 66 32-bit words (the 99-byte family
// pads its top word: radix 2^800 against the reference's 2^792; only the
// normal-domain result has to match).
//
// What bounds it.  Integer multiply-add work at the card's INT32 rate: an
// exponentiation is hundreds to thousands of Montgomery products on two or
// three rows of I/O, so bytes never bound it.  The design keeps the ALUs
// of every SM fed:
// - a team of T lanes per exponentiation (Plan::T, one per family), each
//   lane holding K = ceil(NW / T) words of the accumulator, of p and of the
//   right operand in registers, multiplied by the team CIOS product of
//   csrc/mont_team.cuh.  The plans (wide_sweep.py times the others):
//   at 12 words T = 1, a lane per exponentiation with every word in
//   registers and no shuffle, fastest at the GROUP384 epoch's 98,304
//   exponentiations; at 25 and 66 words T = 32, a warp per
//   exponentiation (1 and 3 words a lane), fastest at the batches of 512
//   and 128 that these groups see, with nothing in local memory.  Blocks
//   of Plan::THREADS lanes spread the teams over the card's 132 SMs;
// - a fixed window with a warp-uniform schedule: each exponentiation builds
//   a table of 2^w Montgomery-domain powers of its base, then walks w-bit
//   digits from the warp's first nonzero digit position: w squarings and a
//   table product per digit, with no per-lane branch.  A zero digit
//   multiplies by entry 0 (R mod p), unless every team of the warp has a
//   zero digit there, when the product is skipped.  The dual pow keeps a
//   table per base over one shared chain of squarings, so a warp of
//   Lagrange rows (u2 = 1, e2 = 0) skips the second table and all its
//   products (the engine's calls send those rows after the CP rows);
// - tables and exponents in shared memory: a table is word-major with the
//   block's lane index fastest, so a warp's loads of any entries hit 32
//   distinct banks; a block stages its exponent and base rows (and its
//   results) through shared memory with 16-byte coalesced copies.
// No tensor cores: each row multiplies its own two operands, so only the
// m * p half of a product shares an operand across rows, and an int8-MMA
// product would need the kernel near its ALU bound first.
// ptxas's registers, stack and spills per family, and the instructions of
// one team product, are printed by csrc/sass_ops.py.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mont_team.cuh"

namespace {

template <int NW>
struct WideSpec {
  uint32_t p[NW];
  uint32_t pinv;     // -p^-1 mod 2^32
  uint32_t one[NW];  // R mod p: 1 in the Montgomery domain
  uint32_t r2[NW];   // R^2 mod p: into the Montgomery domain
};

// The one plan of each family (csrc/sass_ops.py and the tests read them
// from these lines).
using Plan12 = Plan<12, 48, 1, 4, 3, 128, 2>;
using Plan25 = Plan<25, 99, 32, 5, 5, 128, 4>;
using Plan66 = Plan<66, 264, 32, 5, 5, 128, 2>;

// Shared memory of a launch: nexp staged exponent rows per team, then
// ntab tables of 2^w entries (K words a lane, lane index fastest).  The
// table area first stages the bases and last the results.
template <class P>
constexpr int smem_bytes(int nexp, int ntab, int w) {
  return nexp * round16(P::TEAMS * P::VB) + ntab * (1 << w) * P::K * P::THREADS * 4;
}

template <class P>
__global__ void __launch_bounds__(P::THREADS, P::MIN_BLOCKS)
wide_pow_kernel(const uint8_t* __restrict__ base, const uint8_t* __restrict__ exp,
                uint8_t* __restrict__ out, long long n,
                const __grid_constant__ WideSpec<P::NW> s) {
  constexpr int K = P::K, VB = P::VB, W = P::W;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ex = smem;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + round16(P::TEAMS * VB));
  uint8_t* buf = reinterpret_cast<uint8_t*>(tab);  // bases in, results out
  const long long first = (long long)blockIdx.x * P::TEAMS;
  const int rows = (int)(n - first < P::TEAMS ? n - first : P::TEAMS);
  stage_in<P>(ex, exp + first * VB, rows * VB, P::TEAMS * VB);
  stage_in<P>(buf, base + first * VB, rows * VB, P::TEAMS * VB);
  __syncthreads();
  const Lane<P> L = make_lane<P>(s);
  const int team = threadIdx.x / P::T;
  const uint8_t* er = ex + team * VB;
  uint32_t x[K], y[K], acc[K];
  row_words<P>(buf + team * VB, L.tl, x);
  const int top = warp_max(top_digit<P, W>(er));
  __syncthreads();  // the bases are read: the tables take the area
  spec_slice<P>(s.one, L.tl, acc);
  if (top >= 0) {
    store_entry<P>(tab, 0, acc);
    spec_slice<P>(s.r2, L.tl, y);
    team_prod<P>(x, x, y, L);  // x R mod p
    build_table<P, W>(tab, x, L);
    load_entry<P>(tab, digit_at<P, W>(er, top), acc);
#pragma unroll 1
    for (int d = top - 1; d >= 0; --d) {
#pragma unroll 1
      for (int q = 0; q < W; ++q) team_prod<P>(acc, acc, acc, L);
      const uint32_t dv = digit_at<P, W>(er, d);
      if (__any_sync(kFull, dv != 0)) {
        load_entry<P>(tab, (int)dv, y);
        team_prod<P>(acc, acc, y, L);
      }
    }
  }
  unit_slice<P>(L.tl, y);
  team_prod<P>(acc, acc, y, L);
  __syncthreads();  // every table read is done: the area takes the results
  row_bytes<P>(buf + team * VB, L.tl, acc);
  __syncthreads();
  stage_out<P>(out + first * VB, buf, rows * VB);
}

template <class P>
__global__ void __launch_bounds__(P::THREADS, P::MIN_BLOCKS)
wide_dual_pow_kernel(const uint8_t* __restrict__ u1, const uint8_t* __restrict__ e1,
                     const uint8_t* __restrict__ u2, const uint8_t* __restrict__ e2,
                     uint8_t* __restrict__ out, long long n,
                     const __grid_constant__ WideSpec<P::NW> s) {
  constexpr int K = P::K, VB = P::VB, W = P::WD;
  constexpr int ROWS = round16(P::TEAMS * VB);
  constexpr int ENTRIES = 1 << W;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ex1 = smem;
  uint8_t* ex2 = smem + ROWS;
  uint32_t* tab1 = reinterpret_cast<uint32_t*>(smem + 2 * ROWS);
  uint32_t* tab2 = tab1 + ENTRIES * K * P::THREADS;
  uint8_t* buf = reinterpret_cast<uint8_t*>(tab1);  // bases in, results out
  const long long first = (long long)blockIdx.x * P::TEAMS;
  const int rows = (int)(n - first < P::TEAMS ? n - first : P::TEAMS);
  stage_in<P>(ex1, e1 + first * VB, rows * VB, P::TEAMS * VB);
  stage_in<P>(ex2, e2 + first * VB, rows * VB, P::TEAMS * VB);
  stage_in<P>(buf, u1 + first * VB, rows * VB, P::TEAMS * VB);
  stage_in<P>(buf + ROWS, u2 + first * VB, rows * VB, P::TEAMS * VB);
  __syncthreads();
  const Lane<P> L = make_lane<P>(s);
  const int team = threadIdx.x / P::T;
  const uint8_t* er1 = ex1 + team * VB;
  const uint8_t* er2 = ex2 + team * VB;
  uint32_t x1[K], x2[K], y[K], acc[K];
  row_words<P>(buf + team * VB, L.tl, x1);
  row_words<P>(buf + ROWS + team * VB, L.tl, x2);
  const int top1 = top_digit<P, W>(er1);
  const int top2 = top_digit<P, W>(er2);
  const int top = warp_max(top1 > top2 ? top1 : top2);
  const bool any1 = __any_sync(kFull, top1 >= 0);
  const bool any2 = __any_sync(kFull, top2 >= 0);
  __syncthreads();  // the bases are read: the tables take the area
  spec_slice<P>(s.one, L.tl, acc);
  if (top >= 0) {
    store_entry<P>(tab1, 0, acc);
    store_entry<P>(tab2, 0, acc);
    spec_slice<P>(s.r2, L.tl, y);
    if (any1) {
      team_prod<P>(x1, x1, y, L);
      build_table<P, W>(tab1, x1, L);
    }
    if (any2) {
      team_prod<P>(x2, x2, y, L);
      build_table<P, W>(tab2, x2, L);
    }
    load_entry<P>(tab1, digit_at<P, W>(er1, top), acc);
#pragma unroll 1
    for (int d = top;; --d) {
      const uint32_t d2 = digit_at<P, W>(er2, d);
      if (__any_sync(kFull, d2 != 0)) {
        load_entry<P>(tab2, (int)d2, y);
        team_prod<P>(acc, acc, y, L);
      }
      if (d == 0) break;
#pragma unroll 1
      for (int q = 0; q < W; ++q) team_prod<P>(acc, acc, acc, L);
      const uint32_t d1 = digit_at<P, W>(er1, d - 1);
      if (__any_sync(kFull, d1 != 0)) {
        load_entry<P>(tab1, (int)d1, y);
        team_prod<P>(acc, acc, y, L);
      }
    }
  }
  unit_slice<P>(L.tl, y);
  team_prod<P>(acc, acc, y, L);
  __syncthreads();  // every table read is done: the area takes the results
  row_bytes<P>(buf + team * VB, L.tl, acc);
  __syncthreads();
  stage_out<P>(out + first * VB, buf, rows * VB);
}

template <int NW>
inline bool spec_from(const void* words, WideSpec<NW>* s) {
  if (words == nullptr) return false;
  static_assert(sizeof(WideSpec<NW>) == (3 * NW + 1) * sizeof(uint32_t),
                "spec layout");
  memcpy(s, words, sizeof(WideSpec<NW>));
  return (s->p[0] & 1u) != 0;
}

template <class P>
inline bool grid_of(long long n, unsigned* blocks) {
  if (n < 1) return false;
  const long long b = (n + P::TEAMS - 1) / P::TEAMS;
  if (b > 0x7FFFFFFFll) return false;
  *blocks = (unsigned)b;
  return true;
}

template <class P>
int launch_pow(const void* base, const void* exp, void* out, long long n,
               const void* spec, void* stream) {
  WideSpec<P::NW> s;
  unsigned blocks;
  if (!spec_from<P::NW>(spec, &s) || !grid_of<P>(n, &blocks))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<P>(1, 1, P::W);
  static_assert(P::TEAMS * P::VB <= (1 << P::W) * P::K * P::THREADS * 4, "staging");
  static_assert(smem_fits<P>(smem), "MIN_BLOCKS blocks' shared memory fits an SM");
  cudaError_t rc = cudaFuncSetAttribute(
      wide_pow_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  wide_pow_kernel<P><<<blocks, P::THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)base, (const uint8_t*)exp, (uint8_t*)out, n, s);
  return (int)cudaGetLastError();
}

template <class P>
int launch_dual(const void* u1, const void* e1, const void* u2, const void* e2,
                void* out, long long n, const void* spec, void* stream) {
  WideSpec<P::NW> s;
  unsigned blocks;
  if (!spec_from<P::NW>(spec, &s) || !grid_of<P>(n, &blocks))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<P>(2, 2, P::WD);
  static_assert(2 * round16(P::TEAMS * P::VB) <= 2 * (1 << P::WD) * P::K * P::THREADS * 4,
                "staging");
  static_assert(smem_fits<P>(smem), "MIN_BLOCKS blocks' shared memory fits an SM");
  cudaError_t rc = cudaFuncSetAttribute(
      wide_dual_pow_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  wide_dual_pow_kernel<P><<<blocks, P::THREADS, smem, (cudaStream_t)stream>>>(
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
  switch (nw) {
    case 12: return launch_pow<Plan12>(base, exp, out, n, spec, stream);
    case 25: return launch_pow<Plan25>(base, exp, out, n, spec, stream);
    case 66: return launch_pow<Plan66>(base, exp, out, n, spec, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// out[i] = u1[i]^e1[i] * u2[i]^e2[i] mod p, u1[i], u2[i] in [0, p).
extern "C" int wide_dual_pow_fused(const void* u1, const void* e1,
                                   const void* u2, const void* e2, void* out,
                                   long long n, int nw, const void* spec,
                                   void* stream) {
  switch (nw) {
    case 12: return launch_dual<Plan12>(u1, e1, u2, e2, out, n, spec, stream);
    case 25: return launch_dual<Plan25>(u1, e1, u2, e2, out, n, spec, stream);
    case 66: return launch_dual<Plan66>(u1, e1, u2, e2, out, n, spec, stream);
  }
  return (int)cudaErrorInvalidValue;
}
