// Batched Montgomery modular exponentiation on Hopper (sm_90a).
//
// Replaces the TPU kernels of cleisthenes_tpu/ops/modmath.py:
//   K7  _pow_fused (:551)          pow_fused: b^e mod p, a fixed window per
//                                  warp over rows ordered by exponent length
//   K8  _dual_pow_fused (:592)     dual_pow_fused: u1^e1 * u2^e2 mod p, a
//                                  fixed window per base over one chain of
//                                  squarings
//   K9  _pow_fused_grouped (:639)  comb_table + comb_apply: the fixed-base
//                                  comb of width W, T[k][j] = base^(j 2^(W k))
//                                  per distinct base, then ceil(256 / W) - 1
//                                  table products per exponent, each
//                                  exponent naming its base's table by an
//                                  int32 row index
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
// TPU's int32 vector unit.  Here a value is 8 x 32-bit limbs in registers
// and the product is CIOS Montgomery with 32 x 32 -> 64-bit multiplies, the
// team product of csrc/mont_team.cuh (one lane, or a team of lanes that
// share a value's words).  Two hazards of that layout:
// - p's top bit may be set (the default p = 0xFFB2...), so with R = 2^256 the
//   CIOS intermediate reaches 2p > 2^256: it keeps a ninth (carry) word and
//   the final conditional subtract compares all 257 bits;
// - an input value may lie in [p, 2^264) (the reference's device path passes
//   such bases through unreduced): team_to_mont folds the 33rd byte h as
//   x*R = lo*R + h*R^2, i.e. mont(lo, R^2) + mont(h, R^3) mod p.
//
// What bounds each kernel on the H100.  An exponentiation is hundreds of
// Montgomery products on ~100 bytes of I/O, so the work is 32-bit integer
// instructions, never bytes: csrc/sass_ops.py counts a one-lane product's
// 431, 212 on the INT32 pipe and 202 IMADs on the FMA pipe (64 lanes an SM
// each, the CUDA C++ Programming Guide's arithmetic-throughput table), so
// the issue rate of one instruction a clock per SM sub-partition binds;
// where too few products run at once, the latency of a product's chain of
// dependent instructions.
// - K8 at a call of many waves (the N=512 epoch's 350,208 rows) is bound by
//   issue: DualPlan keeps a lane a row with its base tables (2^WD entries
//   each, 3-bit window) in shared memory, six blocks of 64 an SM; a warp of
//   Lagrange rows (u2 = 1, e2 = 0, sent last by the engine) builds no
//   second table and makes none of its products, and a digit that is zero
//   in the whole warp is skipped.  A call of one wave (the N=128 epoch's
//   22,016 rows) is bound by the latency of its rows' ~400 dependent
//   products: DualSmallPlan's 4-bit window makes fewer of them, in blocks
//   of 32 that spread the rows evenly over the SMs.  In modexp_sweep.py
//   teams of 2 or 4 lanes ran no faster at N=128 and slower at N=512.
// - K9's table build is bound by latency: the chain base^(2^(W k)) is
//   W (rows - 1) dependent squarings per base; a team of 4 lanes a product
//   shortens each (shuffles make 8 slower), and the block's other warps
//   fill each group of rows as the chain passes it.  The accumulation is
//   bound by issue (one lane an exponent, the next table entry's load
//   issued before the current product); the width W = 7 makes the
//   fewest products at both epochs' shapes among the widths whose tables
//   all fit the 50 MB L2 at N=128 (257 x 148 KiB); at N=512 (1,025 tables)
//   a block's consecutive exponents share a base, so the tables in use at
//   once stay in L2.
// - K7 is bound like K8: by issue at a call of many waves, by a row's chain
//   of dependent products at a call of one wave.  Its callers' exponents
//   are of every length (the DKG's j^k mod q: 1 for k = 0, 2^k for j = 2,
//   full length once j^k wraps q), and a warp-uniform loop pays for its
//   longest row, so at a call of many waves (PowPlan: a lane a row, blocks
//   sized for residency) the entry point first orders the rows by exponent
//   bit length, longest first (a counting sort: keys and histogram, then a
//   scatter of row indices; pow_keys_kernel, pow_scatter_kernel), and the
//   pow kernel reads its rows through that permutation and writes each
//   result to its own row.  A call that fits one wave of PowSmallPlan's
//   blocks (teams of lanes, blocks of one warp spread over every SM, a
//   shorter chain a product) takes as long as its longest row whatever
//   the order, so it skips the sort (modexp_sweep.py: the sort's passes
//   cost it 0.01 ms at the 5,504-row decrypt combine).  A warp takes the
//   window W in 1..Plan::W that makes the fewest products for its longest
//   exponent (pow_window: 1 bit for the shortest warps), builds its table
//   b^0 .. b^(2^W - 1) in shared memory and runs W squarings a digit from
//   its top digit, with a table product unless the whole warp's digit is
//   zero; a warp of zero exponents makes none of them.
// - K10 is one product on 66 bytes in and 33 out, so at a call of a
//   million rows the bytes bind (3.35 TB/s), at the 16,384 rows of a small
//   call the launch and one product's chain.  A warp stages its 32 rows'
//   a and b (1,056 bytes each, 66 granules) in shared memory with coalesced
//   16-byte loads, a lane builds its row's eight words and 33rd byte from
//   nine aligned words with funnel shifts (33 t mod 4 is the byte offset),
//   makes one one-lane product, and writes its row back as eight aligned
//   words, the word it shares with the row before it joined by a shuffle,
//   for the warp to store with 16-byte stores.  Warps stage and store alone
//   (no block barrier); blocks of 32 to 128 threads spread the rows over
//   every SM.  A value need not be reduced: a warp where some lane's a or b
//   is not below 2^256, or both are not below p, reduces both first
//   (team_to_mont, then a product by 1), as the pows take their bases.
// ptxas's registers and spills per kernel are printed by csrc/sass_ops.py.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "mont_team.cuh"

namespace {

constexpr int kMulThreads = 128;  // K10's largest block
constexpr int kWords = 8;          // 8 x 32-bit limbs: R = 2^256
constexpr int kSpecWords = 33;     // p, pinv, one, r2, r3
constexpr int kExpBytes = 32;      // an exponent row (big-endian)
constexpr int kValBytes = 33;      // a value row (little-endian, 264-bit)

struct MontSpec {
  uint32_t p[kWords];
  uint32_t pinv;  // -p^-1 mod 2^32
  uint32_t one[kWords];  // R mod p: 1 in the Montgomery domain
  uint32_t r2[kWords];   // R^2 mod p: into the Montgomery domain
  uint32_t r3[kWords];   // R^3 mod p: folds an input's 33rd byte
};

// The team product (csrc/mont_team.cuh, 8 words) serves every kernel here:
// with one lane (Plan1) K10 below, one thread a row, and K7, K8 and K9 with
// their plans.
using Plan1 = Plan<8, 32, 1, 1, 1, kMulThreads, 1>;

// This lane's K words of a staged 33-byte little-endian value row (its low
// 32 bytes); returns the 33rd byte.
template <class P>
__device__ __forceinline__ uint32_t value_words(const uint8_t* row, int tl,
                                                uint32_t w[P::K]) {
  row_words<P>(row, tl, w);
  return row[kExpBytes];
}

// x * R mod p across the team for the 264-bit value lo + h * 2^256 (h the
// same in every lane of a team): mont(lo, R^2) + mont(h, R^3).  Every lane
// of the warp calls it.
template <class P>
__device__ __forceinline__ void team_to_mont(uint32_t r[P::K], const uint32_t lo[P::K],
                                             uint32_t h, const MontSpec& s,
                                             const Lane<P>& L) {
  uint32_t y[P::K];
  spec_slice<P>(s.r2, L.tl, y);
  if (__any_sync(kFull, h != 0)) {
    uint32_t hv[P::K], z[P::K];
#pragma unroll
    for (int k = 0; k < P::K; ++k) hv[k] = (L.tl == 0 && k == 0) ? h : 0u;
    spec_slice<P>(s.r3, L.tl, z);
    team_prod<P>(z, hv, z, L);
    team_prod<P>(r, lo, y, L);
    team_add<P>(r, r, z, L);
  } else {
    team_prod<P>(r, lo, y, L);
  }
}

// x < p as a 33-byte little-endian row (byte 32 is zero).
__device__ __forceinline__ void store_value(uint8_t* dst, const uint32_t x[kWords]) {
  row_bytes<Plan1>(dst, 0, x);
  dst[kExpBytes] = 0;
}

// K10's staging: a warp's 32 value rows, 1,056 bytes (66 granules).
constexpr int kWarpRowBytes = 32 * kValBytes;
static_assert(kWarpRowBytes % 16 == 0, "a warp's rows are whole granules");

// Lane t's 33-byte row of a warp's staged rows (row t at byte 33 t, byte
// offset t mod 4 in its first word): its eight little-endian words in x,
// its 33rd byte returned; nine aligned 32-bit reads, which the 32 lanes
// make on 32 distinct banks.
__device__ __forceinline__ uint32_t staged_value(const uint32_t* rows, unsigned lane,
                                                 uint32_t x[kWords]) {
  const uint32_t* at = rows + (kValBytes * lane >> 2);
  const int sh = 8 * (int)(lane & 3u);
  uint32_t v[kWords + 1];
#pragma unroll
  for (int j = 0; j <= kWords; ++j) v[j] = at[j];
#pragma unroll
  for (int j = 0; j < kWords; ++j) x[j] = __funnelshift_r(v[j], v[j + 1], sh);
  return (v[kWords] >> sh) & 0xFFu;
}

// Lane t's result x < p (33rd byte zero) into its row of the warp's rows:
// the eight aligned words from the one holding its first byte on, the word
// it shares with row t - 1 joined with that lane's part by a shuffle, and
// the ninth word only where no row shares it (t mod 4 = 3).  Every lane of
// the warp calls it.
__device__ __forceinline__ void put_value(uint32_t* rows, unsigned lane,
                                          const uint32_t x[kWords]) {
  uint32_t* at = rows + (kValBytes * lane >> 2);
  const int s = (int)(lane & 3u);
  uint32_t o[kWords + 1];
  o[0] = x[0] << (8 * s);
#pragma unroll
  for (int j = 1; j < kWords; ++j) o[j] = __funnelshift_l(x[j - 1], x[j], 8 * s);
  o[kWords] = __funnelshift_l(x[kWords - 1], 0u, 8 * s);
  const uint32_t before = __shfl_up_sync(kFull, o[kWords], 1);
  if (s > 0) o[0] |= before;
#pragma unroll
  for (int j = 0; j < kWords; ++j) at[j] = o[j];
  if (s == 3) at[kWords] = o[kWords];
}

// x < p, for x of the row's eight words and 33rd byte h.
__device__ __forceinline__ bool below_p(const uint32_t x[kWords], uint32_t h,
                                        const Lane<Plan1>& L) {
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j)
    borrow = (uint32_t)(((uint64_t)x[j] - L.p[j] - borrow) >> 63);
  return h == 0 && borrow != 0;
}

// x mod p in place, for x of the row's eight words and 33rd byte h:
// x R mod p (team_to_mont), then a product by 1.  Every lane of the warp
// calls it.
__device__ __forceinline__ void reduce_value(uint32_t x[kWords], uint32_t h,
                                             const MontSpec& s, const Lane<Plan1>& L) {
  uint32_t xm[kWords], one[kWords];
  team_to_mont<Plan1>(xm, x, h, s, L);
  unit_slice<Plan1>(0, one);
  team_prod<Plan1>(x, xm, one, L);
}

// out[i] = a[i] b[i] / 2^256 mod p for rows of any value below 2^264: warp
// w of the grid takes rows [32 w, 32 w + 32), staged in its 2,112 bytes of
// shared memory (a's rows, then b's; the results go back over a's).
__global__ void mont_mul_kernel(const uint8_t* __restrict__ a,
                                const uint8_t* __restrict__ b,
                                uint8_t* __restrict__ out, long long n,
                                const __grid_constant__ MontSpec s) {
  extern __shared__ __align__(16) uint8_t smem[];
  const unsigned lane = threadIdx.x & 31u;
  const int warp = (int)(threadIdx.x >> 5);
  const long long first = ((long long)blockIdx.x * blockDim.x + warp * 32);
  if (first >= n) return;  // a whole warp past the rows
  const int here = (int)min(32ll, n - first);
  uint8_t* sa = smem + warp * 2 * kWarpRowBytes;
  uint8_t* sb = sa + kWarpRowBytes;
  copy_in(sa, a + first * kValBytes, here * kValBytes, here * kValBytes, (int)lane, 32);
  copy_in(sb, b + first * kValBytes, here * kValBytes, here * kValBytes, (int)lane, 32);
  __syncwarp();
  const Lane<Plan1> L = make_lane<Plan1>(s);
  uint32_t x[kWords], y[kWords];
  const uint32_t hx = staged_value(reinterpret_cast<const uint32_t*>(sa), lane, x);
  const uint32_t hy = staged_value(reinterpret_cast<const uint32_t*>(sb), lane, y);
  // one product when a < 2^256 and b < p, or the other way round
  const bool y_low = below_p(y, hy, L);
  const bool direct = (int)lane >= here ||
                      (y_low ? hx == 0 : (hy == 0 && below_p(x, hx, L)));
  if (__all_sync(kFull, direct)) {
    uint32_t l[kWords], r[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      l[j] = y_low ? x[j] : y[j];
      r[j] = y_low ? y[j] : x[j];
    }
    team_prod<Plan1>(x, l, r, L);
  } else {
    reduce_value(x, hx, s, L);
    reduce_value(y, hy, s, L);
    team_prod<Plan1>(x, x, y, L);
  }
  __syncwarp();  // every lane has read its rows
  put_value(reinterpret_cast<uint32_t*>(sa), lane, x);
  __syncwarp();
  copy_out(out + first * kValBytes, sa, here * kValBytes, (int)lane, 32);
}

// K7's, K8's and K9's plans: a plan's VB is the 32-byte exponent row (a
// value row adds the 33rd byte that team_to_mont folds).  The plans
// (csrc/sass_ops.py, modexp_sweep.py and the tests read them from these
// lines): Plan<NW, VB, T, W, WD, THREADS, MIN_BLOCKS>.  K7: a team of T
// lanes a row and a table of up to 2^W entries (a warp picks its window in
// 1..W), PowSmallPlan for a call that fits one wave of its resident
// blocks, PowPlan (rows ordered by length) for a longer one (pow_fused;
// modexp_sweep.py times the others); K8: a team of T lanes a row
// and a table of 2^WD entries per base, DualSmallPlan and DualPlan alike
// (dual_pow_fused); K9: the chain's team T, the comb's width W (its table
// T[k][j] = base^(j 2^(W k)) has ceil(256 / W) rows of 2^W entries) and
// comb_apply's block.
using PowPlan = Plan<8, 32, 1, 4, 4, 64, 6>;
using PowSmallPlan = Plan<8, 32, 4, 4, 4, 32, 16>;
using DualPlan = Plan<8, 32, 1, 3, 3, 64, 6>;
using DualSmallPlan = Plan<8, 32, 1, 4, 4, 32, 6>;
using CombPlan = Plan<8, 32, 4, 7, 7, 128, 4>;

__host__ __device__ constexpr int comb_rows(int w) { return (8 * kExpBytes + w - 1) / w; }

// K7's row order.  A row's key is 256 less its exponent's bit length, so
// key 0 holds the longest rows and key 256 the zero exponents; the
// counting sort's workspace (int32, after the n-entry permutation) holds
// the histogram of keys, each key's cursor and the blocks' ticket.
constexpr int kKeys = 8 * kExpBytes + 1;
constexpr int kSortWords = 515;
static_assert(kSortWords == 2 * kKeys + 1, "histogram, cursors, ticket");
constexpr int kSortThreads = 512;
constexpr int kSortBlocks = 264;  // a grid of two blocks an SM
static_assert(kSortThreads >= kKeys, "one key a thread in the scan");

// The bit length of a 32-byte big-endian exponent row (0 for zero).
__device__ __forceinline__ int exp_bits(const uint8_t* e) {
  int j = 0;
  while (j < kExpBytes && e[j] == 0) ++j;
  return j == kExpBytes ? 0 : 8 * (kExpBytes - 1 - j) + 32 - __clz((int)e[j]);
}

// Pass 1: the keys' histogram (a block's in shared memory, added to the
// workspace's), then in the block that finishes last the cursors, an
// exclusive scan of the histogram: key k's rows go to [cursor[k],
// cursor[k + 1]).
__global__ void __launch_bounds__(kSortThreads)
pow_keys_kernel(const uint8_t* __restrict__ exp, long long n, uint32_t* ws) {
  __shared__ uint32_t hist[kKeys];
  __shared__ uint32_t warp_sum[kSortThreads / 32];
  __shared__ bool last;
  for (int k = threadIdx.x; k < kKeys; k += kSortThreads) hist[k] = 0;
  __syncthreads();
  for (long long i = (long long)blockIdx.x * kSortThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kSortThreads)
    atomicAdd(&hist[8 * kExpBytes - exp_bits(exp + i * kExpBytes)], 1u);
  __syncthreads();
  for (int k = threadIdx.x; k < kKeys; k += kSortThreads)
    if (hist[k]) atomicAdd(&ws[k], hist[k]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&ws[2 * kKeys], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  const uint32_t v = threadIdx.x < kKeys ? __ldcg(&ws[threadIdx.x]) : 0u;
  uint32_t x = v;  // inclusive scan within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= (unsigned)o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t t = lane < kSortThreads / 32 ? warp_sum[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, t, o);
      if (lane >= (unsigned)o) t += y;
    }
    if (lane < kSortThreads / 32) warp_sum[lane] = t;
  }
  __syncthreads();
  if (threadIdx.x < kKeys) ws[kKeys + threadIdx.x] = (warp ? warp_sum[warp - 1] : 0u) + x - v;
}

// Pass 2: every row's index into its key's span of the permutation; the
// lanes of a warp that share a key take their places with one atomic.
__global__ void __launch_bounds__(kSortThreads)
pow_scatter_kernel(const uint8_t* __restrict__ exp, long long n, uint32_t* cursor,
                   int32_t* __restrict__ perm) {
  const unsigned lane = threadIdx.x & 31u;
  for (long long w0 = (long long)blockIdx.x * kSortThreads + (threadIdx.x & ~31u); w0 < n;
       w0 += (long long)gridDim.x * kSortThreads) {
    const long long i = w0 + lane;
    const unsigned active = __ballot_sync(kFull, i < n);
    if (i < n) {
      const int key = 8 * kExpBytes - exp_bits(exp + i * kExpBytes);
      const unsigned peers = __match_any_sync(active, key);
      const int leader = __ffs(peers) - 1;
      uint32_t at = 0;
      if ((int)lane == leader) at = atomicAdd(&cursor[key], (uint32_t)__popc(peers));
      at = __shfl_sync(peers, at, leader);
      perm[at + __popc(peers & ((1u << lane) - 1u))] = (int32_t)i;
    }
  }
}

// The window of a warp whose longest exponent has `bits` bits: the w in
// 1..wmax with the fewest products beyond the conversions, its table's
// 2^w - 2 and, for each digit after the top one, w squarings and a table
// product (the lesser w on a tie).
__host__ __device__ constexpr int pow_window(int bits, int wmax) {
  int best = 1, least = 0x7FFFFFFF;
  for (int w = 1; w <= wmax; ++w) {
    const int cost = (1 << w) - 2 + ((bits + w - 1) / w - 1) * (w + 1);
    if (cost < least) {
      least = cost;
      best = w;
    }
  }
  return best;
}

// The w-bit digit d (0 = least significant) of a staged exponent row, for
// a window w chosen at run time.
__device__ __forceinline__ uint32_t digit_w(const uint8_t* e, int d, int w) {
  const int bit = d * w;
  const int byte = bit >> 3;
  uint32_t x = e[kExpBytes - 1 - byte];
  if (byte + 1 < kExpBytes) x |= (uint32_t)e[kExpBytes - 2 - byte] << 8;
  return (x >> (bit & 7)) & ((1u << w) - 1u);
}

// Shared memory of a pow launch: the teams' staged exponent rows, then a
// table of 2^W entries (K words a lane, lane index fastest).
template <class P>
constexpr int pow_smem() {
  return round16(P::TEAMS * kExpBytes) + (1 << P::W) * P::K * P::THREADS * 4;
}

// K7: out[r] = base[r]^exp[r] mod p, a team of P::T lanes a row, the rows
// read through `perm` (none: in order).  A team past the last row repeats
// the last one and stores nothing: every lane of the warp runs the votes.
template <class P>
__global__ void __launch_bounds__(P::THREADS, P::MIN_BLOCKS)
pow_kernel(const uint8_t* __restrict__ base, const uint8_t* __restrict__ exp,
           const int32_t* __restrict__ perm, uint8_t* __restrict__ out, long long n,
           const __grid_constant__ MontSpec s) {
  constexpr int K = P::K;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + round16(P::TEAMS * kExpBytes));
  const Lane<P> L = make_lane<P>(s);
  const int team = threadIdx.x / P::T;
  const long long i = (long long)blockIdx.x * P::TEAMS + team;
  const long long at = i < n ? i : n - 1;
  const long long row = perm ? (long long)perm[at] : at;
  uint8_t* er = smem + team * kExpBytes;
  const uint8_t* eg = exp + row * kExpBytes;
  for (int b = L.tl; b < kExpBytes; b += P::T) er[b] = eg[b];
  __syncwarp();
  const int bits = (int)__reduce_max_sync(kFull, (unsigned)exp_bits(er));
  uint32_t acc[K], y[K];
  spec_slice<P>(s.one, L.tl, acc);
  if (bits > 0) {
    const int w = pow_window(bits, P::W);
    const int top = (bits - 1) / w;
    uint32_t x[K];
    const uint32_t h = value_words<P>(base + row * kValBytes, L.tl, x);
    team_to_mont<P>(x, x, h, s, L);
    store_entry<P>(tab, 0, acc);
    store_entry<P>(tab, 1, x);
    copy_k<P>(y, x);
#pragma unroll 1
    for (int e = 2; e < (1 << w); ++e) {
      team_prod<P>(y, y, x, L);
      store_entry<P>(tab, e, y);
    }
    load_entry<P>(tab, (int)digit_w(er, top, w), acc);
#pragma unroll 1
    for (int d = top - 1; d >= 0; --d) {
#pragma unroll 1
      for (int q = 0; q < w; ++q) team_prod<P>(acc, acc, acc, L);
      const uint32_t dg = digit_w(er, d, w);
      if (__any_sync(kFull, dg != 0)) {
        load_entry<P>(tab, (int)dg, y);
        team_prod<P>(acc, acc, y, L);
      }
    }
  }
  unit_slice<P>(L.tl, y);
  team_prod<P>(acc, acc, y, L);
  if (i < n) {
    uint8_t* o = out + row * kValBytes;
    row_bytes<P>(o, L.tl, acc);
    if (L.tl == 0) o[kExpBytes] = 0;
  }
}

// Shared memory of a dual-pow launch: both staged exponent rows, then a
// table of 2^WD entries per base (K words a lane, lane index fastest).  The
// table area first stages the value rows and last the results.
template <class P>
constexpr int dual_smem() {
  return 2 * round16(P::TEAMS * kExpBytes) + 2 * (1 << P::WD) * P::K * P::THREADS * 4;
}

// K8: out = u1^e1 * u2^e2 mod p, a team of P::T lanes a row.  Both bases'
// tables, then one chain of squarings over the warp's digit positions from
// its top nonzero one, with a product for each base's digit unless the
// whole warp's digit is zero there: a warp of Lagrange rows (u2 = 1,
// e2 = 0) builds no second table and makes none of its products.
template <class P>
__global__ void __launch_bounds__(P::THREADS, P::MIN_BLOCKS)
dual_pow_kernel(const uint8_t* __restrict__ u1, const uint8_t* __restrict__ e1,
                const uint8_t* __restrict__ u2, const uint8_t* __restrict__ e2,
                uint8_t* __restrict__ out, long long n,
                const __grid_constant__ MontSpec s) {
  constexpr int K = P::K, W = P::WD;
  constexpr int EROWS = round16(P::TEAMS * kExpBytes);
  constexpr int VROWS = round16(P::TEAMS * kValBytes);
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ex1 = smem;
  uint8_t* ex2 = smem + EROWS;
  uint32_t* tab1 = reinterpret_cast<uint32_t*>(smem + 2 * EROWS);
  uint32_t* tab2 = tab1 + (1 << W) * K * P::THREADS;
  uint8_t* buf = reinterpret_cast<uint8_t*>(tab1);  // values in, results out
  const long long first = (long long)blockIdx.x * P::TEAMS;
  const int rows = (int)(n - first < P::TEAMS ? n - first : P::TEAMS);
  stage_in<P>(ex1, e1 + first * kExpBytes, rows * kExpBytes, P::TEAMS * kExpBytes);
  stage_in<P>(ex2, e2 + first * kExpBytes, rows * kExpBytes, P::TEAMS * kExpBytes);
  stage_in<P>(buf, u1 + first * kValBytes, rows * kValBytes, P::TEAMS * kValBytes);
  stage_in<P>(buf + VROWS, u2 + first * kValBytes, rows * kValBytes,
              P::TEAMS * kValBytes);
  __syncthreads();
  const Lane<P> L = make_lane<P>(s);
  const int team = threadIdx.x / P::T;
  const uint8_t* er1 = ex1 + team * kExpBytes;
  const uint8_t* er2 = ex2 + team * kExpBytes;
  uint32_t x1[K], x2[K], y[K], acc[K];
  const uint32_t h1 = value_words<P>(buf + team * kValBytes, L.tl, x1);
  const uint32_t h2 = value_words<P>(buf + VROWS + team * kValBytes, L.tl, x2);
  const int top1 = top_digit<P, W>(er1);
  const int top2 = top_digit<P, W>(er2);
  const int top = warp_max(top1 > top2 ? top1 : top2);
  const bool any1 = __any_sync(kFull, top1 >= 0);
  const bool any2 = __any_sync(kFull, top2 >= 0);
  __syncthreads();  // the values are read: the tables take the area
  spec_slice<P>(s.one, L.tl, acc);
  if (top >= 0) {
    store_entry<P>(tab1, 0, acc);
    store_entry<P>(tab2, 0, acc);
    if (any1) {
      team_to_mont<P>(x1, x1, h1, s, L);
      build_table<P, W>(tab1, x1, L);
    }
    if (any2) {
      team_to_mont<P>(x2, x2, h2, s, L);
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
  row_bytes<P>(buf + team * kValBytes, L.tl, acc);
  if (L.tl == 0) buf[team * kValBytes + kExpBytes] = 0;
  __syncthreads();
  stage_out<P>(out + first * kValBytes, buf, rows * kValBytes);
}

// Named barriers (PTX bar.arrive / bar.sync): a producer warp announces
// without waiting, consumers wait for it; n counts the threads of both.
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// K9, table: one block of kTableThreads per base row.  Warp 0 walks the
// chain s_k = base^(2^(W k)), W squarings a row, as teams of P::T lanes
// (every team the same chain; team 0 keeps each s_k in shared memory), so
// the chain's latency is that of a team product.  The other warps fill the
// rows meanwhile, kFillPhases groups of them, each as soon as the chain has
// passed it (a named barrier per group): T[k][0] = R mod p, T[k][1] = s_k,
// and in W rounds over the group's rows the entries j in (h, 2h] as
// T[k][h] T[k][j - h], h = 1, 2, 4, ..., one lane a product.  Only the last
// group's fill follows the chain.
constexpr int kTableThreads = 256;
constexpr int kFillThreads = kTableThreads - 32;
constexpr int kFillPhases = 6;
constexpr int kFillBarrier = 15;  // the fill warps' own; 1..kFillPhases: the groups'
static_assert(kFillPhases + 1 < kFillBarrier, "named barrier ids");

template <class P>
__global__ void __launch_bounds__(kTableThreads)
comb_table_kernel(const uint8_t* __restrict__ bases, uint32_t* table,
                  const __grid_constant__ MontSpec s) {
  constexpr int W = P::W, ROWS = comb_rows(W), COLS = 1 << W, K = P::K;
  using P1 = Plan<8, 32, 1, W, W, kTableThreads, 1>;
  __shared__ uint32_t chain[ROWS][kWords];
  // entries are read back in later rounds: plain loads, never the
  // read-only path
  uint4* tab = reinterpret_cast<uint4*>(table) + (long long)blockIdx.x * ROWS * COLS * 2;
  if (threadIdx.x < 32) {
    const Lane<P> L = make_lane<P>(s);
    const bool keep = threadIdx.x < P::T;
    uint32_t x[K];
    const uint32_t h = value_words<P>(bases + (long long)blockIdx.x * kValBytes, L.tl, x);
    team_to_mont<P>(x, x, h, s, L);
    int phase = 0;
#pragma unroll 1
    for (int k = 0;; ++k) {
      if (keep) {
#pragma unroll
        for (int j = 0; j < K; ++j) chain[k][L.tl * K + j] = x[j];
      }
      __threadfence_block();
      while (phase < kFillPhases && k + 1 == (phase + 1) * ROWS / kFillPhases)
        bar_arrive(1 + phase++, kTableThreads);
      if (k + 1 == ROWS) return;
#pragma unroll 1
      for (int q = 0; q < W; ++q) team_prod<P>(x, x, x, L);
    }
  }
  const Lane<P1> L1 = make_lane<P1>(s);
  const int tid = (int)threadIdx.x - 32;
#pragma unroll 1
  for (int ph = 0; ph < kFillPhases; ++ph) {
    const int r0 = ph * ROWS / kFillPhases, rows = (ph + 1) * ROWS / kFillPhases - r0;
    bar_sync(1 + ph, kTableThreads);
    for (int k = r0 + tid; k < r0 + rows; k += kFillThreads) {
      uint4* row = tab + k * COLS * 2;
      const uint32_t* sk = chain[k];
      row[0] = make_uint4(s.one[0], s.one[1], s.one[2], s.one[3]);
      row[1] = make_uint4(s.one[4], s.one[5], s.one[6], s.one[7]);
      row[2] = make_uint4(sk[0], sk[1], sk[2], sk[3]);
      row[3] = make_uint4(sk[4], sk[5], sk[6], sk[7]);
    }
    bar_sync(kFillBarrier, kFillThreads);
#pragma unroll 1
    for (int h = 1; h < COLS; h *= 2) {
      const int span = (2 * h < COLS ? 2 * h : COLS - 1) - h;  // j in (h, h + span]
#pragma unroll 1
      for (int i = tid; i < rows * span; i += kFillThreads) {
        const int k = r0 + i / span, j = h + 1 + i % span;
        const uint4* row = tab + k * COLS * 2;
        const uint4 a0 = row[2 * h], a1 = row[2 * h + 1];
        const uint4 b0 = row[2 * (j - h)], b1 = row[2 * (j - h) + 1];
        uint32_t a[kWords] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const uint32_t b[kWords] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        team_prod<P1>(a, a, b, L1);
        uint4* at = tab + (k * COLS + j) * 2;
        at[0] = make_uint4(a[0], a[1], a[2], a[3]);
        at[1] = make_uint4(a[4], a[5], a[6], a[7]);
      }
      bar_sync(kFillBarrier, kFillThreads);
    }
  }
}

// K9, accumulation: one lane per exponent, acc = prod_k T[rows[i]][k][d_k]
// over the exponent's W-bit digits d_k (a zero digit multiplies by
// T[.][k][0] = R mod p), the next entry's load issued before the current
// product.  A block's exponents are consecutive, so they share their
// base's table (the engine sends each base's exponents together); the
// block stages its exponent rows and its results through shared memory.
template <class P>
__global__ void __launch_bounds__(P::THREADS, P::MIN_BLOCKS)
comb_apply_kernel(const uint8_t* __restrict__ exps, const int32_t* __restrict__ rows,
                  const uint32_t* __restrict__ table, uint8_t* __restrict__ out,
                  long long n, const __grid_constant__ MontSpec s) {
  constexpr int W = P::W, ROWS = comb_rows(W), COLS = 1 << W;
  __shared__ __align__(16) uint8_t ex[P::THREADS * kExpBytes];
  __shared__ __align__(16) uint8_t res[round16(P::THREADS * kValBytes)];
  const long long first = (long long)blockIdx.x * P::THREADS;
  const int cnt = (int)(n - first < P::THREADS ? n - first : P::THREADS);
  stage_in<P>(ex, exps + first * kExpBytes, cnt * kExpBytes, P::THREADS * kExpBytes);
  __syncthreads();
  using P1 = Plan<8, 32, 1, W, W, P::THREADS, P::MIN_BLOCKS>;
  const Lane<P1> L = make_lane<P1>(s);
  // a lane past the end runs the block's first row with a zero exponent
  const int row = rows[first + (threadIdx.x < cnt ? threadIdx.x : 0)];
  const uint4* t = reinterpret_cast<const uint4*>(table) + (long long)row * ROWS * COLS * 2;
  const uint8_t* er = ex + threadIdx.x * kExpBytes;
  uint32_t acc[kWords], m[kWords];
  uint4 q0 = __ldg(t + 2 * digit_at<P, W>(er, 0));
  uint4 q1 = __ldg(t + 2 * digit_at<P, W>(er, 0) + 1);
  acc[0] = q0.x; acc[1] = q0.y; acc[2] = q0.z; acc[3] = q0.w;
  acc[4] = q1.x; acc[5] = q1.y; acc[6] = q1.z; acc[7] = q1.w;
  const uint4* at = t + 2 * (COLS + digit_at<P, W>(er, 1));
  q0 = __ldg(at);
  q1 = __ldg(at + 1);
#pragma unroll 1
  for (int k = 1; k < ROWS; ++k) {
    m[0] = q0.x; m[1] = q0.y; m[2] = q0.z; m[3] = q0.w;
    m[4] = q1.x; m[5] = q1.y; m[6] = q1.z; m[7] = q1.w;
    if (k + 1 < ROWS) {
      at = t + 2 * ((k + 1) * COLS + digit_at<P, W>(er, k + 1));
      q0 = __ldg(at);
      q1 = __ldg(at + 1);
    }
    team_prod<P1>(acc, acc, m, L);
  }
  unit_slice<P1>(L.tl, m);
  team_prod<P1>(acc, acc, m, L);
  store_value(res + threadIdx.x * kValBytes, acc);
  __syncthreads();
  stage_out<P>(out + first * kValBytes, res, cnt * kValBytes);
}

inline bool spec_from(const void* words, MontSpec* s) {
  if (words == nullptr) return false;
  static_assert(sizeof(MontSpec) == kSpecWords * sizeof(uint32_t), "spec layout");
  memcpy(s, words, sizeof(MontSpec));
  return (s->p[0] & 1u) != 0;
}

// K10's block: kMulThreads, halved (down to one warp) while blocks that
// large would leave SMs without one (16,384 rows take 64-thread blocks,
// 256 of them).
inline int mul_threads(long long n, int sms) {
  int t = kMulThreads;
  while (t > 32 && (n + t - 1) / t < sms) t >>= 1;
  return t;
}

template <class P>
int launch_dual(const void* u1, const void* e1, const void* u2, const void* e2,
                void* out, long long n, const void* spec, void* stream) {
  MontSpec s;
  if (n < 1 || (n + P::TEAMS - 1) / P::TEAMS > 0x7FFFFFFFll || !spec_from(spec, &s))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = dual_smem<P>();
  static_assert(2 * round16(P::TEAMS * kValBytes) <= 2 * (1 << P::WD) * P::K * P::THREADS * 4,
                "staging");
  static_assert(smem_fits<P>(smem), "MIN_BLOCKS blocks' shared memory fits an SM");
  cudaError_t rc = cudaFuncSetAttribute(
      dual_pow_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  dual_pow_kernel<P><<<(unsigned)((n + P::TEAMS - 1) / P::TEAMS), P::THREADS, smem,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)u1, (const uint8_t*)e1, (const uint8_t*)u2,
      (const uint8_t*)e2, (uint8_t*)out, n, s);
  return (int)cudaGetLastError();
}

constexpr int kMaxDevices = 64;

// cudaFuncSetAttribute once a device for a kernel's dynamic shared memory
// (a call inside a CUDA graph's capture then makes no such call).
template <class P>
cudaError_t pow_smem_ready(int dev) {
  static std::mutex mu;
  static bool ready[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (ready[dev]) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      pow_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, pow_smem<P>());
  ready[dev] = rc == cudaSuccess;
  return rc;
}

// K7 under plan P on device `dev`: with `order`, the counting sort into
// `ws` (n + kSortWords int32), then the pow through its permutation.
template <class P>
int launch_pow(const void* base, const void* exp, void* out, void* ws, long long n,
               const void* spec, void* stream, int dev, bool order) {
  MontSpec s;
  if (n < 1 || n > 0x7FFFFFFFll || !spec_from(spec, &s) || (order && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = pow_smem<P>();
  static_assert(smem_fits<P>(smem), "MIN_BLOCKS blocks' shared memory fits an SM");
  cudaError_t rc = pow_smem_ready<P>(dev);
  if (rc != cudaSuccess) return (int)rc;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* e = (const uint8_t*)exp;
  int32_t* perm = nullptr;
  if (order) {
    perm = (int32_t*)ws;
    uint32_t* sort = (uint32_t*)(perm + n);
    rc = cudaMemsetAsync(sort, 0, kSortWords * sizeof(uint32_t), st);
    if (rc != cudaSuccess) return (int)rc;
    long long blocks = (n + kSortThreads - 1) / kSortThreads;
    if (blocks > kSortBlocks) blocks = kSortBlocks;
    pow_keys_kernel<<<(unsigned)blocks, kSortThreads, 0, st>>>(e, n, sort);
    pow_scatter_kernel<<<(unsigned)blocks, kSortThreads, 0, st>>>(e, n, sort + kKeys, perm);
  }
  pow_kernel<P><<<(unsigned)((n + P::TEAMS - 1) / P::TEAMS), P::THREADS, smem, st>>>(
      (const uint8_t*)base, e, perm, (uint8_t*)out, n, s);
  return (int)cudaGetLastError();
}

template <class P>
int launch_comb_table(const void* bases, void* table, long long n_rows,
                      const void* spec, void* stream) {
  MontSpec s;
  if (n_rows < 1 || n_rows > 0x7FFFFFFFll || !spec_from(spec, &s))
    return (int)cudaErrorInvalidValue;
  comb_table_kernel<P><<<(unsigned)n_rows, kTableThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bases, (uint32_t*)table, s);
  return (int)cudaGetLastError();
}

template <class P>
int launch_comb_apply(const void* exps, const void* rows, const void* table,
                      void* out, long long n, const void* spec, void* stream) {
  MontSpec s;
  if (n < 1 || (n + P::THREADS - 1) / P::THREADS > 0x7FFFFFFFll || !spec_from(spec, &s))
    return (int)cudaErrorInvalidValue;
  comb_apply_kernel<P><<<(unsigned)((n + P::THREADS - 1) / P::THREADS), P::THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)exps, (const int32_t*)rows, (const uint32_t*)table,
      (uint8_t*)out, n, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point takes the group as `spec`, a host array of 33 uint32
// words (p, -p^-1 mod 2^32, R mod p, R^2 mod p, R^3 mod p; each value 8
// little-endian words, R = 2^256), launches on `stream` and returns
// cudaGetLastError() (0 on success).

// out[i] = a[i] * b[i] / 2^256 mod p, for a[i], b[i] in [0, 2^264); any
// alignment.
extern "C" int mont_mul(const void* a, const void* b, void* out, long long n,
                        const void* spec, void* stream) {
  MontSpec s;
  if (n < 1 || (n + 31) / 32 > 0x7FFFFFFFll || !spec_from(spec, &s))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  const int threads = mul_threads(n, sms);
  mont_mul_kernel<<<(unsigned)((n + threads - 1) / threads), threads,
                    (size_t)(threads / 32) * 2 * kWarpRowBytes, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, (uint8_t*)out, n, s);
  return (int)cudaGetLastError();
}

// out[i] = base[i]^exp[i] mod p (base in [0, 2^264)), n < 2^31.  A call
// whose rows PowSmallPlan's resident blocks hold at once runs at the
// latency of a row, in teams of lanes over every SM, in the rows' own
// order (`ws` unused, may be null); a longer call runs at the issue rate,
// a lane a row (PowPlan), on rows first ordered by exponent length in `ws`,
// scratch of n + 515 int32 (kSortWords) on the card.
extern "C" int pow_fused(const void* base, const void* exp, void* out, void* ws,
                         long long n, const void* spec, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  if (n <= (long long)sms * PowSmallPlan::MIN_BLOCKS * PowSmallPlan::TEAMS)
    return launch_pow<PowSmallPlan>(base, exp, out, ws, n, spec, stream, dev, false);
  return launch_pow<PowPlan>(base, exp, out, ws, n, spec, stream, dev, true);
}

// out[i] = u1[i]^e1[i] * u2[i]^e2[i] mod p.  A call whose rows
// DualSmallPlan's resident blocks hold at once runs at the latency of a
// row: it takes that plan's 4-bit window (fewer products, larger tables);
// a longer call runs at the issue rate, where DualPlan's 3-bit window keeps
// twice the rows resident.
extern "C" int dual_pow_fused(const void* u1, const void* e1, const void* u2,
                              const void* e2, void* out, long long n,
                              const void* spec, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  if (n <= (long long)sms * DualSmallPlan::MIN_BLOCKS * DualSmallPlan::TEAMS)
    return launch_dual<DualSmallPlan>(u1, e1, u2, e2, out, n, spec, stream);
  return launch_dual<DualPlan>(u1, e1, u2, e2, out, n, spec, stream);
}

// table (n_rows, ceil(256 / W), 2^W, 8) uint32 for CombPlan's width W:
// T[r][k][j] = bases[r]^(j * 2^(W k)) * R mod p.
extern "C" int comb_table(const void* bases, void* table, long long n_rows,
                          const void* spec, void* stream) {
  return launch_comb_table<CombPlan>(bases, table, n_rows, spec, stream);
}

// out (n, 33): out[i] = bases[rows[i]]^exps[i] mod p from comb_table's
// table; every rows[i] must lie in [0, n_rows) of that table.
extern "C" int comb_apply(const void* exps, const void* rows, const void* table,
                          void* out, long long n, const void* spec,
                          void* stream) {
  return launch_comb_apply<CombPlan>(exps, rows, table, out, n, spec, stream);
}
