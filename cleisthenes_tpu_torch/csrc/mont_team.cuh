// The team Montgomery product and what its kernels share (csrc/modexp.cu,
// csrc/modexp_wide.cu): a plan, a lane's slice of the group's constants, the
// product across a team of lanes, digits of big-endian exponent rows, tables
// and staged rows in shared memory.
//
// A value is NW 32-bit words held by a team of T lanes of a warp: lane l
// holds K = ceil(NW / T) words, all in registers.  The product is CIOS
// across the team: word a_i of the left operand is broadcast from its lane
// by a shuffle, m = t_0 * p' from the team's first lane, and each lane runs
// its K words of t + a_i b + m p, the two carry chains interleaved.  A lane's
// carry out of its top word is not passed on at once: it waits in `hi` at
// the next lane's first word, joins that word when the sum shifts down one
// word, and after the last step one resolve (a shuffle and two ballots,
// carry-lookahead over the warp's lanes) makes the sum exact.  The
// conditional subtract of p resolves its borrows the same way and compares
// every bit up to the carry word, so a p with its top bit set (t < 2p >
// 2^(32 NW)) needs nothing more.  With T = 1 a lane holds every word and no
// shuffle or ballot is left.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// One family's design: NW words in VB-byte rows, a team of T lanes, pow
// window W, dual-pow window WD (per base), THREADS lanes a block and the
// blocks an SM must hold (ptxas's register budget).
template <int NW_, int VB_, int T_, int W_, int WD_, int THREADS_, int MIN_BLOCKS_>
struct Plan {
  static constexpr int NW = NW_;
  static constexpr int VB = VB_;
  static constexpr int T = T_;
  static constexpr int W = W_;
  static constexpr int WD = WD_;
  static constexpr int THREADS = THREADS_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int K = (NW + T - 1) / T;  // words a lane holds
  static constexpr int TEAMS = THREADS / T;   // exponentiations a block
  // unroll of the product's loop over the team's lanes (code size)
  static constexpr int STEP_UNROLL = T <= 4 ? T : 1;
  static_assert(T == 1 || T == 2 || T == 4 || T == 8 || T == 16 || T == 32,
                "a team is a power-of-two part of a warp");
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");
  static_assert(W >= 1 && W <= 8 && WD >= 1 && WD <= 8, "digits span two bytes");
  static_assert(4 * NW >= VB && 4 * (NW - 1) < VB, "NW words hold VB bytes");
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// An H100's shared memory: the most a block may opt in to, and an SM's for
// all its blocks (each block also holds 1 KB the runtime reserves).
constexpr int kSmemPerBlock = 227 * 1024;
constexpr int kSmemPerSM = 228 * 1024;

template <class P>
constexpr bool smem_fits(int smem) {
  return smem <= kSmemPerBlock && P::MIN_BLOCKS * (smem + 1024) <= kSmemPerSM;
}

template <class P>
struct Lane {
  uint32_t p[P::K];  // this lane's words of p
  uint32_t pinv;
  int tl;            // lane index in the team
  unsigned lane;     // lane index in the warp
  bool top;          // the team's last lane
};

// The K words of an NW-word constant that lane tl holds (zero past NW).
template <class P>
__device__ __forceinline__ void spec_slice(const uint32_t* words, int tl,
                                           uint32_t v[P::K]) {
#pragma unroll
  for (int k = 0; k < P::K; ++k) {
    const int wi = tl * P::K + k;
    v[k] = wi < P::NW ? words[wi] : 0u;
  }
}

// S: the group's constants, with at least p[P::NW] and pinv.
template <class P, class S>
__device__ __forceinline__ Lane<P> make_lane(const S& s) {
  Lane<P> L;
  L.tl = (int)(threadIdx.x % P::T);
  L.lane = threadIdx.x & 31u;
  L.top = L.tl == P::T - 1;
  L.pinv = s.pinv;
  spec_slice<P>(s.p, L.tl, L.p);
  return L;
}

// Carry (or borrow) into each lane of the warp from the lanes below it in
// its team: gen = the lane's own carry out, prop = it passes a carry in
// through.  Carry-lookahead as one addition over the warp's lanes; a team's
// top lane is left out of both masks, so nothing crosses into the next
// team.
__device__ __forceinline__ uint32_t carry_in(bool gen, bool prop, bool top,
                                             unsigned lane) {
  const uint32_t g = __ballot_sync(kFull, gen && !top);
  const uint32_t pr = __ballot_sync(kFull, prop && !top);
  return ((((g | pr) + g) ^ pr) >> lane) & 1u;
}

// The end of a team product or sum: t (this lane's K words) with a carry
// `hi` waiting at the next lane's first word (for the team's top lane, the
// carry word above the value), the whole below 2p.  r = t mod p: the carries
// resolved, then p subtracted once if t >= p, over every bit up to the top
// carry's.  r may alias t.
template <class P>
__device__ __forceinline__ void team_settle(uint32_t r[P::K], uint32_t t[P::K],
                                            uint32_t hi, const Lane<P>& L) {
  constexpr int K = P::K;
  constexpr int T = P::T;
  uint32_t top = hi;  // the top lane's carry word (word T K)
  if constexpr (T > 1) {
    uint32_t cin = __shfl_up_sync(kFull, hi, 1, T);
    if (L.tl == 0) cin = 0;
    uint64_t c = cin;
    uint32_t ones = kFull;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      c += t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
      ones &= t[j];
    }
    const uint32_t c_own = (uint32_t)c;
    c = carry_in(c_own != 0, ones == kFull, L.top, L.lane);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      c += t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    top = L.top ? hi + c_own + (uint32_t)c : 0u;
  }
  uint32_t d[K];
  uint32_t borrow = 0, any = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint64_t x = (uint64_t)t[j] - L.p[j] - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
    any |= d[j];
  }
  bool ge;
  if constexpr (T > 1) {
    const uint32_t b_own = borrow;
    borrow = carry_in(b_own != 0, any == 0, L.top, L.lane);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint64_t x = (uint64_t)d[j] - borrow;
      d[j] = (uint32_t)x;
      borrow = (uint32_t)(x >> 63);
    }
    ge = __shfl_sync(kFull, (int)(top >= (b_own | borrow)), T - 1, T) != 0;
  } else {
    ge = top >= borrow;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) r[j] = ge ? d[j] : t[j];
}

// r = a * b / R mod p across the team, for a < R and b < p (this lane's K
// words of each).  r may alias a or b: it is written last.
template <class P>
__device__ __forceinline__ void team_prod(uint32_t r[P::K], const uint32_t a[P::K],
                                          const uint32_t b[P::K], const Lane<P>& L) {
  constexpr int K = P::K;
  constexpr int T = P::T;
  uint32_t t[K];
#pragma unroll
  for (int j = 0; j < K; ++j) t[j] = 0;
  uint32_t hi = 0;  // carry waiting at the next lane's first word
  int src = 0;
#pragma unroll (P::STEP_UNROLL)
  for (int i0 = 0; i0 < P::NW; i0 += K, ++src) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (i0 + k < P::NW) {
        uint32_t ai, m;
        if constexpr (T == 1) {
          ai = a[k];
          m = (t[0] + ai * b[0]) * L.pinv;
        } else {
          ai = __shfl_sync(kFull, a[k], src, T);
          m = __shfl_sync(kFull, (t[0] + ai * b[0]) * L.pinv, 0, T);
        }
        uint64_t c1 = 0, c2 = 0;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          c1 += (uint64_t)ai * b[j] + t[j];
          const uint32_t u = (uint32_t)c1;
          c1 >>= 32;
          c2 += (uint64_t)m * L.p[j] + u;
          t[j] = (uint32_t)c2;
          c2 >>= 32;
        }
        // shift down one word: the team's word 0 is zero (m's choice) and
        // drops out; the next lane's first word comes down to this lane's
        // last, with the carries waiting there
        uint64_t s = (uint64_t)hi + c1 + c2;
        if constexpr (T > 1) {
          const uint32_t up = __shfl_down_sync(kFull, t[0], 1, T);
          s += L.top ? 0u : up;
        }
#pragma unroll
        for (int j = 0; j + 1 < K; ++j) t[j] = t[j + 1];
        t[K - 1] = (uint32_t)s;
        hi = (uint32_t)(s >> 32);
      }
    }
  }
  team_settle<P>(r, t, hi, L);
}

// The W-bit digit d (0 = least significant) of a VB-byte big-endian row.
template <class P, int W>
__device__ __forceinline__ uint32_t digit_at(const uint8_t* e, int d) {
  const int bit = d * W;
  const int byte = bit >> 3;
  uint32_t x = e[P::VB - 1 - byte];
  if (byte + 1 < P::VB) x |= (uint32_t)e[P::VB - 2 - byte] << 8;
  return (x >> (bit & 7)) & ((1u << W) - 1u);
}

// The position of a row's top nonzero W-bit digit; -1 for zero.
template <class P, int W>
__device__ __forceinline__ int top_digit(const uint8_t* e) {
  int j = 0;
  while (j < P::VB && e[j] == 0) ++j;
  if (j == P::VB) return -1;
  const int bits = 8 * (P::VB - 1 - j) + 32 - __clz((int)e[j]);
  return (bits - 1) / W;
}

__device__ __forceinline__ int warp_max(int v) {
  return (int)__reduce_max_sync(kFull, (unsigned)(v + 1)) - 1;
}

// A table entry: this lane's K words, lane index fastest.
template <class P>
__device__ __forceinline__ void store_entry(uint32_t* tab, int e, const uint32_t v[P::K]) {
  uint32_t* at = tab + e * P::K * P::THREADS + threadIdx.x;
#pragma unroll
  for (int k = 0; k < P::K; ++k) at[k * P::THREADS] = v[k];
}

template <class P>
__device__ __forceinline__ void load_entry(const uint32_t* tab, int e, uint32_t v[P::K]) {
  const uint32_t* at = tab + e * P::K * P::THREADS + threadIdx.x;
#pragma unroll
  for (int k = 0; k < P::K; ++k) v[k] = at[k * P::THREADS];
}

template <class P>
__device__ __forceinline__ void copy_k(uint32_t r[P::K], const uint32_t x[P::K]) {
#pragma unroll
  for (int k = 0; k < P::K; ++k) r[k] = x[k];
}

// The unit 1 (normal domain): multiplying by it leaves the Montgomery domain.
template <class P>
__device__ __forceinline__ void unit_slice(int tl, uint32_t v[P::K]) {
#pragma unroll
  for (int k = 0; k < P::K; ++k) v[k] = (tl == 0 && k == 0) ? 1u : 0u;
}

// Copy of `valid` bytes from global memory into shared memory (16-byte
// aligned) by `n` threads, this one `tid`, zero-filled to `total`; 16-byte
// loads when the source is aligned.
__device__ __forceinline__ void copy_in(uint8_t* dst, const uint8_t* src, int valid,
                                        int total, int tid, int n) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const int n16 = valid >> 4;
    for (int i = tid; i < n16; i += n)
      reinterpret_cast<int4*>(dst)[i] = __ldg(reinterpret_cast<const int4*>(src) + i);
    i0 = n16 << 4;
  }
  for (int i = i0 + tid; i < total; i += n) dst[i] = i < valid ? src[i] : (uint8_t)0;
}

// The way back: `valid` bytes from shared memory (16-byte aligned) to
// global memory, 16-byte stores when the destination is aligned.
__device__ __forceinline__ void copy_out(uint8_t* dst, const uint8_t* src, int valid,
                                         int tid, int n) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
    const int n16 = valid >> 4;
    for (int i = tid; i < n16; i += n)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
    i0 = n16 << 4;
  }
  for (int i = i0 + tid; i < valid; i += n) dst[i] = src[i];
}

// Block-wide copies.
template <class P>
__device__ __forceinline__ void stage_in(uint8_t* dst, const uint8_t* src,
                                         int valid, int total) {
  copy_in(dst, src, valid, total, threadIdx.x, P::THREADS);
}

template <class P>
__device__ __forceinline__ void stage_out(uint8_t* dst, const uint8_t* src, int valid) {
  copy_out(dst, src, valid, threadIdx.x, P::THREADS);
}

// This lane's K words of a staged VB-byte little-endian row.
template <class P>
__device__ __forceinline__ void row_words(const uint8_t* row, int tl, uint32_t w[P::K]) {
#pragma unroll
  for (int k = 0; k < P::K; ++k) {
    uint32_t x = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int at = 4 * (tl * P::K + k) + b;
      if (at < P::VB) x |= (uint32_t)row[at] << (8 * b);
    }
    w[k] = x;
  }
}

template <class P>
__device__ __forceinline__ void row_bytes(uint8_t* row, int tl, const uint32_t w[P::K]) {
#pragma unroll
  for (int k = 0; k < P::K; ++k) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int at = 4 * (tl * P::K + k) + b;
      if (at < P::VB) row[at] = (uint8_t)(w[k] >> (8 * b));
    }
  }
}

// Entries 1 .. 2^w - 1 of a table whose entry 1 is x (Montgomery domain).
template <class P, int W>
__device__ __forceinline__ void build_table(uint32_t* tab, const uint32_t x[P::K],
                                            const Lane<P>& L) {
  uint32_t cur[P::K];
  copy_k<P>(cur, x);
  store_entry<P>(tab, 1, cur);
#pragma unroll 1
  for (int e = 2; e < (1 << W); ++e) {
    team_prod<P>(cur, cur, x, L);
    store_entry<P>(tab, e, cur);
  }
}

// r = (x + y) mod p across the team, for x, y < p (this lane's K words of
// each).  r may alias x or y.
template <class P>
__device__ __forceinline__ void team_add(uint32_t r[P::K], const uint32_t x[P::K],
                                         const uint32_t y[P::K], const Lane<P>& L) {
  uint32_t t[P::K];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < P::K; ++j) {
    c += (uint64_t)x[j] + y[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  team_settle<P>(r, t, (uint32_t)c, L);
}

}  // namespace
