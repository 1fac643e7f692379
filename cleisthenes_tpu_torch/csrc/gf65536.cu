// GF(2^16) matrix application for the wide Reed-Solomon codec, on Hopper
// (sm_90a): a GF(2) product on the binary tensor cores.
//
// Replaces the TPU kernels of cleisthenes_tpu/ops/rs16_xla_kernels.py (K11):
//   _encode_kernel / encode_kernel_batch (:47, :57)   systematic encode
//   _decode_kernel / decode_kernel_shared (:53, :58)  decode by a host-inverted matrix
// Each is out[b, r, s] = XOR_j gf_mul(M_b[r, j], x[b, j, s]) over GF(2^16)
// (polynomial 0x1100B) on uint16 symbols, with M shared by every instance or
// one per instance.  As the reference does, encode multiplies only the n - k
// parity rows and copies the data rows into rows [0, k) of its output.
//
// The design is the reference's: multiplication by a constant c is GF(2)-
// linear on the 16 bits of a symbol, so M lifts to a (16m, 16k) 0/1 matrix
// whose row 16r+e', column 16j+e holds bit e' of c * x^e for c = M[r, j], and
// the product becomes bits(out) = lift(M) . bits(x) mod 2.  The reference runs
// it on the MXU in bf16; here it is
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc,
// whose popcount of (row AND column) has the XOR of the bit products as its
// bit 0.  Three facts make the fit:
// - The symbols are the B operand already: a column (b, s) of k little-endian
//   symbols is its 16k bits in the order 16j+e.  A block reads a tile of x
//   coalesced along s and only packs it into 32-bit words, each word holding
//   symbols j and j+1 of one column (no bit-planes).
// - One m16 accumulator tile is one output symbol row: its 16 lifted rows are
//   the symbol's 16 bits.  Bit 0 of each count, packed by warp shuffles,
//   gives 8 columns' symbols.
// - A block lifts its 16 output rows' coefficients itself, in shared memory:
//   16 packed xtime steps and a 16x16 bit transpose per pair of coefficients.
//   A shared matrix is lifted once per block and serves every column tile the
//   block walks; a per-instance matrix is lifted again for each instance.
//   k is padded to a multiple of 16 symbols (one k256 step) with zeros.
//
// Bound on the H100 at the N=512/f=170 epoch (B=512, k=172, n=512, S=64):
// encode is 16(n-k) x 16k x B*S = 4.9e11 bit products (the kernel issues
// 1.5e7 instructions, k padded to 176), 0.062 ms at the b1 yardstick of
// chip_smoke.py: csrc/mma_probe.py measures 5.2e15 bit products/s for this
// instruction (NVIDIA publishes no b1 rate), and the same probe reads s8 at
// 65% of NVIDIA's published dense s8 peak, so the yardstick scales the b1
// reading by that gap (mma.sync does not reach the peak that wgmma does) to
// 7.9e15; against 45 MB of HBM traffic (0.013 ms): bound by the tensor
// cores.  The design avoids the two limits of the log/exp kernel it
// replaces: no table lookups (that kernel's random exp reads conflicted
// about 3.5 ways in shared-memory banks; here every fragment and staging
// access is conflict-free by the pitches below), and 94 KB of shared memory
// a block (that kernel's 128 KiB exp table allowed one block of 8 warps per
// SM; this one fits two).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;                    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;                  // output rows (m16 tiles) a warp
constexpr int kRows = kWarps * kRowsPerWarp;     // 16 output rows a block
constexpr int kCols = 64;                        // symbol columns a tile
constexpr int kNTiles = kCols / 8;               // n8 tiles a tile
constexpr int kStepSyms = 16;                    // symbols a k256 step
constexpr int kSteps = 11;                       // k256 steps lifted at once
constexpr int kSpanSyms = kSteps * kStepSyms;    // 176 symbols: k=172 in one span
constexpr int kAPitch = kSteps * 8;              // words a lifted row: 88
constexpr int kBPitch = kCols + 4;               // words a staged word row: 68
constexpr size_t kSmemBytes =
    ((size_t)kRows * 16 * kAPitch + 2 * 8 * kBPitch) * sizeof(uint32_t);
// A fragment loads (8 bytes a lane, half a warp a phase) touch rows g = 0..3
// at bank offsets 24g mod 32: four distinct groups of 8 banks.
static_assert(kAPitch % 32 == 8 || kAPitch % 32 == 24, "A pitch");
// B fragment loads (4 bytes a lane): banks 8 tig + g (+4), all 32 distinct.
static_assert(kBPitch % 32 == 4, "B pitch");

// v * x mod 0x1100B in each 16-bit half of v.
__device__ __forceinline__ uint32_t xtime2(uint32_t v) {
  return ((v << 1) & 0xFFFEFFFEu) ^ (((v >> 15) & 0x00010001u) * 0x100Bu);
}

// In each 16-bit half, bit c of p[i] and bit i of p[c] trade places.
__device__ __forceinline__ void transpose16x2(uint32_t p[16]) {
#define CLE_STAGE(S, MASK)                                         \
  _Pragma("unroll") for (int i = 0; i < 16; ++i) {                 \
    if ((i & S) == 0) {                                            \
      const uint32_t t = ((p[i] >> S) ^ p[i + S]) & (MASK);        \
      p[i + S] ^= t;                                               \
      p[i] ^= t << S;                                              \
    }                                                              \
  }
  CLE_STAGE(8, 0x00FF00FFu)
  CLE_STAGE(4, 0x0F0F0F0Fu)
  CLE_STAGE(2, 0x33333333u)
  CLE_STAGE(1, 0x55555555u)
#undef CLE_STAGE
}

__device__ __forceinline__ void mma_b1(int acc[4], const uint2 lo, const uint2 hi,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(lo.x), "r"(hi.x), "r"(lo.y), "r"(hi.y), "r"(b0), "r"(b1));
}

// Grid (row tiles of kRows output rows, column groups); a block walks the
// column tiles (instance b, kCols symbols from s0) of its group.  Output row
// r of instance b goes to out row row0 + r; with row0 = k (systematic encode)
// the blocks of row tile 0 also copy x into rows [0, k).  `pairs`: S is even
// and x 4-byte aligned, so two symbols of a row load as one word.
__global__ void __launch_bounds__(kThreads, 2)
gf65536_gf2_kernel(const uint16_t* __restrict__ mat, long long mat_bstride,
                   const uint16_t* __restrict__ x, uint16_t* __restrict__ out,
                   int B, int m, int k, int S, int row0, int pairs) {
  extern __shared__ uint4 smem[];
  uint32_t* sA = reinterpret_cast<uint32_t*>(smem);  // [kRows * 16][kAPitch]
  uint32_t* sB = sA + kRows * 16 * kAPitch;          // [2][8][kBPitch]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int r_first = blockIdx.x * kRows;
  const int s_tiles = (S + kCols - 1) / kCols;
  const long long col_tiles = (long long)B * s_tiles;
  const int kpad = (k + kStepSyms - 1) / kStepSyms * kStepSyms;
  const int spans = (kpad + kSpanSyms - 1) / kSpanSyms;
  const int out_rows = row0 + m;
  const bool copy_rows = row0 > 0 && blockIdx.x == 0;
  long long lifted = -1;  // matrix instance whose rows sit in sA

  for (long long ct = blockIdx.y; ct < col_tiles; ct += gridDim.y) {
    const long long b = ct / s_tiles;
    const int s0 = (int)(ct - b * s_tiles) * kCols;
    const uint16_t* xb = x + b * (long long)k * S;
    const long long mi = mat_bstride ? b : 0;
    int acc[kRowsPerWarp][kNTiles][4];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int t = 0; t < kNTiles; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][t][q] = 0;

    for (int sp = 0; sp < spans; ++sp) {
      const int j_span = sp * kSpanSyms;
      const int steps = min(kSpanSyms, kpad - j_span) / kStepSyms;
      if (spans > 1 || lifted != mi) {
        // Lift rows r_first.. of M_mi over this span: thread work unit =
        // (row rr, word w), the coefficient pair j, j+1 = j_span + 2w, +1,
        // packed low/high; its 16 multiples by x^e, transposed per half,
        // are the words of lifted rows 16 rr + e', e' = 0..15.
        __syncthreads();  // the last tile's readers of sA are done
        const uint16_t* mb = mat + mi * mat_bstride;
        const int nw = steps * 8;
        for (int u = tid; u < kRows * nw; u += kThreads) {
          const int rr = u / nw, w = u - rr * nw;
          const int r = r_first + rr, j = j_span + 2 * w;
          uint32_t v = 0;
          if (r < m) {
            const uint16_t* row = mb + (long long)r * k;
            if (j < k) v = row[j];
            if (j + 1 < k) v |= (uint32_t)row[j + 1] << 16;
          }
          uint32_t p[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            p[e] = v;
            v = xtime2(v);
          }
          transpose16x2(p);
          uint32_t* dst = sA + rr * 16 * kAPitch + w;
#pragma unroll
          for (int e = 0; e < 16; ++e) dst[e * kAPitch] = p[e];
        }
        lifted = spans > 1 ? -1 : mi;
      }
      // Stage a step's 16 symbols x 64 columns as 8 word rows: thread
      // (w = warp, column pair lane) reads symbols s, s+1 of rows j (lo) and
      // j+1 (hi), one 32-bit load each when `pairs`, and packs words
      // x[j][s] | x[j+1][s] << 16 and x[j][s+1] | x[j+1][s+1] << 16, into
      // one of two buffers: the next step's symbols load while this step
      // multiplies, and one barrier a step separates them.
      const int s = s0 + 2 * lane;
      uint32_t lo = 0, hi = 0;
      auto load_step = [&](int st) {
        const int j = j_span + st * kStepSyms + 2 * warp;
        const uint16_t* r = xb + (long long)j * S + s;
        if (pairs) {
          lo = j < k && s < S ? *reinterpret_cast<const uint32_t*>(r) : 0u;
          hi = j + 1 < k && s < S ? *reinterpret_cast<const uint32_t*>(r + S) : 0u;
        } else {
          lo = hi = 0;
          if (s < S) {
            if (j < k) lo = r[0];
            if (j + 1 < k) hi = r[S];
          }
          if (s + 1 < S) {
            if (j < k) lo |= (uint32_t)r[1] << 16;
            if (j + 1 < k) hi |= (uint32_t)r[S + 1] << 16;
          }
        }
      };
      auto stage = [&](int st) {
        if (copy_rows) {
          const int j = j_span + st * kStepSyms + 2 * warp;
          uint16_t* o = out + (b * out_rows + j) * (long long)S + s;
          if (s < S) {
            if (j < k) o[0] = (uint16_t)lo;
            if (j + 1 < k) o[S] = (uint16_t)hi;
          }
          if (s + 1 < S) {
            if (j < k) o[1] = (uint16_t)(lo >> 16);
            if (j + 1 < k) o[S + 1] = (uint16_t)(hi >> 16);
          }
        }
        *reinterpret_cast<uint2*>(sB + (st & 1) * 8 * kBPitch + warp * kBPitch + 2 * lane) =
            make_uint2(__byte_perm(lo, hi, 0x5410), __byte_perm(lo, hi, 0x7632));
      };
      load_step(0);
      __syncthreads();  // sA is lifted; the last tile's readers of sB are done
      stage(0);
      __syncthreads();
      for (int st = 0; st < steps; ++st) {
        if (st + 1 < steps) load_step(st + 1);
        const uint32_t* sb = sB + (st & 1) * 8 * kBPitch;
        // Fragments: the hardware pairs A register a0 (a2) with B register
        // b0 (b1) over one 32-bit k slice; both take word 2 tig (2 tig + 1)
        // of the step, so A and B pack the k index the same way.
        uint32_t bf[kNTiles][2];
#pragma unroll
        for (int t = 0; t < kNTiles; ++t) {
          bf[t][0] = sb[(2 * tig) * kBPitch + t * 8 + g];
          bf[t][1] = sb[(2 * tig + 1) * kBPitch + t * 8 + g];
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int rr = warp * kRowsPerWarp + i;
          if (r_first + rr >= m) continue;  // warp-uniform
          const uint32_t* a = sA + (rr * 16 + g) * kAPitch + st * 8 + 2 * tig;
          const uint2 alo = *reinterpret_cast<const uint2*>(a);
          const uint2 ahi = *reinterpret_cast<const uint2*>(a + 8 * kAPitch);
#pragma unroll
          for (int t = 0; t < kNTiles; ++t) mma_b1(acc[i][t], alo, ahi, bf[t][0], bf[t][1]);
        }
        if (st + 1 < steps) stage(st + 1);  // the other buffer: read a step ago
        __syncthreads();
      }
    }

    // Epilogue: lane (g, tig) holds bits g, g + 8 of columns 2 tig, 2 tig + 1
    // of each n8 tile; OR across the 8 lanes of a tig gives the symbols, and
    // lane (g, tig) keeps tile g's, so a warp stores one row's 64 columns.
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = r_first + warp * kRowsPerWarp + i;
      if (r >= m) continue;  // warp-uniform
      uint32_t mine = 0;
#pragma unroll
      for (int t = 0; t < kNTiles; ++t) {
        uint32_t v = ((acc[i][t][0] & 1u) << g) | ((acc[i][t][2] & 1u) << (g + 8)) |
                     ((acc[i][t][1] & 1u) << (g + 16)) | ((acc[i][t][3] & 1u) << (g + 24));
        v |= __shfl_xor_sync(0xFFFFFFFFu, v, 4);
        v |= __shfl_xor_sync(0xFFFFFFFFu, v, 8);
        v |= __shfl_xor_sync(0xFFFFFFFFu, v, 16);
        if (g == t) mine = v;
      }
      const int s = s0 + 8 * g + 2 * tig;
      uint16_t* orow = out + (b * out_rows + row0 + r) * (long long)S;
      if ((S & 1) == 0) {
        if (s < S) *reinterpret_cast<uint32_t*>(orow + s) = mine;
      } else {
        if (s < S) orow[s] = (uint16_t)mine;
        if (s + 1 < S) orow[s + 1] = (uint16_t)(mine >> 16);
      }
    }
  }
}

// What a launch needs to know of the current device, set up once a device under
// a lock, since a process may drive several cards: its SM count and the
// kernel's shared-memory opt-in.
constexpr int kMaxDevices = 64;
struct DeviceState {
  bool ready = false;
  int sms = 0;
};
std::mutex g_device_mu;
DeviceState g_device[kMaxDevices];

}  // namespace

// out = M (*) x over GF(2^16) for x (B, k, S) uint16 symbols and M (m, k)
// uint16 at mat + b * mat_bstride (mat_bstride 0: one matrix shared by every
// instance).  out is (B, row0 + m, S): row row0 + r holds output row r, and
// with row0 = k (systematic encode, M = the parity rows) rows [0, k) get a
// copy of x; row0 must be 0 or k.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int gf65536_apply(const void* mat, long long mat_bstride,
                             const void* x, void* out, int B, int m, int k,
                             int S, int row0, void* stream) {
  if (B < 1 || m < 0 || k < 1 || S < 1 || (row0 != 0 && row0 != k) ||
      (m == 0 && row0 == 0))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(g_device_mu);
    DeviceState& d = g_device[dev];
    if (!d.ready) {
      err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(gf65536_gf2_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmemBytes);
      if (err != cudaSuccess) return (int)err;
      d.ready = true;
    }
    sms = d.sms;
  }
  const long long row_tiles = m > 0 ? (m + kRows - 1) / kRows : 1;
  const long long col_tiles = (long long)B * ((S + kCols - 1) / kCols);
  // two blocks an SM; a group's blocks share their lifted rows across tiles
  long long groups = (2ll * sms + row_tiles - 1) / row_tiles;
  if (groups > col_tiles) groups = col_tiles;
  if (groups > 65535) groups = 65535;
  if (row_tiles > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  gf65536_gf2_kernel<<<dim3((unsigned)row_tiles, (unsigned)groups), kThreads,
                       kSmemBytes, (cudaStream_t)stream>>>(
      (const uint16_t*)mat, mat_bstride, (const uint16_t*)x, (uint16_t*)out,
      B, m, k, S, row0, S % 2 == 0 && ((uintptr_t)x & 3) == 0);
  return (int)cudaGetLastError();
}
