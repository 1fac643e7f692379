// GF(2^8) matrix application for the Reed-Solomon codec, on Hopper (sm_90a):
// a GF(2) product on the binary tensor cores.
//
// Replaces the TPU kernels of cleisthenes_tpu/ops/rs_xla.py:
//   K1 _encode_kernel / _encode_kernel_batch (:59, :71)   systematic encode
//   K2 _decode_kernel / _decode_kernel_batch /
//      _decode_kernel_shared (:65, :72, :76)              decode by a host-inverted matrix
//   K3 _decode_recheck_kernel (:80), its two codec steps  (the forest half is sha256.cu)
// Each is out[b, r, l] = XOR_j gf_mul(M_b[r, j], x[b, j, l]) over GF(2^8)
// (polynomial 0x11D), with M shared by every instance or one per instance.
// As the reference does, encode multiplies only the n - k parity rows and
// copies the data rows into rows [0, k) of its output.
//
// The design is the reference's (rs_xla.py:50 _gf_apply_bits): multiplying
// by a constant c is GF(2)-linear on the 8 bits of a byte, so M lifts to an
// (8m, 8k) 0/1 matrix whose row 8r+e', column 8j+e holds bit e' of c * x^e
// for c = M[r, j] (gf256.py lift_to_bits), and bits(out) = lift(M) . bits(x)
// mod 2.  The reference runs the product on the MXU in bf16; here it is
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc,
// whose popcount of (row AND column) has the XOR of the bit products as its
// bit 0, as in csrc/gf65536.cu (K11) with 16 replaced by 8:
// - The bytes are the B operand already: a column (b, l) of k bytes is its
//   8k bits in the order 8j+e.  A block reads a tile of x coalesced along l,
//   4 bytes of one row a thread, and a 4x4 byte transpose gives each 32-bit
//   word four consecutive rows' bytes of one column.  k is padded with zeros
//   to a multiple of 32 bytes, one k256 step.
// - One m16 accumulator tile is two output rows: lifted rows 0-7 are row r's
//   8 bits, 8-15 row r+1's.  Bit 0 of each count, packed by warp shuffles,
//   gives 8 columns' bytes of both rows.
// - A block lifts its rows' coefficients itself, in shared memory: 8 packed
//   xtime steps and an 8x8 bit transpose per byte lane, four coefficients a
//   word.  A shared matrix is lifted once per block and serves every column
//   tile the block walks; a per-instance matrix is lifted for each instance.
//
// Bound on the H100 at the N=128/f=42 epoch (B=128 instances, k=44, n=128,
// L=128): the encode's 8(n-k) x 8k x B*L = 3.9e9 bit products take 0.49 us
// at chip_smoke.py's b1 yardstick (~7.9e15 a second), its 2.8 MB of HBM
// traffic 0.84 us at 3.35 TB/s: bound by bytes, and at that size by the
// launch and the block's serial phases.  The log/exp kernel this replaces
// did the same product as 60.6 M table lookups at data-dependent
// shared-memory addresses (bank conflicts), applied the k identity rows
// too and read x again for every 16 output rows.  Here a block of 16 warps
// (one an SM: registers) takes up to 128 output rows, as many as fit the
// shared memory, so the N=128 encode is one block an instance: x is read
// once into shared memory, the fragment and staging accesses are
// conflict-free by the pitches below, and the block issues 42 x 2 x 8 x 2
// = 1,344 tensor-core instructions.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 512;                 // 16 warps: one block an SM (registers)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 256;                    // GF(2^8) codes have at most 256 shards
constexpr int kStepSyms = 32;                 // bytes of a column a k256 step
constexpr int kCols = 128;                    // byte columns a tile
constexpr int kGroupCols = 64;                // columns of a warp's unit: 8 n8 tiles
constexpr int kNTiles = kGroupCols / 8;
constexpr int kGroups = kCols / kGroupCols;
constexpr int kBPitch = kCols + 4;            // words a staged word row
constexpr int kMaxRows = 128;                 // output rows a block (a row tile), at most
constexpr int kSmemLimit = 232448;            // a block's shared memory on sm_90
// B fragment loads (4 bytes a lane): banks 8 tig + g (+ 8 t), all 32 distinct.
static_assert(kBPitch % 32 == 4, "B pitch");
// units unit and unit + kWarps share their column group
static_assert(kWarps % kGroups == 0, "unit pairs");
// A row of the lifted matrix is kw = 8 * steps words at a pitch of kw, or kw + 8
// when steps is even, so that the pitch is 8 or 24 mod 32: the fragment loads
// (8 bytes a lane, half a warp a phase) of rows g = 0..3 hit four distinct
// groups of 8 banks.
__host__ __device__ constexpr int a_pitch(int steps) { return 8 * steps + (steps % 2 ? 0 : 8); }
constexpr size_t smem_bytes(int rows, int steps) {
  return ((size_t)rows * 8 * a_pitch(steps) + (size_t)8 * steps * kBPitch) * sizeof(uint32_t);
}
// The output rows of a row tile at `steps` k256 steps: kMaxRows, or the even
// count whose lifted rows fit the shared memory (86 at k = 256).
constexpr int fit_rows(int steps) {
  return (int)((kSmemLimit / 4 - 8 * steps * kBPitch) / (8 * a_pitch(steps))) / 2 * 2 < kMaxRows
             ? (int)((kSmemLimit / 4 - 8 * steps * kBPitch) / (8 * a_pitch(steps))) / 2 * 2
             : kMaxRows;
}
static_assert(smem_bytes(fit_rows(kMaxK / kStepSyms), kMaxK / kStepSyms) <= kSmemLimit &&
              fit_rows(kMaxK / kStepSyms) >= 2, "a block's shared memory");

// v * x mod 0x11D in each byte of v.
__device__ __forceinline__ uint32_t xtime4(uint32_t v) {
  return ((v << 1) & 0xFEFEFEFEu) ^ (((v >> 7) & 0x01010101u) * 0x1Du);
}

// In each byte, bit c of p[i] and bit i of p[c] trade places.
__device__ __forceinline__ void transpose8x4(uint32_t p[8]) {
#define CLE_STAGE(S, MASK)                                         \
  _Pragma("unroll") for (int i = 0; i < 8; ++i) {                  \
    if ((i & S) == 0) {                                            \
      const uint32_t t = ((p[i] >> S) ^ p[i + S]) & (MASK);        \
      p[i + S] ^= t;                                               \
      p[i] ^= t << S;                                              \
    }                                                              \
  }
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

// Grid (row tiles of tile_rows output rows, column groups); a block walks the
// column tiles (instance b, kCols bytes from l0) of its group.  Output row r
// of instance b goes to out row row0 + r; with row0 = k (systematic encode)
// the blocks of row tile 0 also copy x into rows [0, k).  `words`: L is a
// multiple of 4 and x 4-byte aligned, so 4 bytes of a row load as one word
// and the copy stores words; `mat_words`: the same for M's rows (k a
// multiple of 4, M and its stride 4-byte aligned).
__global__ void __launch_bounds__(kThreads, 1)
gf256_gf2_kernel(const uint8_t* __restrict__ mat, long long mat_bstride,
                 const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                 int B, int m, int k, int L, int row0, int tile_rows, int words,
                 int mat_words) {
  extern __shared__ uint4 smem[];
  const int steps = (k + kStepSyms - 1) / kStepSyms;
  const int kw = 8 * steps;  // words a lifted row; word rows of a staged tile
  const int ap = a_pitch(steps);
  uint32_t* sA = reinterpret_cast<uint32_t*>(smem);  // [tile_rows * 8][ap]
  uint32_t* sB = sA + tile_rows * 8 * ap;            // [kw][kBPitch]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int r_first = blockIdx.x * tile_rows;
  const int m_tiles = (max(0, min(tile_rows, m - r_first)) + 1) / 2;
  const int l_tiles = (L + kCols - 1) / kCols;
  const long long col_tiles = (long long)B * l_tiles;
  const int out_rows = row0 + m;
  const bool copy_rows = row0 > 0 && blockIdx.x == 0;
  long long lifted = -1;  // matrix instance whose rows sit in sA

  for (long long ct = blockIdx.y; ct < col_tiles; ct += gridDim.y) {
    const long long b = ct / l_tiles;
    const int l0 = (int)(ct - b * l_tiles) * kCols;
    const long long mi = mat_bstride ? b : 0;
    __syncthreads();  // the last tile's readers of sA and sB are done
    if (lifted != mi) {
      // Lift rows r_first.. of M_mi: thread work unit = (row rr, word w),
      // the coefficients j = 4w .. 4w+3 packed a byte each; their 8
      // multiples by x^e, transposed per byte, are the words of lifted rows
      // 8 rr + e', e' = 0..7.
      const uint8_t* mb = mat + mi * mat_bstride;
#pragma unroll 2
      for (int u = tid; u < tile_rows * kw; u += kThreads) {
        const int rr = u / kw, w = u - rr * kw;
        const int r = r_first + rr, j = 4 * w;
        uint32_t v = 0;
        if (r < m && j < k) {
          const uint8_t* row = mb + (long long)r * k + j;
          if (mat_words) {
            v = *reinterpret_cast<const uint32_t*>(row);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (j + q < k) v |= (uint32_t)row[q] << (8 * q);
          }
        }
        uint32_t p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          p[e] = v;
          v = xtime4(v);
        }
        transpose8x4(p);
        uint32_t* dst = sA + rr * 8 * ap + w;
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e * ap] = p[e];
      }
      lifted = mi;
    }
    // Stage the tile as kw word rows: thread unit (word row wr, 4 columns
    // from c) reads 4 bytes of rows 4 wr .. 4 wr + 3 (a warp: 128 bytes of
    // one row), transposes the 4x4 bytes and stores the 4 columns' words;
    // rows past k and columns past L are zero.
    const uint8_t* xb = x + b * (long long)k * L;
#pragma unroll 2
    for (int u = tid; u < kw * (kCols / 4); u += kThreads) {
      const int wr = u / (kCols / 4), c = (u - wr * (kCols / 4)) * 4;
      const int j = 4 * wr, l = l0 + c;
      uint32_t rw[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        rw[h] = 0;
        if (j + h < k && l < L) {
          const uint8_t* src = xb + (long long)(j + h) * L + l;
          if (words) {
            rw[h] = *reinterpret_cast<const uint32_t*>(src);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (l + q < L) rw[h] |= (uint32_t)src[q] << (8 * q);
          }
          if (copy_rows) {
            uint8_t* o = out + (b * out_rows + j + h) * (long long)L + l;
            if (words) {
              *reinterpret_cast<uint32_t*>(o) = rw[h];
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (l + q < L) o[q] = (uint8_t)(rw[h] >> (8 * q));
            }
          }
        }
      }
      const uint32_t t0 = __byte_perm(rw[0], rw[1], 0x5140), t1 = __byte_perm(rw[0], rw[1], 0x7362);
      const uint32_t u0 = __byte_perm(rw[2], rw[3], 0x5140), u1 = __byte_perm(rw[2], rw[3], 0x7362);
      *reinterpret_cast<uint4*>(sB + wr * kBPitch + c) =
          make_uint4(__byte_perm(t0, u0, 0x5410), __byte_perm(t0, u0, 0x7632),
                     __byte_perm(t1, u1, 0x5410), __byte_perm(t1, u1, 0x7632));
    }
    __syncthreads();

    // Warp unit = (m16 tile mt: output rows r, r + 1; column group cg of
    // 8 n8 tiles); a warp takes units unit and unit + kWarps together (the
    // same column group, so one load of the B fragments serves both, and
    // two units' products and shuffles are in flight at once).  Fragments:
    // the hardware pairs A register a0 (a2) with B register b0 (b1) over
    // one 32-bit k slice; both take word 2 tig (2 tig + 1) of the step, so
    // A and B pack the k index the same way.
    const int units = m_tiles * kGroups;
    for (int unit = warp; unit < units; unit += 2 * kWarps) {
      const int mt = unit / kGroups, cg = unit - mt * kGroups;
      const int lg = l0 + cg * kGroupCols;
      if (lg >= L) continue;  // warp-uniform
      const int nu = unit + kWarps < units ? 2 : 1;  // warp-uniform
      int acc[2][kNTiles][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int t = 0; t < kNTiles; ++t)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][t][q] = 0;
      for (int st = 0; st < steps; ++st) {
        const uint32_t* sb = sB + (st * 8 + 2 * tig) * kBPitch + cg * kGroupCols + g;
        uint32_t bf[kNTiles][2];
#pragma unroll
        for (int t = 0; t < kNTiles; ++t) {
          bf[t][0] = sb[t * 8];
          bf[t][1] = sb[kBPitch + t * 8];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i == nu) break;
          const uint32_t* a = sA + ((mt + i * kWarps / kGroups) * 16 + g) * ap + st * 8 + 2 * tig;
          const uint2 alo = *reinterpret_cast<const uint2*>(a);
          const uint2 ahi = *reinterpret_cast<const uint2*>(a + 8 * ap);
#pragma unroll
          for (int t = 0; t < kNTiles; ++t) mma_b1(acc[i][t], alo, ahi, bf[t][0], bf[t][1]);
        }
      }
      // Epilogue: lane (g, tig) holds bit g of rows r, r + 1 at columns
      // 2 tig, 2 tig + 1 of each n8 tile; OR across the 8 lanes of a tig
      // gives the bytes, and lane (g, tig) keeps tile g's, so a warp stores
      // 64 columns of both rows.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == nu) break;
        const int r = r_first + 2 * (mt + i * kWarps / kGroups);
        uint32_t mine = 0;
#pragma unroll
        for (int t = 0; t < kNTiles; ++t) {
          uint32_t v = ((acc[i][t][0] & 1u) << g) | ((acc[i][t][1] & 1u) << (g + 8)) |
                       ((acc[i][t][2] & 1u) << (g + 16)) | ((acc[i][t][3] & 1u) << (g + 24));
          v |= __shfl_xor_sync(0xFFFFFFFFu, v, 4);
          v |= __shfl_xor_sync(0xFFFFFFFFu, v, 8);
          v |= __shfl_xor_sync(0xFFFFFFFFu, v, 16);
          if (g == t) mine = v;
        }
        const int l = lg + 8 * g + 2 * tig;
        uint8_t* o = out + (b * out_rows + row0 + r) * (long long)L + l;
        const bool second = r + 1 < m;
        if ((L & 1) == 0) {
          if (l < L) {
            *reinterpret_cast<uint16_t*>(o) = (uint16_t)mine;
            if (second) *reinterpret_cast<uint16_t*>(o + L) = (uint16_t)(mine >> 16);
          }
        } else {
          if (l < L) o[0] = (uint8_t)mine;
          if (l + 1 < L) o[1] = (uint8_t)(mine >> 8);
          if (second) {
            if (l < L) o[L] = (uint8_t)(mine >> 16);
            if (l + 1 < L) o[L + 1] = (uint8_t)(mine >> 24);
          }
        }
      }
    }
  }
}

// What a launch needs to know of the current device, set up once a device under
// a lock, since a process may drive several cards: its SM count, the kernel's
// shared-memory opt-in and the last occupancy query.
constexpr int kMaxDevices = 64;
struct DeviceState {
  bool ready = false;
  int sms = 0;
  size_t occ_smem = 0;  // the shared memory occ was queried at
  int occ = 0;
};
std::mutex g_device_mu;
DeviceState g_device[kMaxDevices];

}  // namespace

// out = M (*) x over GF(2^8) for x (B, k, L) bytes and M (m, k) uint8 at
// mat + b * mat_bstride (mat_bstride 0: one matrix shared by every
// instance), 1 <= k <= 256.  out is (B, row0 + m, L): row row0 + r holds
// output row r, and with row0 = k (systematic encode, M = the parity rows)
// rows [0, k) get a copy of x; row0 must be 0 or k.  x may start at any
// byte; out must be 4-byte aligned.  One launch on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int gf256_apply(const void* mat, long long mat_bstride, const void* x,
                           void* out, int B, int m, int k, int L, int row0,
                           void* stream) {
  if (B < 1 || m < 0 || k < 1 || k > kMaxK || L < 1 || (row0 != 0 && row0 != k) ||
      (m == 0 && row0 == 0) || ((uintptr_t)out & 3))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int steps = (k + kStepSyms - 1) / kStepSyms;
  // row tiles of at most fit_rows rows, balanced, an even count each
  const int max_rows = fit_rows(steps);
  const int row_tiles = m > 0 ? (m + max_rows - 1) / max_rows : 1;
  const int tile_rows = m > 0 ? ((m + row_tiles - 1) / row_tiles + 1) / 2 * 2 : 2;
  const size_t smem = smem_bytes(tile_rows, steps);
  int sms = 0, occ = 0;
  {
    std::lock_guard<std::mutex> lock(g_device_mu);
    DeviceState& d = g_device[dev];
    if (!d.ready) {
      err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(gf256_gf2_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return (int)err;
      d.ready = true;
    }
    if (d.occ_smem != smem) {
      d.occ_smem = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.occ, gf256_gf2_kernel,
                                                          kThreads, smem);
      if (err != cudaSuccess) return (int)err;
      d.occ_smem = smem;
    }
    sms = d.sms;
    occ = d.occ;
  }
  const long long col_tiles = (long long)B * ((L + kCols - 1) / kCols);
  // every resident block busy; a group's blocks share their lifted rows
  long long groups = ((long long)occ * sms + row_tiles - 1) / row_tiles;
  if (groups > col_tiles) groups = col_tiles;
  if (groups > 65535) groups = 65535;
  if (groups < 1) groups = 1;
  gf256_gf2_kernel<<<dim3((unsigned)row_tiles, (unsigned)groups), kThreads, smem,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)mat, mat_bstride, (const uint8_t*)x, (uint8_t*)out, B, m, k,
      L, row0, tile_rows, L % 4 == 0 && ((uintptr_t)x & 3) == 0,
      k % 4 == 0 && mat_bstride % 4 == 0 && ((uintptr_t)mat & 3) == 0);
  return (int)cudaGetLastError();
}
