// Batched SHA-256, Merkle forests and branch verification on Hopper (sm_90a).
//
// Replaces the TPU kernels of cleisthenes_tpu/ops/sha256_xla.py:
//   K4 sha256_batch (:127)     sha256_rows: one digest per fixed-length row
//   K5 build_forest (:157)     merkle_forest: one launch a forest, one block
//                              a tree
//   K6 verify_branches (:206)  merkle_verify: one thread per branch proof
// and the forest half of K3 _decode_recheck_kernel (rs_xla.py:80).
//
// Merkle convention (ops/merkle.py): leaf = SHA256(0x00 || shard), node =
// SHA256(0x01 || left || right); leaf rows pad to a power of two with the
// digest sha256("cleisthenes-tpu:empty-leaf"), which the caller passes in.
//
// Bound on the H100: SHA-256 is integer work, 1,383 32-bit instructions per
// 64-byte compression as sm_90a issues them (14 per round: 6 SHF for the
// rotations, one LOP3 each for the two Sigmas' 3-way XORs, Ch and Maj, and
// 4 adds as IADD3; 10 per schedule word; counted in the SASS by
// csrc/sass_ops.py) and 2,675 for a 65-byte Merkle node, against a few
// bytes of input per compression; so every kernel here is bound by
// operations at the 16.7 T int32 ops/s of the SM's INT32 lanes.  At the
// N=128 epoch the forest is 16,384 leaves of 129 bytes (3 compressions)
// plus 16,256 nodes, the verify 16,384 branches of 3 compressions and 7
// nodes: 0.49 G instructions, ~29 us of int work at peak, tiny next to
// launch costs; at N=512 the forest is 262,144 leaves and 261,632 nodes,
// 1.8 G instructions, 0.107 ms.  The design gives each message its own thread
// so the 64 rounds run in registers with no cross-thread traffic: the
// 16-word schedule is a rolling window whose indices unroll to registers,
// the padded block is assembled from the row bytes on the fly (no host
// concatenation of the domain byte, no padded copy), and a verify thread
// keeps its running digest in registers through all D levels, building each
// 65-byte node message from the two digests with word shifts.
//
// The forest (merkle_forest_kernel) is one launch with one block per tree,
// where the reference's and this port's first design ran a launch per level,
// each with a dependent compression chain and, near the root, one or two
// threads a tree.  The block stages its leaf rows in shared memory with
// coalesced 16-byte loads (byte loads when a row is not 16-byte aligned),
// builds each leaf's message words from them with byte permutes (the 0x00
// prefix shifts the row by one byte), stores every digest as two 16-byte
// words, and hashes the tree level by level with a barrier between levels;
// a level reads its children from the forest in global memory, which a
// barrier makes visible within the block, so any p up to the 65,536 leaves
// of the GF(2^16) codec works.  sha256_rows keeps the one-thread-a-row form
// for K4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu,
    0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u,
    0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u,
    0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
    0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u,
    0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
    0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
    0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u,
    0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u, 0x1E376C08u,
    0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu,
    0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void sha256_init(uint32_t st[8]) {
  st[0] = 0x6A09E667u; st[1] = 0xBB67AE85u; st[2] = 0x3C6EF372u;
  st[3] = 0xA54FF53Au; st[4] = 0x510E527Fu; st[5] = 0x9B05688Cu;
  st[6] = 0x1F83D9ABu; st[7] = 0x5BE0CD19u;
}

// One compression of the 16 big-endian words w (overwritten) into st.
__device__ __forceinline__ void sha256_compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + kK[t] + w[t & 15];
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + S0 + mj;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// SHA-256 of [prefix byte if prefix >= 0] || p[0:len], padded on the fly.
__device__ void sha256_msg(const uint8_t* __restrict__ p, long long len,
                           int prefix, uint32_t st[8]) {
  const int pre = prefix >= 0 ? 1 : 0;
  const long long total = len + pre;
  const long long nblocks = (total + 9 + 63) / 64;
  const long long lenpos = nblocks * 64 - 8;
  const unsigned long long bitlen = (unsigned long long)total * 8ull;
  sha256_init(st);
  for (long long blk = 0; blk < nblocks; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long pos = blk * 64 + i * 4 + c;
        uint32_t byte;
        if (pos < total)
          byte = (pre && pos == 0) ? (uint32_t)prefix : p[pos - pre];
        else if (pos == total)
          byte = 0x80u;
        else if (pos >= lenpos)
          byte = (uint32_t)(bitlen >> (8 * (7 - (pos - lenpos)))) & 0xFFu;
        else
          byte = 0;
        word = (word << 8) | byte;
      }
      w[i] = word;
    }
    sha256_compress(st, w);
  }
}

// SHA-256(0x01 || left || right) of two digests held as big-endian words.
__device__ __forceinline__ void sha256_node(const uint32_t l[8],
                                            const uint32_t r[8],
                                            uint32_t st[8]) {
  uint32_t d[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) { d[i] = l[i]; d[8 + i] = r[i]; }
  uint32_t w[16];
  w[0] = 0x01000000u | (d[0] >> 8);
#pragma unroll
  for (int i = 1; i < 16; ++i) w[i] = (d[i - 1] << 24) | (d[i] >> 8);
  sha256_init(st);
  sha256_compress(st, w);
  w[0] = (d[15] << 24) | 0x00800000u;
#pragma unroll
  for (int i = 1; i < 15; ++i) w[i] = 0;
  w[15] = 65u * 8u;
  sha256_compress(st, w);
}

// Byte-swapped word: a big-endian state word stored little-endian.
__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

__device__ __forceinline__ void store_digest16(const uint32_t st[8], uint8_t* out) {
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(bswap32(st[0]), bswap32(st[1]), bswap32(st[2]), bswap32(st[3]));
  o[1] = make_uint4(bswap32(st[4]), bswap32(st[5]), bswap32(st[6]), bswap32(st[7]));
}

__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t w[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
           ((uint32_t)p[4 * i + 2] << 8) | (uint32_t)p[4 * i + 3];
}

// Thread t digests the msg_len bytes of row t at in + t * msg_len.
__global__ void sha256_rows_kernel(const uint8_t* __restrict__ in, long long rows,
                                   long long msg_len, int prefix,
                                   uint8_t* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows) return;
  uint32_t st[8];
  sha256_msg(in + t * msg_len, msg_len, prefix, st);
  store_digest16(st, out + t * 32);
}

__global__ void merkle_verify_kernel(const uint8_t* __restrict__ roots,
                                     const uint8_t* __restrict__ leaves,
                                     long long leaf_len,
                                     const uint8_t* __restrict__ branches,
                                     int depth,
                                     const long long* __restrict__ indices,
                                     uint8_t* __restrict__ ok, long long B) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  uint32_t cur[8];
  sha256_msg(leaves + i * leaf_len, leaf_len, 0x00, cur);
  uint32_t idx = (uint32_t)indices[i];  // u32 as the reference's kernel
  const uint8_t* br = branches + i * depth * 32ll;
  for (int lvl = 0; lvl < depth; ++lvl) {
    uint32_t sib[8], nxt[8];
    load_words(br + lvl * 32, sib);
    if (idx & 1u)
      sha256_node(sib, cur, nxt);
    else
      sha256_node(cur, sib, nxt);
#pragma unroll
    for (int j = 0; j < 8; ++j) cur[j] = nxt[j];
    idx >>= 1;
  }
  uint32_t root[8];
  load_words(roots + i * 32, root);
  uint32_t diff = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) diff |= cur[j] ^ root[j];
  ok[i] = diff == 0 ? 1 : 0;
}

// SHA-256(0x00 || row) of a row staged in shared memory as little-endian
// words, zero from row word `lw` on, read 16 bytes at a time up to `lw4`
// (lw rounded up to 4).  Message word i of a block holds row bytes 4i-1 ..
// 4i+2 big-endian: __byte_perm of row words i-1 and i; row word -1 is 0, so
// its top byte is the prefix 0x00.
__device__ void sha256_leaf_staged(const uint32_t* row, int lw4, int len,
                                   uint32_t st[8]) {
  const int total = len + 1;
  const int nblocks = (total + 9 + 63) / 64;
  const int tw = total >> 2;  // message word of the 0x80 byte
  const uint32_t tbit = 0x80u << (24 - 8 * (total & 3));
  const uint32_t bitlen = (uint32_t)total * 8u;  // < 2^32: rows staged are < 64 KB
  sha256_init(st);
  uint32_t prev = 0;
  for (int q = 0; q < nblocks; ++q) {
    uint32_t w[16];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = 16 * q + 4 * c;
      const uint4 v = m < lw4 ? *reinterpret_cast<const uint4*>(row + m)
                              : make_uint4(0u, 0u, 0u, 0u);
      w[4 * c] = __byte_perm(prev, v.x, 0x3456);
      w[4 * c + 1] = __byte_perm(v.x, v.y, 0x3456);
      w[4 * c + 2] = __byte_perm(v.y, v.z, 0x3456);
      w[4 * c + 3] = __byte_perm(v.z, v.w, 0x3456);
      prev = v.w;
    }
    const int tq = tw - 16 * q;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i == tq) w[i] |= tbit;
    if (q == nblocks - 1) {
      w[14] = 0;
      w[15] = bitlen;
    }
    sha256_compress(st, w);
  }
}

// One block per tree: the leaf digests of rows [0, n) (in batches of
// `rows_per_batch` rows, staged in shared memory at `pitch_w` words a row
// when pitch_w > 0, else hashed straight from global memory), the empty-leaf
// digest in rows [n, p), then each level from the one below it, read back
// from the forest.  Tree t reads shards + t n L and writes
// forest + t (2p - 1) 32, leaf row first.
__global__ void merkle_forest_kernel(const uint8_t* __restrict__ shards,
                                     int n, long long L, uint8_t* forest,
                                     int p, const uint8_t* __restrict__ pad_digest,
                                     int rows_per_batch, int pitch_w,
                                     int aligned16) {
  extern __shared__ uint4 smem[];
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem);
  const int T = blockDim.x, tid = threadIdx.x;
  const uint8_t* src = shards + (long long)blockIdx.x * n * L;
  uint8_t* tree = forest + (long long)blockIdx.x * (2ll * p - 1) * 32;
  const long long lw4 = ((L + 3) / 4 + 3) / 4 * 4;

  for (int i0 = 0; i0 < n; i0 += rows_per_batch) {
    const int here = min(rows_per_batch, n - i0);
    if (pitch_w > 0) {
      __syncthreads();  // the last batch's readers are done
      if (aligned16) {
        const int chunks = (int)(L / 16);
        for (int u = tid; u < here * chunks; u += T) {
          const int rr = u / chunks, cc = u - rr * chunks;
          reinterpret_cast<uint4*>(rows + rr * pitch_w)[cc] =
              reinterpret_cast<const uint4*>(src + (i0 + rr) * L)[cc];
        }
      } else {
        const int words = (int)lw4;
        for (int u = tid; u < here * words; u += T) {
          const int rr = u / words, ww = u - rr * words;
          const uint8_t* r = src + (i0 + rr) * L;
          uint32_t v = 0;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (4ll * ww + c < L) v |= (uint32_t)r[4 * ww + c] << (8 * c);
          rows[rr * pitch_w + ww] = v;
        }
      }
      __syncthreads();
    }
    for (int t = tid; t < here; t += T) {
      uint32_t st[8];
      if (pitch_w > 0)
        sha256_leaf_staged(rows + t * pitch_w, (int)lw4, (int)L, st);
      else
        sha256_msg(src + (i0 + t) * L, L, 0x00, st);
      store_digest16(st, tree + (i0 + t) * 32ll);
    }
  }
  const uint4* pad = reinterpret_cast<const uint4*>(pad_digest);
  for (int i = n + tid; i < p; i += T) {
    uint4* o = reinterpret_cast<uint4*>(tree + i * 32ll);
    o[0] = pad[0];
    o[1] = pad[1];
  }
  // the level of `width` digests at forest row off hashes into the next
  int off = 0;
  for (int width = p; width > 1; width >>= 1) {
    __syncthreads();  // the level below is written and visible to the block
    const int half = width >> 1;
    for (int r = tid; r < half; r += T) {
      const uint4* c = reinterpret_cast<const uint4*>(tree + (off + 2ll * r) * 32);
      const uint4 q[4] = {c[0], c[1], c[2], c[3]};
      uint32_t l[8], rt[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[4 * i] = bswap32(q[i].x);
        l[4 * i + 1] = bswap32(q[i].y);
        l[4 * i + 2] = bswap32(q[i].z);
        l[4 * i + 3] = bswap32(q[i].w);
        rt[4 * i] = bswap32(q[2 + i].x);
        rt[4 * i + 1] = bswap32(q[2 + i].y);
        rt[4 * i + 2] = bswap32(q[2 + i].z);
        rt[4 * i + 3] = bswap32(q[2 + i].w);
      }
      uint32_t st[8];
      sha256_node(l, rt, st);
      store_digest16(st, tree + (off + width + r) * 32ll);
    }
    off += width;
  }
}

constexpr int kForestThreads = 128;
constexpr int kLeafSmemBytes = 64 * 1024;  // leaf staging a block

inline unsigned grid_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// out (rows, 32) = SHA-256([prefix byte] || row) of each msg_len-byte row of
// in; prefix < 0 hashes the rows alone; out must be 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sha256_rows(const void* in, long long rows, long long msg_len,
                           int prefix, void* out, void* stream) {
  if (rows < 1 || msg_len < 0 || prefix > 255 || ((uintptr_t)out & 15) ||
      (rows + kThreads - 1) / kThreads > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  sha256_rows_kernel<<<grid_for(rows), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, rows, msg_len, prefix, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// B Merkle trees of n leaf rows of L bytes each (tree t at shards + t n L)
// into forest (B, 2p - 1, 32), p = the next power of two >= n, leaf row
// first, root last; rows [n, p) of the leaf level copy pad_digest.  One
// launch, one block a tree.  shards may be unaligned; forest and pad_digest
// must be 16-byte aligned.  Returns cudaGetLastError() (0 on success).
extern "C" int merkle_forest(const void* shards, long long B, long long n,
                             long long L, void* forest, const void* pad_digest,
                             void* stream) {
  if (B < 1 || B > 0x7FFFFFFFll || n < 1 || n > (1ll << 20) || L < 0 ||
      ((uintptr_t)forest & 15) || ((uintptr_t)pad_digest & 15))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        merkle_forest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kLeafSmemBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  int p = 1;
  while (p < n) p <<= 1;
  int threads = p < kForestThreads ? p : kForestThreads;
  threads = (threads + 31) / 32 * 32;
  // rows staged at a pitch of 4 (mod 8) words: 16-byte reads of one word
  // offset by 8 lanes hit 8 distinct groups of 4 banks
  const long long lw4 = ((L + 3) / 4 + 3) / 4 * 4;
  long long pitch_w = lw4 % 8 == 4 ? lw4 : lw4 + 4;
  long long rows = kLeafSmemBytes / (pitch_w * 4);
  if (rows > threads) rows = threads;
  if (rows < 1) {  // a row larger than the staging budget: read global memory
    rows = threads;
    pitch_w = 0;
  }
  const int aligned16 = L % 16 == 0 && ((uintptr_t)shards & 15) == 0;
  const size_t smem = (size_t)(pitch_w * 4 * rows);
  merkle_forest_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)shards, (int)n, L, (uint8_t*)forest, p,
      (const uint8_t*)pad_digest, (int)rows, (int)pitch_w, aligned16);
  return (int)cudaGetLastError();
}

// ok[i] = branch i (depth sibling digests, bottom-up) proves leaf i at
// indices[i] under roots[i].  Returns cudaGetLastError() (0 on success).
extern "C" int merkle_verify(const void* roots, const void* leaves,
                             long long leaf_len, const void* branches, int depth,
                             const void* indices, void* ok, long long B,
                             void* stream) {
  if (B < 1 || leaf_len < 0 || depth < 0 ||
      (B + kThreads - 1) / kThreads > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  merkle_verify_kernel<<<grid_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)roots, (const uint8_t*)leaves, leaf_len,
      (const uint8_t*)branches, depth, (const long long*)indices,
      (uint8_t*)ok, B);
  return (int)cudaGetLastError();
}
