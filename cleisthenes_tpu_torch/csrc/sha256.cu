// Batched SHA-256, Merkle forests and branch verification on Hopper (sm_90a).
//
// Replaces the TPU kernels of cleisthenes_tpu/ops/sha256_xla.py:
//   K4 sha256_batch (:127)     sha256_rows: one digest per fixed-length row,
//                              a thread a row, the block's rows staged in
//                              shared memory a chunk of the message at a time
//   K5 build_forest (:157)     merkle_forest: one launch a forest, one block
//                              a tree
//   K6 verify_branches (:206)  merkle_verify: a thread a branch proof, its
//                              block's leaf rows staged in shared memory, no
//                              divergent branch
// and the forest half of K3 _decode_recheck_kernel (rs_xla.py:80).
//
// Merkle convention (ops/merkle.py): leaf = SHA256(0x00 || shard), node =
// SHA256(0x01 || left || right); leaf rows pad to a power of two with the
// digest sha256("cleisthenes-tpu:empty-leaf"), which the caller passes in.
//
// Bound on the H100: SHA-256 is integer work, 1,383 32-bit instructions per
// 64-byte compression as sm_90a issues them (14 per round: 6 SHF for the
// rotations, one LOP3 each for the two Sigmas' 3-way XORs, Ch and Maj, and
// 4 adds; 10 per schedule word; counted in the SASS by csrc/sass_ops.py)
// and 2,675 for a 65-byte Merkle node, against a few bytes of input per
// compression.  nvcc issues part of the adds as IMADs on the FMA pipe;
// the rest, 1,265 a compression and 2,421 a node, go to the INT32 pipe,
// and at its 16.7 T ops/s they bound every kernel here (all issued ones
// at the 33.4 T a second the SMs issue come second).  At the N=128 epoch
// the forest is 16,384 leaves of 129 bytes (3 compressions) plus 16,256
// nodes, the verify 16,384 branches of 3 compressions and 7 nodes: ~26 us
// of INT32-pipe work at peak; at N=512 the verify alone is 262,144
// branches of 3 compressions and 9 nodes, 6.7 G INT32-pipe instructions,
// 0.40 ms.  Each message has its own thread, so the 64 rounds
// run in registers with no cross-thread traffic: the 16-word schedule is a
// rolling window whose indices unroll to registers, the padded block is
// assembled from the row's words (no host concatenation of the domain
// byte, no padded copy), and a verify thread keeps its running digest in
// registers through all D levels, building each 65-byte node message from
// the two digests with word shifts.
//
// Staged messages (staged_block, shared by all three kernels): a message's
// bytes sit in a thread's slot of shared memory behind a 16-byte lead, and
// each message block's 16 big-endian words are built from five 16-byte
// reads of the slot with byte permutes, at any byte offset of the message
// in the slot (the offset is the row's address mod 16, less one for a
// prefix byte, which then replaces the byte before the row).
//
// Leaf rows (merkle_forest_kernel and merkle_verify_kernel share this): a
// block stages its rows in shared memory with coalesced 16-byte loads (byte
// loads when a row is not 16-byte aligned), each row at the same offset
// of its slot, zero past its end, and hashes rows past the 64 KB staging
// budget straight from global memory.
//
// sha256_rows (K4) stages, for each message chunk of kChunkBlocks
// compressions, the 16-byte granules of global memory that hold the block's
// rows' bytes of that chunk, every row whole in one coalesced sweep (rows
// are contiguous, so a warp's loads are consecutive granules), each row's
// granules into its slot as they lie: the row's address mod 16 becomes its
// offset in the slot, so any row length and alignment takes 16-byte loads,
// and a row of any length streams through a fixed slot.  Bytes of the slot
// past the row's end are its neighbour's and are masked.  A block of 32 to
// 128 threads (spread_threads) spreads the rows over every SM; a thread a
// row leaves one warp an SM sub-partition at the table's 16,384 rows, where
// the compressions' issue, not the loads, is the limit.
//
// The forest (merkle_forest_kernel) is one launch with one block per tree,
// where the reference's and this port's first design ran a launch per level,
// each with a dependent compression chain and, near the root, one or two
// threads a tree.  It stores every digest as two 16-byte words and hashes
// the tree level by level with a barrier between levels; a level reads its
// children from the forest in global memory, which a barrier makes visible
// within the block, so any p up to the 65,536 leaves of the GF(2^16) codec
// works.
//
// The verify (merkle_verify_kernel) puts each level's digests in left/right
// order with selects on bit d of the index, then hashes one node: the lanes
// of a warp verify consecutive leaves of a tree (protocol/spmd.py), so the
// low index bits differ across a warp, and a branch on them ran both node
// hashes at 5 of the 7 (N=128) or 9 (N=512) levels, 1.5x the instructions
// (csrc/sass_ops.py checks that the kernel holds one node's code).
// Siblings and roots load as 16-byte words, the next level's while a node
// hashes.  Its block size is picked from B and the SM count
// (verify_threads): 256 threads, or fewer when blocks that large would
// leave SMs without one.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

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

// Message block `blk` (message bytes [64 blk, 64 blk + 64)) of a message of
// `total` bytes, as 16 big-endian words in w, from a slot of shared memory
// (16-byte aligned, `nq` quads readable, zeros read past them) whose byte
// e + 64 qb is the block's first message byte (e in [0, 32)).  With a
// prefix (>= 0) the message's byte 0 is the prefix, whatever the slot holds
// there.  The padding (0x80 at byte `total`, the bit length in the last
// block) is added here; with kMask the slot's bytes past `total` are not
// the message's (a neighbour's row) and are cleared, without it the slot
// holds zeros there.  Five 16-byte reads give the 20 words that hold the
// block's 68-byte window; word i of the block is bytes e + 4 i .. + 3 of it,
// two selects (on e's word offset) and a byte permute (on its byte offset).
template <bool kMask>
__device__ __forceinline__ void staged_block(const uint32_t* slot, int e, int qb, int nq,
                                             long long blk, long long total, int prefix,
                                             uint32_t w[16]) {
  const int q0 = (e >> 4) + 4 * qb;
  const int d = (e >> 2) & 3;
  const uint32_t sel = 0x0123u + 0x1111u * (uint32_t)(e & 3);
  uint32_t s[20];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const uint4 v = q0 + k < nq ? reinterpret_cast<const uint4*>(slot)[q0 + k]
                                : make_uint4(0u, 0u, 0u, 0u);
    s[4 * k] = v.x; s[4 * k + 1] = v.y; s[4 * k + 2] = v.z; s[4 * k + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < 19; ++i) s[i] = (d & 1) ? s[i + 1] : s[i];
#pragma unroll
  for (int i = 0; i < 17; ++i) s[i] = (d & 2) ? s[i + 2] : s[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = __byte_perm(s[i], s[i + 1], sel);
  const long long pos = 64 * blk;
  const long long tp = total - pos;  // the 0x80 byte's place in the block
  if (kMask && tp < 64) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const long long v = tp - 4 * i;  // message bytes in word i
      if (v <= 0) w[i] = 0;
      else if (v < 4) w[i] &= ~0u << (8 * (4 - (int)v));
    }
  }
  if (pos == 0 && prefix >= 0) w[0] = (w[0] & 0x00FFFFFFu) | ((uint32_t)prefix << 24);
  if (tp >= 0 && tp < 64) {
    const int tw = (int)tp >> 2;
    const uint32_t tbit = 0x80u << (24 - 8 * ((int)tp & 3));
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i == tw) w[i] |= tbit;
  }
  if (tp <= 64 - 9) {  // the last block
    const unsigned long long bitlen = (unsigned long long)total * 8ull;
    w[14] = (uint32_t)(bitlen >> 32);
    w[15] = (uint32_t)bitlen;
  }
}

// SHA-256(0x00 || row) of a row staged in its slot behind a 16-byte lead
// (row byte 0 at slot word 4), zero from row word `lw` on, `lw4` words (lw
// rounded up to 4) readable: the message's byte m is slot byte 15 + m.
__device__ void sha256_leaf_staged(const uint32_t* slot, int lw4, int len,
                                   uint32_t st[8]) {
  const int total = len + 1;
  const int nblocks = (total + 9 + 63) / 64;
  sha256_init(st);
  for (int q = 0; q < nblocks; ++q) {
    uint32_t w[16];
    staged_block<false>(slot, 15, q, 1 + lw4 / 4, q, total, 0x00, w);
    sha256_compress(st, w);
  }
}

// Words of a staged row of L bytes: L / 4 rounded up to a 16-byte multiple.
__host__ __device__ __forceinline__ long long staged_words(long long L) {
  return ((L + 3) / 4 + 3) / 4 * 4;
}

// Rows [0, here) of src (row i at src + i L) into shared memory at pitch_w
// words a slot, each row behind its slot's 16-byte lead, little-endian
// words, zero from byte L to the row's staged_words(L); 16-byte loads when
// `aligned16` (L a multiple of 16 and src 16-byte aligned), else byte
// loads.  The whole block takes part.
__device__ void stage_rows(const uint8_t* __restrict__ src, long long L, int here,
                           uint32_t* rows, int pitch_w, int aligned16) {
  const int T = blockDim.x, tid = threadIdx.x;
  if (aligned16) {
    const int chunks = (int)(L / 16);
    for (int u = tid; u < here * chunks; u += T) {
      const int rr = u / chunks, cc = u - rr * chunks;
      reinterpret_cast<uint4*>(rows + rr * pitch_w + 4)[cc] =
          reinterpret_cast<const uint4*>(src + rr * L)[cc];
    }
  } else {
    const int words = (int)staged_words(L);
    for (int u = tid; u < here * words; u += T) {
      const int rr = u / words, ww = u - rr * words;
      const uint8_t* r = src + rr * L;
      uint32_t v = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4ll * ww + c < L) v |= (uint32_t)r[4 * ww + c] << (8 * c);
      rows[rr * pitch_w + 4 + ww] = v;
    }
  }
}

// SHA-256(0x00 || row t) of L bytes: from its staged words when pitch_w > 0,
// else from `global` (the row in global memory; rows past the staging budget).
__device__ __forceinline__ void leaf_digest(const uint32_t* rows, int t, int pitch_w,
                                            long long L, const uint8_t* global,
                                            uint32_t st[8]) {
  if (pitch_w > 0)
    sha256_leaf_staged(rows + t * pitch_w, (int)staged_words(L), (int)L, st);
  else
    sha256_msg(global, L, 0x00, st);
}

// A digest stored as 32 bytes: two 16-byte loads when `vec`, else byte loads.
__device__ __forceinline__ void load_digest(const uint8_t* p, int vec, uint32_t w[8]) {
  if (vec) {
    const uint4 lo = reinterpret_cast<const uint4*>(p)[0];
    const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
    w[0] = bswap32(lo.x); w[1] = bswap32(lo.y); w[2] = bswap32(lo.z); w[3] = bswap32(lo.w);
    w[4] = bswap32(hi.x); w[5] = bswap32(hi.y); w[6] = bswap32(hi.z); w[7] = bswap32(hi.w);
  } else {
    load_words(p, w);
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

  for (int i0 = 0; i0 < n; i0 += rows_per_batch) {
    const int here = min(rows_per_batch, n - i0);
    if (pitch_w > 0) {
      __syncthreads();  // the last batch's readers are done
      stage_rows(src + i0 * L, L, here, rows, pitch_w, aligned16);
      __syncthreads();
    }
    for (int t = tid; t < here; t += T) {
      uint32_t st[8];
      leaf_digest(rows, t, pitch_w, L, src + (i0 + t) * L, st);
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

// Thread i checks branch i: the leaf digest of row i (the block's rows
// staged in batches of rows_per_batch, as the forest stages them), then each
// level's node with the digests put in order by selects on the index bit,
// the next level's sibling loading meanwhile, against roots[i].  `vec`:
// roots and branches are 16-byte aligned.
__global__ void merkle_verify_kernel(const uint8_t* __restrict__ roots,
                                     const uint8_t* __restrict__ leaves,
                                     long long L,
                                     const uint8_t* __restrict__ branches,
                                     int depth,
                                     const long long* __restrict__ indices,
                                     uint8_t* __restrict__ ok, long long B,
                                     int rows_per_batch, int pitch_w,
                                     int aligned16, int vec) {
  extern __shared__ uint4 smem[];
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem);
  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * blockDim.x;
  const int here_all = (int)min((long long)blockDim.x, B - first);
  const uint8_t* src = leaves + first * L;
  // the index, root and first sibling load while the leaf hashes
  const bool live = tid < here_all;
  const long long i = first + tid;
  const uint8_t* br = branches + i * depth * 32ll;
  uint32_t idx = 0, root[8], sib[8];
  if (live) {
    idx = (uint32_t)indices[i];  // u32 as the reference's kernel
    load_digest(roots + i * 32, vec, root);
    if (depth > 0) load_digest(br, vec, sib);
  }
  uint32_t cur[8];
  for (int i0 = 0; i0 < here_all; i0 += rows_per_batch) {
    const int here = min(rows_per_batch, here_all - i0);
    if (pitch_w > 0) {
      __syncthreads();  // the last batch's readers are done
      stage_rows(src + i0 * L, L, here, rows, pitch_w, aligned16);
      __syncthreads();
    }
    if (tid >= i0 && tid < i0 + here)
      leaf_digest(rows, tid - i0, pitch_w, L, src + tid * L, cur);
  }
  if (!live) return;
  for (int lvl = 0; lvl < depth; ++lvl) {
    uint32_t next[8] = {};  // the next level's sibling, in flight during this node
    if (lvl + 1 < depth) load_digest(br + (lvl + 1) * 32, vec, next);
    uint32_t l[8], r[8];
    const bool right = idx & 1u;  // cur is the right child
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l[j] = right ? sib[j] : cur[j];
      r[j] = right ? cur[j] : sib[j];
    }
    sha256_node(l, r, cur);
#pragma unroll
    for (int j = 0; j < 8; ++j) sib[j] = next[j];
    idx >>= 1;
  }
  uint32_t diff = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) diff |= cur[j] ^ root[j];
  ok[i] = diff == 0 ? 1 : 0;
}

// K4's chunk: compressions a thread makes from one staging of its row, and
// its slot: a 16-byte lead, the chunk's row bytes at their address's offset
// mod 16 (at most 17 granules), padded to 4 (mod 8) words as the leaf rows
// are.
constexpr int kChunkBlocks = 4;
constexpr int kSlotWords = 76;
static_assert(4 * kSlotWords >= 16 + 16 * ((15 + 64 * kChunkBlocks + 15) / 16) &&
                  4 * kSlotWords >= 16 * (2 + 4 * (kChunkBlocks - 1) + 5) &&
                  kSlotWords % 8 == 4,
              "a slot holds a chunk's granules and its last block's reads");

// Thread t digests row first + t (msg_len bytes at in + row msg_len; with a
// prefix byte when prefix >= 0), a chunk of kChunkBlocks compressions a
// staging: the whole block first copies the chunk's granules of every row
// into the rows' slots, consecutive threads on consecutive granules.  A
// granule is read only when it holds a byte of the chunk's row bytes, so no
// read leaves the 16-byte-aligned granules of the input.
__global__ void sha256_rows_kernel(const uint8_t* __restrict__ in, long long rows,
                                   long long msg_len, int prefix,
                                   uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  uint32_t* slots = reinterpret_cast<uint32_t*>(smem);
  const int T = blockDim.x, tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * T;
  const int here = (int)min((long long)T, rows - first);
  const int pre = prefix >= 0 ? 1 : 0;
  const long long total = msg_len + pre;
  const long long nblocks = (total + 9 + 63) / 64;
  const uint8_t* src = in + first * msg_len;
  uint32_t st[8];
  sha256_init(st);
  for (long long b0 = 0; b0 < nblocks; b0 += kChunkBlocks) {
    // the chunk's row bytes [k0, k1): message bytes [64 b0, 64 (b0 + kChunkBlocks))
    const long long k0 = max(0ll, 64 * b0 - pre);
    const long long k1 = min(msg_len, 64 * (b0 + kChunkBlocks) - pre);
    const int len = k1 > k0 ? (int)(k1 - k0) : 0;
    __syncthreads();  // the last chunk's readers are done
    if (len > 0) {
      const int ng = (15 + len + 15) >> 4;  // granules a row, at most
      for (int u = tid; u < here * ng; u += T) {
        const int rr = u / ng, g = u - rr * ng;
        const uintptr_t a = (uintptr_t)(src + rr * msg_len + k0);
        if (g < (int)(((a & 15) + len + 15) >> 4))
          reinterpret_cast<uint4*>(slots + rr * kSlotWords)[1 + g] =
              __ldg(reinterpret_cast<const uint4*>(a & ~(uintptr_t)15) + g);
      }
    }
    __syncthreads();
    if (tid < here) {
      const int off = (int)((uintptr_t)(src + tid * msg_len + k0) & 15);
      const int e = 16 + off - (b0 == 0 ? pre : 0);
      for (int qb = 0; qb < kChunkBlocks && b0 + qb < nblocks; ++qb) {
        uint32_t w[16];
        staged_block<true>(slots + tid * kSlotWords, e, qb, kSlotWords / 4, b0 + qb, total,
                           prefix, w);
        sha256_compress(st, w);
      }
    }
  }
  if (tid < here) store_digest16(st, out + (first + tid) * 32);
}

constexpr int kForestThreads = 128;
constexpr int kLeafSmemBytes = 64 * 1024;  // leaf staging a block

// How a block of `threads` threads stages leaf rows of L bytes at src:
// rows a batch, the pitch in words (0: hash from global memory) and
// whether 16-byte loads apply.
struct LeafPlan {
  int rows, pitch_w, aligned16;
  size_t smem() const { return (size_t)pitch_w * 4 * rows; }
};

inline LeafPlan leaf_plan(long long L, int threads, const void* src) {
  // rows staged behind a 16-byte lead at a pitch of 4 (mod 8) words:
  // 16-byte reads of one word offset by 8 lanes hit 8 distinct groups of 4
  // banks
  const long long lw4 = staged_words(L);
  long long pitch_w = lw4 % 8 == 0 ? lw4 + 4 : lw4 + 8;
  long long rows = kLeafSmemBytes / (pitch_w * 4);
  if (rows > threads) rows = threads;
  if (rows < 1) {  // a row larger than the staging budget: read global memory
    rows = threads;
    pitch_w = 0;
  }
  return {(int)rows, (int)pitch_w, L % 16 == 0 && ((uintptr_t)src & 15) == 0};
}

// Threads a block of a thread-a-message kernel over B messages on `sms`
// SMs: `most`, halved (down to 32) while blocks that large would leave SMs
// without one.
inline int spread_threads(long long B, int sms, int most) {
  int t = most;
  while (t > 32 && (B + t - 1) / t < sms) t >>= 1;
  return t;
}

// The verify's: at most 256 (the N=128 epoch's 16,384 branches take
// 64-thread blocks, 256 of them; the N=512 epoch's 262,144 take 256-thread
// blocks).
inline int verify_threads(long long B, int sms) { return spread_threads(B, sms, 256); }

// K4's: at most 128, whose slots (38,912 bytes) fit the default 48 KB (the
// table's 16,384 rows take 64-thread blocks, 256 of them; 8,192 rows take
// 32-thread blocks).
constexpr int kRowsMostThreads = 128;

// What a launch needs to know of the current device, set up once a device under
// a lock, since a process may drive several cards: its SM count, and the Merkle
// kernels' shared memory limit raised to the staging budget.
constexpr int kMaxDevices = 64;
struct DeviceState {
  bool ready = false;
  int sms = 0;
};
std::mutex g_device_mu;
DeviceState g_device[kMaxDevices];

// The current device's SM count in *sms, its state set up on first use.
inline cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_device_mu);
  DeviceState& d = g_device[dev];
  if (!d.ready) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(merkle_forest_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kLeafSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(merkle_verify_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kLeafSmemBytes);
    if (err != cudaSuccess) return err;
    d.ready = true;
  }
  *sms = d.sms;
  return cudaSuccess;
}

}  // namespace

// out (rows, 32) = SHA-256([prefix byte] || row) of each msg_len-byte row of
// in (any alignment); prefix < 0 hashes the rows alone; out must be 16-byte
// aligned.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int sha256_rows(const void* in, long long rows, long long msg_len,
                           int prefix, void* out, void* stream) {
  if (rows < 1 || msg_len < 0 || prefix > 255 || ((uintptr_t)out & 15) ||
      (rows + 31) / 32 > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const int threads = spread_threads(rows, sms, kRowsMostThreads);
  sha256_rows_kernel<<<(unsigned)((rows + threads - 1) / threads), threads,
                       (size_t)threads * kSlotWords * 4, (cudaStream_t)stream>>>(
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
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  int p = 1;
  while (p < n) p <<= 1;
  int threads = p < kForestThreads ? p : kForestThreads;
  threads = (threads + 31) / 32 * 32;
  const LeafPlan plan = leaf_plan(L, threads, shards);
  merkle_forest_kernel<<<(unsigned)B, threads, plan.smem(), (cudaStream_t)stream>>>(
      (const uint8_t*)shards, (int)n, L, (uint8_t*)forest, p,
      (const uint8_t*)pad_digest, plan.rows, plan.pitch_w, plan.aligned16);
  return (int)cudaGetLastError();
}

// ok[i] = branch i (depth sibling digests, bottom-up) proves leaf i (row i
// of leaves, leaf_len bytes) at the low 32 bits of indices[i] under
// roots[i].  Any alignment.  One launch on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int merkle_verify(const void* roots, const void* leaves,
                             long long leaf_len, const void* branches, int depth,
                             const void* indices, void* ok, long long B,
                             void* stream) {
  if (B < 1 || leaf_len < 0 || depth < 0 || (B + 31) / 32 > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const int threads = verify_threads(B, sms);
  const LeafPlan plan = leaf_plan(leaf_len, threads, leaves);
  const int vec = (((uintptr_t)roots | (uintptr_t)branches) & 15) == 0;
  merkle_verify_kernel<<<(unsigned)((B + threads - 1) / threads), threads, plan.smem(),
                         (cudaStream_t)stream>>>(
      (const uint8_t*)roots, (const uint8_t*)leaves, leaf_len,
      (const uint8_t*)branches, depth, (const long long*)indices,
      (uint8_t*)ok, B, plan.rows, plan.pitch_w, plan.aligned16, vec);
  return (int)cudaGetLastError();
}
