// Batched SHA-256 and Merkle branch verification on Hopper (sm_90a).
//
// Replaces the TPU kernels of cleisthenes_tpu/ops/sha256_xla.py:
//   K4 sha256_batch (:127)     sha256_rows: one digest per fixed-length row
//   K5 build_forest (:157)     sha256_rows, once per tree level (the leaf
//                              launch also writes the empty-leaf padding)
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
// launch costs.  The design gives each message its own thread
// so the 64 rounds run in registers with no cross-thread traffic: the
// 16-word schedule is a rolling window whose indices unroll to registers,
// the padded block is assembled from the row bytes on the fly (no host
// concatenation of the domain byte, no padded copy), and a verify thread
// keeps its running digest in registers through all D levels, building each
// 65-byte node message from the two digests with word shifts.

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

__device__ __forceinline__ void store_digest(const uint32_t st[8], uint8_t* out) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[4 * i] = (uint8_t)(st[i] >> 24);
    out[4 * i + 1] = (uint8_t)(st[i] >> 16);
    out[4 * i + 2] = (uint8_t)(st[i] >> 8);
    out[4 * i + 3] = (uint8_t)st[i];
  }
}

__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t w[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
           ((uint32_t)p[4 * i + 2] << 8) | (uint32_t)p[4 * i + 3];
}

// Thread t -> output row r = t % rows_out of group g = t / rows_out.  Rows
// r < rows_in digest the msg_len bytes at in + g*in_group_stride +
// r*in_row_stride; rows r >= rows_in copy pad_digest (Merkle leaf padding).
__global__ void sha256_rows_kernel(const uint8_t* __restrict__ in,
                                   long long groups, long long rows_in,
                                   long long in_group_stride,
                                   long long in_row_stride, long long msg_len,
                                   int prefix, uint8_t* __restrict__ out,
                                   long long rows_out, long long out_group_stride,
                                   const uint8_t* __restrict__ pad_digest) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= groups * rows_out) return;
  const long long g = t / rows_out;
  const long long r = t - g * rows_out;
  uint8_t* dst = out + g * out_group_stride + r * 32;
  if (r >= rows_in) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dst[i] = pad_digest[i];
    return;
  }
  uint32_t st[8];
  sha256_msg(in + g * in_group_stride + r * in_row_stride, msg_len, prefix, st);
  store_digest(st, dst);
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

inline unsigned grid_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Digest rows (see sha256_rows_kernel); prefix < 0 hashes the rows alone.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sha256_rows(const void* in, long long groups, long long rows_in,
                           long long in_group_stride, long long in_row_stride,
                           long long msg_len, int prefix, void* out,
                           long long rows_out, long long out_group_stride,
                           const void* pad_digest, void* stream) {
  const long long n = groups * rows_out;
  if (groups < 1 || rows_in < 1 || rows_out < rows_in || msg_len < 0 ||
      prefix > 255 || (rows_out > rows_in && pad_digest == nullptr) ||
      (n + kThreads - 1) / kThreads > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  sha256_rows_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, groups, rows_in, in_group_stride, in_row_stride,
      msg_len, prefix, (uint8_t*)out, rows_out, out_group_stride,
      (const uint8_t*)pad_digest);
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
