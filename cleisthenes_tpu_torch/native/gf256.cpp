// Native GF(2^8) Reed-Solomon kernel.
//
// The reference's only genuinely native hot loop is the GF(2^8)
// multiply-accumulate inside klauspost/reedsolomon's SSSE3/AVX2
// assembly (reference go.mod:10, consumed at rbc/rbc.go:98).  This is
// the same computation as portable C++: out = mat (*) data over
// GF(2^8) with the 0x11D (AES-erasure) polynomial, table-driven, with
// the inner byte loop written so the compiler auto-vectorizes the
// XOR/table-gather.  Exposed through ctypes (cleisthenes_tpu.native)
// as the 'cpp' ErasureCoder backend; the Python numpy backend stays
// the correctness reference, the XLA backend the TPU path.

#include <cstdint>
#include <cstring>

namespace {

// log/exp tables for generator 2 over poly 0x11D (matches ops/gf256.py)
struct Tables {
    uint8_t mul[256][256];
    Tables() {
        uint16_t exp[512];
        uint16_t log[256];
        uint16_t x = 1;
        for (int i = 0; i < 255; ++i) {
            exp[i] = static_cast<uint16_t>(x);
            log[x] = static_cast<uint16_t>(i);
            x <<= 1;
            if (x & 0x100) x ^= 0x11D;
        }
        for (int i = 255; i < 512; ++i) exp[i] = exp[i - 255];
        for (int a = 0; a < 256; ++a) {
            mul[0][a] = 0;
            mul[a][0] = 0;
        }
        for (int a = 1; a < 256; ++a)
            for (int b = 1; b < 256; ++b)
                mul[a][b] =
                    static_cast<uint8_t>(exp[log[a] + log[b]]);
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

}  // namespace

extern "C" {

// out[m, L] = mat[m, k] (*) data[k, L] over GF(2^8).
// Rows are contiguous; caller owns all buffers.
void gf256_matmul(const uint8_t* mat, const uint8_t* data, uint8_t* out,
                  int m, int k, int len) {
    const Tables& t = tables();
    std::memset(out, 0, static_cast<size_t>(m) * len);
    for (int i = 0; i < m; ++i) {
        uint8_t* orow = out + static_cast<size_t>(i) * len;
        for (int j = 0; j < k; ++j) {
            const uint8_t c = mat[i * k + j];
            if (c == 0) continue;
            const uint8_t* trow = t.mul[c];
            const uint8_t* drow = data + static_cast<size_t>(j) * len;
            if (c == 1) {
                for (int l = 0; l < len; ++l) orow[l] ^= drow[l];
            } else {
                for (int l = 0; l < len; ++l) orow[l] ^= trow[drow[l]];
            }
        }
    }
}

// Batched variant: B independent (m, k) x (k, L) products with a
// shared matrix (the N concurrent RBC instances of one epoch).
void gf256_matmul_batch(const uint8_t* mat, const uint8_t* data,
                        uint8_t* out, int batch, int m, int k, int len) {
    const size_t dstride = static_cast<size_t>(k) * len;
    const size_t ostride = static_cast<size_t>(m) * len;
    for (int b = 0; b < batch; ++b)
        gf256_matmul(mat, data + b * dstride, out + b * ostride, m, k, len);
}

int gf256_selftest() {
    // 2 * 3 = 6, 0x80 * 2 = 0x1D (overflow wraps through the poly)
    const Tables& t = tables();
    if (t.mul[2][3] != 6) return 1;
    if (t.mul[0x80][2] != 0x1D) return 2;
    if (t.mul[0xFF][1] != 0xFF) return 3;
    return 0;
}

}  // extern "C"
