// Native host runtime of the PyTorch port: byte-level hot paths on the host
// (container IO packing, stream signatures).  A copy of the JAX package's
// runtime/src/t3native.cpp, built by the port's runtime/native.py into its
// own library; it mirrors the reference's C++ host layer
// (old/include/ternary_packing.hpp, src/t3dump.cpp:48-69).
//
// Exposed as a plain C ABI consumed via ctypes.
#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// ---- CRC-12 (poly 0x80F, init 0), bit-faithful to src/t3dump.cpp:48-62 ----
uint16_t t3n_crc12_0x80f(const uint8_t* data, size_t len) {
    static uint16_t M[4096];
    static uint16_t K[256];
    static bool init = false;
    if (!init) {
        for (int state = 0; state < 4096; ++state) {
            uint16_t c = (uint16_t)state;
            for (int i = 0; i < 8; ++i) {
                uint16_t msb = (c >> 11) & 1u;
                c = (uint16_t)((c << 1) & 0xFFF);
                if (msb) c ^= 0x80F;
            }
            M[state] = c;
        }
        for (int byte = 0; byte < 256; ++byte) {
            uint16_t c = 0;
            for (int bit = 7; bit >= 0; --bit) {
                uint16_t inb = (uint16_t)((byte >> bit) & 1);
                uint16_t msb = (c >> 11) & 1u;
                c = (uint16_t)((c << 1) & 0xFFF);
                if (msb ^ inb) c ^= 0x80F;
            }
            K[byte] = c;
        }
        init = true;
    }
    uint16_t crc = 0;
    for (size_t i = 0; i < len; ++i) crc = (uint16_t)(M[crc] ^ K[data[i]]);
    return (uint16_t)(crc & 0xFFF);
}

// ---- base-243: 5 trits -> byte, tail-aware (old/include/ternary_packing.hpp
//      :10-59 semantics).  Returns number of bytes written; *tail_trits gets
//      n % 5.  out must hold ceil(n/5) bytes. -------------------------------
size_t t3n_pack_base243(const uint8_t* trits, size_t n, uint8_t* out,
                        uint8_t* tail_trits) {
    size_t i = 0, o = 0;
    while (i + 5 <= n) {
        uint32_t v = (uint32_t)(trits[i] % 3) + 3u * (trits[i + 1] % 3)
                   + 9u * (trits[i + 2] % 3) + 27u * (trits[i + 3] % 3)
                   + 81u * (trits[i + 4] % 3);
        out[o++] = (uint8_t)v;
        i += 5;
    }
    size_t left = n - i;
    if (tail_trits) *tail_trits = (uint8_t)left;
    if (left) {
        uint32_t v = 0, p = 1;
        for (size_t k = 0; k < left; ++k) { v += p * (uint32_t)(trits[i + k] % 3); p *= 3; }
        out[o++] = (uint8_t)v;
    }
    return o;
}

// ---- inverse: emit exactly total_trits trits from base-243 bytes ----------
// 256 x 5 digit LUT instead of a div/mod loop per trit: whole bytes copy
// 5 digits at once
int t3n_unpack_base243(const uint8_t* data, size_t len, size_t total_trits,
                       uint8_t* out) {
    static uint8_t D[256][5];
    static bool init = false;
    if (!init) {
        for (int b = 0; b < 256; ++b) {
            uint32_t v = (uint32_t)b;
            for (int k = 0; k < 5; ++k) { D[b][k] = (uint8_t)(v % 3); v /= 3; }
        }
        init = true;
    }
    size_t full = total_trits / 5;
    if (len < (total_trits + 4) / 5) return -1;
    for (size_t i = 0; i < full; ++i)
        memcpy(out + 5 * i, D[data[i]], 5);
    size_t emitted = 5 * full;
    if (emitted < total_trits)
        memcpy(out + emitted, D[data[full]], total_trits - emitted);
    return 0;
}

// ---- word13 (1 px/word uint32) pack/unpack, host-side bulk path -----------
// code = Y + 243*((Cb+40) + 81*(Cr+40))  (src/ternary_image_codec_v6_min.cpp:44-61)
void t3n_pack13(const int32_t* yq, const int32_t* cbq, const int32_t* crq,
                size_t n, uint32_t* out) {
    for (size_t i = 0; i < n; ++i) {
        uint32_t y = (uint32_t)(yq[i] < 0 ? 0 : (yq[i] > 242 ? 242 : yq[i]));
        int32_t cb = cbq[i] < -40 ? -40 : (cbq[i] > 40 ? 40 : cbq[i]);
        int32_t cr = crq[i] < -40 ? -40 : (crq[i] > 40 ? 40 : crq[i]);
        out[i] = y + 243u * ((uint32_t)(cb + 40) + 81u * (uint32_t)(cr + 40));
    }
}

void t3n_unpack13(const uint32_t* code, size_t n, int32_t* yq, int32_t* cbq,
                  int32_t* crq) {
    for (size_t i = 0; i < n; ++i) {
        uint32_t v = code[i];
        yq[i] = (int32_t)(v % 243u); v /= 243u;
        cbq[i] = (int32_t)(v % 81u) - 40; v /= 81u;
        crq[i] = (int32_t)(v % 81u) - 40;
    }
}

// ---- CRC-32 (zlib polynomial 0xEDB88320, reflected), PCLMUL-folded -------
// The container payload CRC runs over ~112 MB per 8K frame, the serve
// path's largest piece of host work.  The classic 4x128-bit PCLMULQDQ
// folding (Intel "Fast CRC Computation ... Using PCLMULQDQ" scheme)
// folds 64 bytes a step; scalar slice-by-8 fallback below.

static uint32_t crc32_table8[8][256];
static bool crc32_tab_init = false;
static void crc32_init_tab() {
    for (int i = 0; i < 256; ++i) {
        uint32_t c = (uint32_t)i;
        for (int k = 0; k < 8; ++k)
            c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1u)));
        crc32_table8[0][i] = c;
    }
    for (int i = 0; i < 256; ++i)
        for (int j = 1; j < 8; ++j)
            crc32_table8[j][i] =
                (crc32_table8[j - 1][i] >> 8)
                ^ crc32_table8[0][crc32_table8[j - 1][i] & 0xFF];
    crc32_tab_init = true;
}

static uint32_t crc32_scalar(const uint8_t* p, size_t n, uint32_t crc) {
    if (!crc32_tab_init) crc32_init_tab();
    crc = ~crc;
    while (n >= 8) {
        uint64_t v;
        memcpy(&v, p, 8);
        v ^= crc;
        crc = crc32_table8[7][v & 0xFF]
            ^ crc32_table8[6][(v >> 8) & 0xFF]
            ^ crc32_table8[5][(v >> 16) & 0xFF]
            ^ crc32_table8[4][(v >> 24) & 0xFF]
            ^ crc32_table8[3][(v >> 32) & 0xFF]
            ^ crc32_table8[2][(v >> 40) & 0xFF]
            ^ crc32_table8[1][(v >> 48) & 0xFF]
            ^ crc32_table8[0][(v >> 56) & 0xFF];
        p += 8;
        n -= 8;
    }
    while (n--) crc = (crc >> 8) ^ crc32_table8[0][(crc ^ *p++) & 0xFF];
    return ~crc;
}

#if defined(__x86_64__)
#include <immintrin.h>
// 4x128-bit PCLMUL folding for the reflected polynomial (Intel "Fast CRC
// Computation Using PCLMULQDQ" / Linux crc32-pclmul constants).  Fold
// identity: x' = clmul(x_lo, K_lo) ^ clmul(x_hi, K_hi) ^ next_data keeps
// the accumulator congruent (mod P) to the conditioned prefix, so
// CRC(msg) == CRC_raw(accumulator_bytes || tail) -- the final reduction
// is a 16-byte scalar run (provable, no Barrett constants to get wrong).
__attribute__((target("pclmul,sse4.1")))
static uint32_t crc32_pclmul(const uint8_t* p, size_t n, uint32_t crc0) {
    if (n < 256) return crc32_scalar(p, n, crc0);
    // set_epi64x(hi, lo): imm 0x00 multiplies x_lo by K_lo, 0x11 x_hi by
    // K_hi.  K512 = {lo: x^(512+32), hi: x^(512-32)} mod P (reflected),
    // K128 likewise for 128-bit distance.
    const __m128i K512 = _mm_set_epi64x(0x00000001c6e41596, 0x0000000154442bd4);
    const __m128i K128 = _mm_set_epi64x(0x00000000ccaa009e, 0x00000001751997d0);
    __m128i x0 = _mm_loadu_si128((const __m128i*)(p + 0));
    __m128i x1 = _mm_loadu_si128((const __m128i*)(p + 16));
    __m128i x2 = _mm_loadu_si128((const __m128i*)(p + 32));
    __m128i x3 = _mm_loadu_si128((const __m128i*)(p + 48));
    // init conditioning == XOR ~init into the first 32 message bits
    x0 = _mm_xor_si128(x0, _mm_cvtsi32_si128((int)~crc0));
    p += 64;
    n -= 64;
    while (n >= 64) {
        __m128i t;
        t = _mm_clmulepi64_si128(x0, K512, 0x00);
        x0 = _mm_clmulepi64_si128(x0, K512, 0x11);
        x0 = _mm_xor_si128(_mm_xor_si128(x0, t),
                           _mm_loadu_si128((const __m128i*)(p + 0)));
        t = _mm_clmulepi64_si128(x1, K512, 0x00);
        x1 = _mm_clmulepi64_si128(x1, K512, 0x11);
        x1 = _mm_xor_si128(_mm_xor_si128(x1, t),
                           _mm_loadu_si128((const __m128i*)(p + 16)));
        t = _mm_clmulepi64_si128(x2, K512, 0x00);
        x2 = _mm_clmulepi64_si128(x2, K512, 0x11);
        x2 = _mm_xor_si128(_mm_xor_si128(x2, t),
                           _mm_loadu_si128((const __m128i*)(p + 32)));
        t = _mm_clmulepi64_si128(x3, K512, 0x00);
        x3 = _mm_clmulepi64_si128(x3, K512, 0x11);
        x3 = _mm_xor_si128(_mm_xor_si128(x3, t),
                           _mm_loadu_si128((const __m128i*)(p + 48)));
        p += 64;
        n -= 64;
    }
    // fold the 4 accumulators into one (128-bit distance each step)
    __m128i t;
    t = _mm_clmulepi64_si128(x0, K128, 0x00);
    x0 = _mm_clmulepi64_si128(x0, K128, 0x11);
    x1 = _mm_xor_si128(x1, _mm_xor_si128(x0, t));
    t = _mm_clmulepi64_si128(x1, K128, 0x00);
    x1 = _mm_clmulepi64_si128(x1, K128, 0x11);
    x2 = _mm_xor_si128(x2, _mm_xor_si128(x1, t));
    t = _mm_clmulepi64_si128(x2, K128, 0x00);
    x2 = _mm_clmulepi64_si128(x2, K128, 0x11);
    x3 = _mm_xor_si128(x3, _mm_xor_si128(x2, t));
    while (n >= 16) {
        t = _mm_clmulepi64_si128(x3, K128, 0x00);
        x3 = _mm_clmulepi64_si128(x3, K128, 0x11);
        x3 = _mm_xor_si128(_mm_xor_si128(x3, t),
                           _mm_loadu_si128((const __m128i*)p));
        p += 16;
        n -= 16;
    }
    // scalar finish.  With raw(s, buf) = the table run from state s and
    // crc32_scalar(buf, c) == ~raw(~c, buf):
    //   result = ~raw(~init, msg) = ~raw(0, msg_conditioned)
    //          = ~raw(0, acc_bytes || tail)            [fold invariant]
    //   ~raw(0, acc) == crc32_scalar(acc, 0xFFFFFFFF), and chaining the
    //   tail through crc32_scalar re-enters the raw run at raw(0, acc).
    uint8_t acc[16];
    _mm_storeu_si128((__m128i*)acc, x3);
    uint32_t crc = crc32_scalar(acc, 16, 0xFFFFFFFFu);
    if (n) crc = crc32_scalar(p, n, crc);
    return crc;
}
#endif

uint32_t t3n_crc32(const uint8_t* data, size_t len, uint32_t init) {
#if defined(__x86_64__)
    if (__builtin_cpu_supports("pclmul") && __builtin_cpu_supports("sse4.1"))
        return crc32_pclmul(data, len, init);
#endif
    return crc32_scalar(data, len, init);
}

int t3n_abi_version(void) { return 2; }

}  // extern "C"
