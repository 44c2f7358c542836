// K4 and K5: the frame pixel bridges for Hopper (sm_90a).
//
// Replace no Pallas kernel: the JAX package left its pixel bridges
// (`ingest9_planes`, `egress9_planes`, ternary_image_codec_tpu/ops/
// wordcodec.py:171-230) to XLA.  They were added because the same steps as
// plain torch are some 435 elementwise passes over the frame.  Their
// contracts are the plain twins `wordcodec.ingest9_ref` and
// `wordcodec.egress9_ref` (ops/wordcodec.py), which they match bit for bit:
//
// * K4, ingest: interleaved 8-bit RGB, pixels in raster order (n_px * 3
//   bytes at any address) -> word9 words (ceil(n_px / 2), 9) int8, word j
//   holding pixels 2j and 2j + 1, an odd last pixel paired with black:
//   BT.601 RGB -> YCbCr in float32 with lround, the quantiser, the trit
//   pack (ops/quant.py, include/io_image.hpp:66-99,
//   old/include/ternary_image_codec_v6_min.hpp:693-747);
// * K5, egress: word9 planes (n, 9, m) int8, any strides but consecutive
//   words -> interleaved RGB (n, m, 2, 3) uint8: the trit unpack with the
//   twin's floor semantics (any int8 symbol), the inverse quantiser with
//   the C++ double-lround fix-ups, YCbCr -> RGB (include/io_image.hpp:
//   94-124).
//
// Rounding.  Every product and sum of the BT.601 rows is one intrinsic
// with one rounding to float32 (`__fmul_rn`, `__fadd_rn`, `__fsub_rn`), in
// the twin's order, with its float32 constants (below, as hexadecimal
// literals): the compiler contracts no pair into an FMA, which would move
// ties.  The quantiser and its inverse are exact integer arithmetic whose
// divisions take nonnegative numerators, so truncation is the floor
// division of `quant.lround_ratio`; the inverse then applies the fix-ups
// that the wrapper uploads from `quant.Y_FIX_IN/OUT` and `C_FIX_IN/OUT`.
//
// What bounds them.  An 8K frame (7680 x 4320) is 99,532,800 bytes of RGB
// and 149,299,200 bytes of words: 248,832,000 B each way, 0.0743 ms at the
// H100's 3.35 TB/s.  The arithmetic is not small beside it: some 150
// instructions a pixel pair in K4 and 250 a word in K5 (the unpack's
// floor divisions, the inverse quantiser and its fix-ups, three rows of
// two pixels), so the issue rate sets the pace as much as the bytes.  The
// design moves every device-memory byte once, in 16-byte accesses, keeps
// the card full, and spends little beside the arithmetic:
//
// * Staged tiles.  A block takes a tile of 1,024 pixel pairs (words).  Its
//   bytes in device memory are one range each side (K5: one range a
//   plane), at any alignment: the block copies the 16-byte vectors that lie
//   whole inside the range by cp.async into shared memory, aligned as in
//   device memory, all in flight at once, and the up to 15 bytes at each
//   end by plain loads; the stores out go the same way.  So both sides of
//   the pass are coalesced whatever the tensors' offsets (the decode's
//   planes lie at a stride of 8,203 bytes).  Six (K4) or eight (K5) blocks
//   of 16 KB fit an SM, so one block's loads overlap the others'
//   arithmetic; a persistent, double-buffered variant was slower.
// * One pair a thread at a time.  A thread reads a pair's 6 bytes (K5: a
//   word's 9 symbols, one byte of each plane's row) from shared memory,
//   keeps every intermediate in registers and writes its 9 (K5: 6) bytes
//   to the staged output tile; neighbouring threads take neighbouring
//   pairs.
// * Cheap conversions.  A byte becomes float32 by its bits under the
//   exponent of 2^23 and one exact subtraction, and a rounded value in
//   [0, 255] becomes an integer by one add rounded down to 2^23's spacing:
//   full-rate instructions in place of the slower conversion units.  A
//   block copies the fix-up table into shared memory once; the loop over
//   it is not unrolled (quant's luma table holds one entry, its chroma
//   table none).
#include <cstdint>
#include <cuda_runtime.h>

#include "gf27.cuh"  // t3_error_string

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 1024;         // pixel pairs (words) a block
constexpr int ROW = TILE + 32;     // a staged plane row of K5
constexpr int MAX_FIX = 16;        // fix-ups a table (ops/bridge_cuda.py)

// The float32 constants of quant.ycbcr_rows and quant.rgb_rows.
constexpr float KY_R = 0x1.322d0ep-2f;     // 0.299
constexpr float KY_G = 0x1.2c8b44p-1f;     // 0.587
constexpr float KY_B = 0x1.d2f1aap-4f;     // 0.114
constexpr float KCB_R = -0x1.599242p-3f;   // -0.168736
constexpr float KCB_G = 0x1.5336dep-2f;    // 0.331264
constexpr float KCB_B = 0x1.000000p-1f;    // 0.5
constexpr float KCR_R = 0x1.000000p-1f;    // 0.5
constexpr float KCR_G = 0x1.acbc8cp-2f;    // 0.418688
constexpr float KCR_B = 0x1.4d0dd0p-4f;    // 0.081312
constexpr float KR_CR = 0x1.66e978p+0f;    // 1.402
constexpr float KG_CB = 0x1.606530p-2f;    // 0.344136
constexpr float KG_CR = 0x1.6da33cp-1f;    // 0.714136
constexpr float KB_CB = 0x1.c5a1cap+0f;    // 1.772
constexpr float HALF = 0x1.000000p-1f;     // 0.5
constexpr float C128 = 0x1.000000p+7f;     // 128.0

constexpr int TWO23 = 0x4B000000;          // the bits of 2^23

// float32 of an integer 0 <= b < 2^23, exactly
__device__ __forceinline__ float u2f(int b) {
  return __fsub_rn(__int_as_float(TWO23 | b), 8388608.0f);
}

// clamp(floor(v + 0.5), 0, 255) of float32 v (the twin's `_round_u8`):
// clamping before the floor gives the same integer, and x + 2^23 rounded
// down is 2^23 + floor(x) for x in [0, 255]
__device__ __forceinline__ int round_u8(float v) {
  float x = fminf(fmaxf(__fadd_rn(v, HALF), 0.0f), 255.0f);
  return __float_as_int(__fadd_rd(x, 8388608.0f)) - TWO23;
}

// lround(n * P / Q), Q > 0, for any integer n: sign(n) * floor((2P|n| + Q)
// / 2Q) (quant.lround_ratio); the numerator is nonnegative, so the
// unsigned division is the floor division
template <int P, int Q>
__device__ __forceinline__ int lround_ratio(int n) {
  int mag = (int)((2u * P * (unsigned)abs(n) + Q) / (2u * Q));
  return n < 0 ? -mag : mag;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Starts the copy of R byte ranges src[r][0, n) (device memory, any
// address) into s + r * row at [h_r, h_r + n), h_r = src[r] & 15, so that
// each staged row is aligned as its range: the 16-byte vectors that lie
// whole in a range by cp.async, the up to 15 bytes at either end of it by
// plain loads (item 32 r + l: head byte l < 16, tail byte l - 16), every
// load issued before the first store.  s and row are multiples of 16.  The
// caller waits (cp_async_wait) and syncs.
template <int R>
__device__ __forceinline__ void load_ranges(uint8_t* s, int row,
                                            const uint8_t* const* src,
                                            int n) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = (int)((uintptr_t)src[r] & 15);
    const uint8_t* base = src[r] - h;
    const int v0 = (h + 15) >> 4, v1 = (h + n) >> 4;
    for (int v = v0 + threadIdx.x; v < v1; v += THREADS)
      cp_async16(s + r * row + 16 * v, base + 16 * v);
  }
  constexpr int PER = (32 * R + THREADS - 1) / THREADS;
  int at[PER];
  uint8_t byte[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int k = threadIdx.x + j * THREADS, r = k >> 5, l = k & 31;
    const uint8_t* p = src[0];
#pragma unroll
    for (int q = 1; q < R; ++q)               // src[r], kept in registers
      if (q == r) p = src[q];
    at[j] = -1;
    if (r < R) {
      const int h = (int)((uintptr_t)p & 15);
      const int v0 = (h + 15) >> 4, v1 = (h + n) >> 4;
      const int e0 = min(16 * v0, h + n), e1 = max(16 * v1, e0);
      const int i = l < 16 ? h + l : e1 + l - 16;
      if (l < 16 ? i < e0 : i < h + n) {
        at[j] = r * row + i;
        byte[j] = p[i - h];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (at[j] >= 0) s[at[j]] = byte[j];
}

// Writes s[h, h + n) to dst[0, n), h = dst & 15: the 16-byte vectors that
// lie whole in the range with 16-byte stores, the bytes at either end one
// by one (threads 0..15 and 32..47).
__device__ __forceinline__ void store_staged(uint8_t* dst, const uint8_t* s,
                                             int n) {
  const int h = (int)((uintptr_t)dst & 15);
  uint8_t* base = dst - h;
  const int v0 = (h + 15) >> 4, v1 = (h + n) >> 4;
  for (int v = v0 + threadIdx.x; v < v1; v += THREADS)
    reinterpret_cast<uint4*>(base)[v] = reinterpret_cast<const uint4*>(s)[v];
  const int e0 = min(16 * v0, h + n), e1 = max(16 * v1, e0);
  const int t = threadIdx.x;
  if (t < e0 - h)
    base[h + t] = s[h + t];
  else if (t >= 32 && t < 32 + h + n - e1)
    base[e1 + t - 32] = s[e1 + t - 32];
}

// Yq, Cbq + 40, Crq + 40 of one 8-bit RGB pixel: the BT.601 rows of
// quant.ycbcr_rows, each rounded as `_round_u8`, then quantised
__device__ __forceinline__ void quant_pixel(int r8, int g8, int b8, int& yq,
                                            int& cbq, int& crq) {
  const float r = u2f(r8), g = u2f(g8), b = u2f(b8);
  const float y = __fadd_rn(__fadd_rn(__fmul_rn(KY_R, r), __fmul_rn(KY_G, g)),
                            __fmul_rn(KY_B, b));
  const float cb = __fadd_rn(
      __fadd_rn(__fsub_rn(__fmul_rn(KCB_R, r), __fmul_rn(KCB_G, g)),
                __fmul_rn(KCB_B, b)), C128);
  const float cr = __fadd_rn(
      __fsub_rn(__fsub_rn(__fmul_rn(KCR_R, r), __fmul_rn(KCR_G, g)),
                __fmul_rn(KCR_B, b)), C128);
  yq = clampi(lround_ratio<242, 255>(round_u8(y)), 0, 242);
  cbq = clampi(lround_ratio<40, 128>(round_u8(cb) - 128), -40, 40) + 40;
  crq = clampi(lround_ratio<40, 128>(round_u8(cr) - 128), -40, 40) + 40;
}

__global__ void __launch_bounds__(THREADS)
    ingest_kernel(const uint8_t* __restrict__ rgb, long long n_px,
                  uint8_t* __restrict__ out, long long n_words) {
  __shared__ __align__(16) uint8_t s_in[6 * TILE + 32];
  __shared__ __align__(16) uint8_t s_out[9 * TILE + 32];
  const long long p0 = (long long)blockIdx.x * TILE;
  const int np = (int)min((long long)TILE, n_words - p0);
  // the last tile of an odd frame holds 3 bytes fewer
  const int nin = (int)min(6LL * np, 3 * n_px - 6 * p0);
  const uint8_t* src = rgb + 6 * p0;
  const int hin = (int)((uintptr_t)src & 15);
  load_ranges<1>(s_in, 0, &src, nin);
  if ((int)threadIdx.x < 6 * np - nin)          // black beside the odd pixel
    s_in[hin + nin + threadIdx.x] = 0;
  cp_async_wait();
  __syncthreads();
  uint8_t* dst = out + 9 * p0;
  const int hout = (int)((uintptr_t)dst & 15);
  for (int q = threadIdx.x; q < np; q += THREADS) {
    const uint8_t* px = s_in + hin + 6 * q;
    int ya, cba, cra, yb, cbb, crb;
    quant_pixel(px[0], px[1], px[2], ya, cba, cra);
    quant_pixel(px[3], px[4], px[5], yb, cbb, crb);
    // the word's trits: pixel a's y, cb, cr in 0..12, pixel b's in 13..25,
    // trit 26 zero; symbol s is trits 3s..3s+2 (wordcodec._pack_pair).
    // Every field is nonnegative, so / and % are floor division and mod.
    const unsigned ua = ya, ub = yb, cua = cba, cub = cbb, rua = cra,
                   rub = crb;
    uint8_t* w = s_out + hout + 9 * q;
    w[0] = ua % 27;
    w[1] = ua / 27 + 9 * (cua % 3);
    w[2] = cua / 3;
    w[3] = rua % 27;
    w[4] = rua / 27 + 3 * (ub % 9);
    w[5] = ub / 9;
    w[6] = cub % 27;
    w[7] = cub / 27 + 3 * (rub % 9);
    w[8] = rub / 9;
  }
  __syncthreads();
  store_staged(dst, s_out, 9 * np);
}

// The fix-up table (ops/bridge_cuda.py host_consts): the counts of luma
// and chroma fix-ups, then their inputs and outputs, MAX_FIX entries each.
constexpr int FIX_WORDS = 2 + 4 * MAX_FIX;

struct EgressArgs {
  const int8_t* raw;               // word9 planes (n_sf, 9, m)
  long long s_sf, s_pl;            // their strides in bytes (words: 1)
  long long m;                     // words a superframe
  int tiles;                       // tiles a superframe
  const int* fix;                  // the fix-up table, on the device
  uint8_t* out;                    // (n_sf, m, 2, 3) contiguous
};

// floor division and modulus of an int8 symbol v by 3 or 9, as the twin's
// `_fdiv` and `%`: v + 135 is nonnegative, and 135 = 45 * 3 = 15 * 9
__device__ __forceinline__ int fdiv3(int v) {
  return (int)((unsigned)(v + 135) / 3u) - 45;
}
__device__ __forceinline__ int fmod3(int v) {
  return (int)((unsigned)(v + 135) % 3u);
}
__device__ __forceinline__ int fdiv9(int v) {
  return (int)((unsigned)(v + 135) / 9u) - 15;
}
__device__ __forceinline__ int fmod9(int v) {
  return (int)((unsigned)(v + 135) % 9u);
}

// quant.dequant_y / dequant_c: the exact lround, then the fix-ups in order
// (n == fix[i] gives fix[MAX_FIX + i])
template <int P, int Q>
__device__ __forceinline__ int dequant(int n, const int* fix, int nfix) {
  int v = lround_ratio<P, Q>(n);
#pragma unroll 1
  for (int i = 0; i < nfix; ++i)
    if (n == fix[i]) v = fix[MAX_FIX + i];
  return v;
}

// R, G, B of one quantised pixel (Yq, Cbq + 40, Crq + 40, any integers),
// into o[0..2]: egress9_ref's dequantisation and quant.rgb_rows; fix is
// the fix-up table
__device__ __forceinline__ void rgb_pixel(int yq, int cbq, int crq,
                                          const int* fix, uint8_t* o) {
  const int* cfix = fix + 2 + 2 * MAX_FIX;
  const int yi = clampi(dequant<255, 242>(yq, fix + 2, fix[0]), 0, 255);
  const int cbi = clampi(128 + dequant<128, 40>(cbq - 40, cfix, fix[1]), 0,
                         255);
  const int cri = clampi(128 + dequant<128, 40>(crq - 40, cfix, fix[1]), 0,
                         255);
  const float y = u2f(yi);
  const float cb = __fsub_rn(u2f(cbi), C128), cr = __fsub_rn(u2f(cri), C128);
  o[0] = round_u8(__fadd_rn(y, __fmul_rn(KR_CR, cr)));
  o[1] = round_u8(__fsub_rn(__fsub_rn(y, __fmul_rn(KG_CB, cb)),
                            __fmul_rn(KG_CR, cr)));
  o[2] = round_u8(__fadd_rn(y, __fmul_rn(KB_CB, cb)));
}

// Block b takes superframe b / tiles, its words from TILE * (b % tiles).
__global__ void __launch_bounds__(THREADS) egress_kernel(EgressArgs a) {
  __shared__ __align__(16) uint8_t s_in[9 * ROW];
  __shared__ __align__(16) uint8_t s_out[6 * TILE + 32];
  __shared__ int s_fix[FIX_WORDS];
  if (threadIdx.x < FIX_WORDS) s_fix[threadIdx.x] = a.fix[threadIdx.x];
  const int sf = blockIdx.x / a.tiles;
  const long long w0 = (long long)(blockIdx.x - sf * a.tiles) * TILE;
  const int nw = (int)min((long long)TILE, a.m - w0);
  const uint8_t* src[9];
  int row[9];                      // where each plane's row starts
#pragma unroll
  for (int p = 0; p < 9; ++p) {
    src[p] = (const uint8_t*)a.raw + sf * a.s_sf + p * a.s_pl + w0;
    row[p] = p * ROW + (int)((uintptr_t)src[p] & 15);
  }
  load_ranges<9>(s_in, ROW, src, nw);
  cp_async_wait();
  __syncthreads();
  uint8_t* dst = a.out + 6 * (sf * a.m + w0);
  const int hout = (int)((uintptr_t)dst & 15);
#pragma unroll 4
  for (int q = threadIdx.x; q < nw; q += THREADS) {
    int v[9];
#pragma unroll
    for (int p = 0; p < 9; ++p) v[p] = (int8_t)s_in[row[p] + q];
    // wordcodec._unpack_pair: each symbol's digits (v mod 3, floor(v / 3)
    // mod 3, floor(v / 9)), the top digit not reduced
    const int ya = v[0] + 27 * fmod9(v[1]), yb = fdiv3(v[4]) + 9 * v[5];
    const int cba = fdiv9(v[1]) + 3 * v[2], cbb = v[6] + 27 * fmod3(v[7]);
    const int cra = v[3] + 27 * fmod3(v[4]);
    const int crb = fdiv3(v[7]) + 9 * fmod9(v[8]);
    uint8_t* o = s_out + hout + 6 * q;
    rgb_pixel(ya, cba, cra, s_fix, o);
    rgb_pixel(yb, cbb, crb, s_fix, o + 3);
  }
  __syncthreads();
  store_staged(dst, s_out, 6 * nw);
}

}  // namespace

// rgb: n_px interleaved RGB pixels (3 * n_px bytes, any address); out: the
// (ceil(n_px / 2), 9) int8 words, contiguous, any address.
extern "C" int t3_bridge_ingest(const void* rgb, long long n_px, void* out,
                                void* stream) {
  if (n_px <= 0) return 0;
  const long long n_words = (n_px + 1) / 2;
  const long long blocks = (n_words + TILE - 1) / TILE;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ingest_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rgb, n_px, (uint8_t*)out, n_words);
  return (int)cudaGetLastError();
}

// raw: word9 planes (n_sf, 9, m) int8 with strides s_sf, s_pl (bytes,
// nonnegative) and consecutive words; fix: the wrapper's int32 fix-up
// table (ops/bridge_cuda.py host_consts) on the device; out: (n_sf, m, 2,
// 3) uint8, contiguous.
extern "C" int t3_bridge_egress(const void* raw, long long n_sf, long long m,
                                long long s_sf, long long s_pl,
                                const void* fix, void* out, void* stream) {
  if (n_sf <= 0 || m <= 0) return 0;
  const long long tiles = (m + TILE - 1) / TILE;
  if (tiles > 0x7fffffffLL / n_sf) return (int)cudaErrorInvalidValue;
  EgressArgs a;
  a.raw = (const int8_t*)raw;
  a.s_sf = s_sf;
  a.s_pl = s_pl;
  a.m = m;
  a.tiles = (int)tiles;
  a.fix = (const int*)fix;
  a.out = (uint8_t*)out;
  egress_kernel<<<(unsigned)(n_sf * tiles), THREADS, 0,
                  (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
