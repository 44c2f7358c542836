// K2: RS(26,k) decode over GF(27), one thread per codeword.
//
// Replaces the Pallas TPU kernel ternary_image_codec_tpu/ops/rs_pallas.py
// `_kernel` (launched by `decode_dig_fused`): syndromes, inversionless
// Berlekamp-Massey, Chien search, Omega = S*sigma mod x^r, Forney with the
// field inverse, correction, and a syndrome recheck of the corrected word.
// Its contract is the port's twin `rs.correct_pm_ref`: in (3, 26, B) int8
// digits (plane-major, block axis minor; a digit outside 0..2 counts as its
// value mod 3), out (3, k, B) data digits and ok (B,):
//   ok = (recheck zero && nroots <= t && nroots == L) || zero syndrome,
// a zero-syndrome block returns its input as it is, and any other its
// corrected digits mod 3.
//
// What bounds it on the H100: not bytes.  A codeword is 78 bytes in and
// 3k + 1 out, so the memory bound is 0.011 ms at 262,144 codewords and
// under a microsecond at the main path's 6,144; the time goes to the
// dependent integer work of each codeword's chain, and at the main path's
// sizes to the latency of one dirty warp's chain.  The design, one thread
// per codeword with all state in registers and every loop unrolled over a
// compile-time r (so every index is static), in the steps that each made
// it faster on the card (PERF.md, PR 4):
//  1. the GF(27) tables (1,552 bytes) are not built per block: each block
//     copies the image rs_tables.cuh holds (generated by ops/rs_tables.py)
//     to shared memory in 16-byte loads; blocks of 64 threads spread the
//     path's windows over 96 SMs;
//  2. the 78 digits are packed 4 to a register, and the syndromes and the
//     recheck are the GF(3) map S2 of rs._matrices_pm(k): one dp4a per
//     word against the packed map row, known when the kernel is compiled
//     (so an immediate operand, not a constant-cache read), and one mod 3
//     per syndrome digit, no table reads.  A warp whose 32 codewords all
//     have zero syndromes writes its input's data and returns (most warps
//     of a repair window).
// What is left reads the tables in shared memory: the BM, which is the
// reference's `_bm_core` (ternary_image_codec_tpu/ops/rs.py:167) step for
// step, so L and with it the nroots == L rule match it exactly; Chien;
// Omega; and Forney at the roots.  The correction is added digit by digit
// into the packed word (a byte-wise mod 3).  Reads and writes are
// coalesced: the block index is the minor axis.
#include "gf27.cuh"
#include "rs_tables.cuh"

namespace {

using t3::GfTables;
using t3::N;

constexpr int kThreads = 64;   // threads per block
constexpr int NW = 20;         // 78 digits of a codeword, 4 to a word

// x mod 3 for a dp4a sum of int8 digits against map entries 0..2 (the
// sum is above -2^15, so the bias keeps it non-negative)
__device__ __forceinline__ int mod3_sum(int x) {
  return (int)((unsigned)(x + 3 * 16384) % 3u);
}

// bytes 0..5 -> bytes mod 3, four at a time
__device__ __forceinline__ uint32_t mod3_bytes(uint32_t v) {
  return v - 3u * (((v + 0x01010101u) >> 2) & 0x01010101u);
}

// int8 digits -> digits mod 3 (0..2), four at a time.  A byte u with sign
// bit s is the digit u - 256 s = u + 2 s mod 3; as 16 = 4 = 1 mod 3, adding
// its nibbles and then its 2-bit pieces keeps it mod 3 and shrinks it to
// 0..32, 0..11, 0..5
__device__ __forceinline__ uint32_t mod3_digits(uint32_t v) {
  uint32_t a = (v & 0x0f0f0f0fu) + ((v >> 4) & 0x0f0f0f0fu) + ((v >> 6) & 0x02020202u);
  a = (a & 0x03030303u) + ((a >> 2) & 0x0f0f0f0fu);
  a = (a & 0x03030303u) + ((a >> 2) & 0x03030303u);
  return mod3_bytes(a);
}

// byte f of the packed digits (f = 26 e + i: digit e of symbol i)
__device__ __forceinline__ int digit(const uint32_t (&x)[NW], int f) {
  return (int)((x[f / 4] >> (8 * (f % 4))) & 0xffu);
}

// syndrome digit q (digit q / R of S_{q % R}) of packed digits: row q of
// rs._matrices_pm(k)["S2"], packed the same way, against them, mod 3
template <int R>
__device__ __forceinline__ int s2_row(const uint32_t (&x)[NW], int q) {
  int acc = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) acc = __dp4a((int)x[w], (int)kS2[R / 2 - 1][q][w], acc);
  return mod3_sum(acc);
}

// the data digits (3, K) of packed digits to out (3, K, B), coalesced
template <int K>
__device__ __forceinline__ void store_data(const uint32_t (&x)[NW],
                                           int8_t* __restrict__ out,
                                           long long B, long long b) {
#pragma unroll
  for (int e = 0; e < 3; ++e)
#pragma unroll
    for (int i = 0; i < K; ++i)
      out[(long long)(e * K + i) * B + b] = (int8_t)digit(x, e * N + i);
}

// BM, Chien, Omega and Forney of one dirty codeword, then the recheck
template <int R>
__device__ void repair(const GfTables& t, const uint32_t (&x)[NW],
                       const int (&sd)[3 * R], bool szero,
                       int8_t* __restrict__ out, bool* __restrict__ ok,
                       long long B, long long b) {
  constexpr int K = N - R;
  constexpr int SMAX = R + 1;
  constexpr int T = R / 2;

  int S[R];
#pragma unroll
  for (int j = 0; j < R; ++j) S[j] = sd[j] + 3 * sd[R + j] + 9 * sd[2 * R + j];

  // inversionless BM, B(x) kept pre-shifted (Bx = x^m B)
  int sig[SMAX], Bx[SMAX];
#pragma unroll
  for (int j = 0; j < SMAX; ++j) {
    sig[j] = j == 0 ? 1 : 0;
    Bx[j] = j == 1 ? 1 : 0;
  }
  int bd = 1, L = 0;
#pragma unroll
  for (int n = 0; n < R; ++n) {
    int d = 0;
#pragma unroll
    for (int i = 0; i <= n; ++i) d = t3::gadd(t, d, t3::gmul(t, sig[i], S[n - i]));
    const bool dz = d == 0;
    const bool grow = !dz && 2 * L <= n;
    int base[SMAX];
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      base[j] = grow ? sig[j] : Bx[j];
      if (!dz) sig[j] = t3::gsub(t, t3::gmul(t, bd, sig[j]), t3::gmul(t, d, Bx[j]));
    }
    Bx[0] = 0;
#pragma unroll
    for (int j = 1; j < SMAX; ++j) Bx[j] = base[j - 1];
    if (grow) {
      bd = d;
      L = n + 1 - L;
    }
  }

  // Chien search over all 26 positions: root at i iff sigma(alpha^-i) == 0
  unsigned roots = 0;
  int nroots = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int ev = 0;
#pragma unroll
    for (int d = 0; d < SMAX; ++d) ev = t3::gadd(t, ev, t3::gmul(t, sig[d], t3::gpow(t, -i * d)));
    if (ev == 0) {
      roots |= 1u << i;
      ++nroots;
    }
  }

  // Omega = S(x) sigma(x) mod x^r
  int om[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    int acc = 0;
#pragma unroll
    for (int i = 0; i <= j; ++i) acc = t3::gadd(t, acc, t3::gmul(t, S[i], sig[j - i]));
    om[j] = acc;
  }

  // Forney at the roots: corrected = recv + Omega(X) / sigma'(X), added
  // digit by digit into the packed word's digits mod 3
  uint32_t fx[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) fx[w] = mod3_digits(x[w]);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (roots & (1u << i)) {
      int num = 0, den = 0;
#pragma unroll
      for (int d = 0; d < R; ++d) num = t3::gadd(t, num, t3::gmul(t, om[d], t3::gpow(t, -i * d)));
#pragma unroll
      for (int d = 1; d < SMAX; ++d) {
        if (d % 3) {
          const int term = t3::gmul(t, sig[d], t3::gpow(t, -i * (d - 1)));
          den = t3::gadd(t, den, t3::gmul(t, d % 3, term));
        }
      }
      const unsigned y = (unsigned)t3::gmul(t, num, t.inv[den]);
      fx[i / 4] += (y % 3u) << (8 * (i % 4));
      fx[(N + i) / 4] += ((y / 3u) % 3u) << (8 * ((N + i) % 4));
      fx[(2 * N + i) / 4] += (y / 9u) << (8 * ((2 * N + i) % 4));
    }
  }
#pragma unroll
  for (int w = 0; w < NW; ++w) fx[w] = mod3_bytes(fx[w]);

  // recheck the corrected word
  bool rezero = true;
#pragma unroll
  for (int q = 0; q < 3 * R; ++q) rezero = rezero && s2_row<R>(fx, q) == 0;
  ok[b] = (rezero && nroots <= T && nroots == L) || szero;
#pragma unroll
  for (int w = 0; w < NW; ++w) fx[w] = szero ? x[w] : fx[w];
  store_data<K>(fx, out, B, b);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
rs_correct_kernel(const int8_t* __restrict__ recv, int8_t* __restrict__ out,
                  bool* __restrict__ ok, long long B) {
  // the field tables: 16-byte words of the global image, stored to shared
  // memory once the codeword's loads are in flight
  __shared__ GfTables t;
  constexpr int kWords = sizeof(GfTables) / 16;
  constexpr int kPer = (kWords + kThreads - 1) / kThreads;
  const uint4* img = reinterpret_cast<const uint4*>(kGfTableImage);
  uint4 tw[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int w = threadIdx.x + p * kThreads;
    if (w < kWords) tw[p] = img[w];
  }

  // the codeword's 78 digits (plane-major, block index minor), 4 a word;
  // lanes past B hold the zero codeword
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = b < B;
  uint32_t x[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) x[w] = 0;
  if (live) {
#pragma unroll
    for (int f = 0; f < 3 * N; ++f)
      x[f / 4] |= (uint32_t)(uint8_t)recv[(long long)f * B + b] << (8 * (f % 4));
  }

  // syndrome digits: the GF(3) map S2 by dp4a (map rows are warp-uniform
  // constant operands)
  int sd[3 * R];
  bool szero = true;
#pragma unroll
  for (int q = 0; q < 3 * R; ++q) {
    sd[q] = s2_row<R>(x, q);
    szero = szero && sd[q] == 0;
  }

#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int w = threadIdx.x + p * kThreads;
    if (w < kWords) reinterpret_cast<uint4*>(&t)[w] = tw[p];
  }
  __syncthreads();

  // a warp whose every codeword is clean returns its input's data
  if (__all_sync(0xffffffffu, szero)) {
    if (live) {
      store_data<N - R>(x, out, B, b);
      ok[b] = true;
    }
    return;
  }
  if (live) repair<R>(t, x, sd, szero, out, ok, B, b);
}

}  // namespace

// recv (3, 26, B) int8, out (3, k, B) int8, ok (B,) bool; k in {18,20,22,24}.
extern "C" int t3_rs_correct(const void* recv, void* out, void* ok,
                             long long B, int k, void* stream) {
  if (B <= 0) return 0;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* in = (const int8_t*)recv;
  int8_t* o = (int8_t*)out;
  bool* f = (bool*)ok;
  switch (26 - k) {
    case 2: rs_correct_kernel<2><<<blocks, kThreads, 0, s>>>(in, o, f, B); break;
    case 4: rs_correct_kernel<4><<<blocks, kThreads, 0, s>>>(in, o, f, B); break;
    case 6: rs_correct_kernel<6><<<blocks, kThreads, 0, s>>>(in, o, f, B); break;
    case 8: rs_correct_kernel<8><<<blocks, kThreads, 0, s>>>(in, o, f, B); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
