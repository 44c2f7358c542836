// K3: superframe encode for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package left the encode to XLA
// (`_encode_parts_pm`, ternary_image_codec_tpu/ops/pipeline.py:533-688, and
// `pipeline_v3.encode_fn_v3`).  It was added because that step, as plain
// torch, is thousands of gathers and mod-3 products a frame.  Its contract
// is `encode_superframes` (ops/encode.py), its twin on the CPU: in RAW words
// (n, n_raw, 9) int8, out wire planes (n, 9, 6 + H) int8, for every layout
// the port encodes (any UEP grouping, P5's interleave, the beacon band, any
// n_raw and H).  Per superframe: the 26 useful trits of each word form the
// stream, stream symbol i being trits 3i..3i+2 (trit 26 of a word is
// dropped); band b's data column j is stream symbol 9j + b (or perm[9j + b]
// under P5, zero at and past the stream length L); band b cuts its column
// into RS(26, k) codewords, parity one GF(3)-linear map of the 3k data
// digits; a uniform band's codewords fill its row from the top, the beacon
// band's run down its payload rows; cells past the last whole codeword hold
// zero data; every cell is scrambled (its band's offset at its row's parity
// added to each digit) except the beacon cells, which carry the beacon
// symbol; the 6 header words come first.
//
// What bounds it.  An 8K frame (2,025 superframes of 8,192 words) reads
// 149.3 MB of RAW words and writes 187.3 MB of wire planes, 336.6 MB in
// all: 0.1005 ms at the H100's 3.35 TB/s.  The arithmetic is small but
// irregular: about 71,000 stream symbols a superframe, each made from two
// RAW bytes whose trits are misaligned (26 trits a word), scrambled and
// stored, and 7.2 M codewords a frame through a (3k x 3r) GF(3) map.  So
// the issue rate of byte-wise work, in the ALUs and in shared memory, not
// device memory, sets the pace; the design moves every device-memory byte
// once, keeps every intermediate on chip, and spends few instructions and
// few shared-memory accesses per byte:
//
// * Units.  A thread block takes one unit of one superframe (the host's
//   table, ops/enc_cuda.py `units`): the data columns [u, u + 1) * 1,760
//   of every band, that is the codewords of each band whose data starts
//   there, the output columns of each band that hold them, and the window
//   of RAW words (groups of three words) that their data reads.  Nothing
//   assumes a superframe fits in shared memory: `entry()`'s one 720p
//   superframe is 278 units.
// * Stream symbols once.  `cp.async` copies the window into shared memory
//   (16-byte copies, the edge bytes with plain loads, zeros past the
//   superframe's words).  A thread turns one group of three words (27 RAW
//   bytes, read as 8 words) into its 26 stream symbols: each symbol's
//   three digits come from the digit words (a table: d0 | d1 << 8 |
//   d2 << 16 of any int8 byte) of two bytes by one `__byte_perm` whose
//   selector is a compile-time constant, and are stored packed two bits
//   a digit, two symbols a store.
// * Parity on tensor cores.  A packed symbol spreads to a digit word in two
//   instructions, and a digit word is an int8 fragment of four k-values:
//   sixteen codewords of one band are the A operand of
//   `mma.sync.m16n8k32.s8`, the parity map of the band's k the B operand,
//   copied into shared memory at the block's start and held in registers
//   while a warp's tasks keep one k (n-tile nt gives digit nt of each of
//   the 8 parity symbols, so a lane ends with all three digits of its
//   parity symbols).  The scramble offset is added to each sum before its
//   one mod 3.  A unit's tasks take the bands of one k together, so a warp
//   seldom loads another map.
// * Staging.  The warp that reads a data symbol for the A operand also
//   stores it, scrambled by a table, into a shared copy of its band's
//   output columns, aligned as the output is; header, beacon and tail
//   cells are filled there too.  Then the block writes the columns out
//   with 16-byte stores.
#include "gf27.cuh"

namespace {

constexpr int BANDS = 9;
constexpr int N = t3::N;
constexpr int HDR = 6;                 // header words
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 16;               // codewords of one band per mma tile
// the host's table (ops/enc_cuda.py), int32 words:
constexpr int C_H = 1, C_P5 = 3, C_L = 4, C_BCBAND = 5, C_BCP = 6,
              C_BCSYM = 7, C_SYMB = 8;
constexpr int SCR_OFF = 16;            // [2 * band + row parity] offsets
constexpr int HDR_OFF = SCR_OFF + 2 * BANDS;
constexpr int BAND_OFF = HDR_OFF + HDR * BANDS;
constexpr int BAND_WORDS = 8;          // k, kind, blocks, parity map,
                                       // staging offset
constexpr int PMAX = 3;
constexpr int BF_OFF = BAND_OFF + BAND_WORDS * BANDS;
constexpr int BF_WORDS = 32 * 18;      // [lane][kt][nt][reg]
constexpr int UNIT_OFF = BF_OFF + PMAX * BF_WORDS;
constexpr int UNIT_WORDS = 72;
constexpr int UNIT_BAND = 8;           // m0, m1, tasks; then a slot a band,
constexpr int SLOT_WORDS = 7;          // in task order: band, cw0, cw1,
                                       // col0, col1, fill_from, task0
constexpr int BEACON = 1;
// dynamic shared memory: the unit's record, the band table, the scramble
// offsets and the parity maps' B fragments (copied from the host's table),
// digit words, the scramble table, the unit's stream symbols, then each
// band's staging
constexpr int SM_BAND = UNIT_WORDS * 4;
constexpr int SM_OFF = SM_BAND + BAND_WORDS * BANDS * 4;
constexpr int SM_DW = 704;
constexpr int SM_SCR = SM_DW + 1024;   // 3 x 64: packed digits scrambled
constexpr int SM_BF = SM_SCR + 256;    // the parity maps' B fragments
constexpr int SM_SYM = SM_BF + PMAX * BF_WORDS * 4;
static_assert(SM_OFF + 2 * BANDS * 4 <= SM_DW, "parameters overlap");

// Trit d of stream symbol 26m + r is trit (3r + d) % 26 of word 3m +
// (3r + d) / 26: byte trit_byte(r, d) of the group's 27, digit trit_digit.
__host__ __device__ constexpr int trit_byte(int r, int d) {
  return 9 * ((3 * r + d) / 26) + (3 * r + d) % 26 / 3;
}
__host__ __device__ constexpr int trit_digit(int r, int d) {
  return (3 * r + d) % 26 % 3;
}
// The __byte_perm selector taking the three digits of symbol r from the
// digit words of bytes trit_byte(r, 0) and the next (byte 3, a zero, last).
__host__ __device__ constexpr uint32_t trit_sel(int r) {
  return (uint32_t)(4 * (trit_byte(r, 0) - trit_byte(r, 0)) + trit_digit(r, 0))
         | (uint32_t)(4 * (trit_byte(r, 1) - trit_byte(r, 0))
                      + trit_digit(r, 1)) << 4
         | (uint32_t)(4 * (trit_byte(r, 2) - trit_byte(r, 0))
                      + trit_digit(r, 2)) << 8
         | 0x3000u;
}

struct Args {
  const int8_t* raw;
  long long n_raw;
  const int* perm;
  const int* consts;
  int8_t* out;
  int n_units;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// x mod 3 for 0 <= x < 98,304
__device__ __forceinline__ int mod3(int x) {
  return x - 3 * (int)(((unsigned)x * 43691u) >> 17);
}

// A symbol's digits packed two bits each (d0 | d1 << 2 | d2 << 4) -> its
// digit word d0 | d1 << 8 | d2 << 16.
__device__ __forceinline__ uint32_t spread(uint32_t x) {
  return (x * 4161u) & 0x030303u;
}


// What a warp's task reads: its band's codewords cw0 + gq and cw0 + gq + 8
// of the lane (gq, q), the unit's stream symbols, the band's scramble
// offsets, and where band cell j lands (stage[row(j)]).
struct Task {
  const uint8_t* sym;                  // stream symbol s at sym[s - 26 m0],
                                       // its digits packed (spread)
  const uint8_t* scr;                  // scr[64 o + x]: packed x scrambled
  uint8_t* stage;                      // stage[body row]
  const int* perm;
  int cw0, cw1, k, b, m0, o0, o1, L, bc_p, q;
};

// Body row of band cell j: the cell itself, or the beacon band's payload
// cell j, which skips the beacon rows (multiples of the period).
template <bool BEACON_BAND>
__device__ __forceinline__ int cell_row(const Task& t, int j) {
  return BEACON_BAND ? j + j / (t.bc_p - 1) + 1 : j;
}

// Sixteen codewords of one band: data symbols from the stream (scrambled
// into the staging, and as digit words the A operand), parity on tensor
// cores (lane (gq, q) ends with parity symbols 2q, 2q + 1 of its two rows),
// scrambled into the staging: o added to each digit sum before its mod 3.
// Uniform bands have an even k, so a data cell's row parity is its
// symbol's (q & 1) and a parity cell's is c' & 1.
template <bool P5, bool BEACON_BAND>
__device__ __forceinline__ void codewords(const Task& t,
                                          const uint32_t (&bf)[3][3][2]) {
  const bool ok[2] = {t.cw0 < t.cw1, t.cw0 + 8 < t.cw1};
  // stream symbol of data cell (row x, symbol q) of the task: 9 (cw k + q)
  // + b, plus 9 c for symbol q + c
  const int s0 = 9 * (t.cw0 * t.k + t.q) + t.b;
  const int s[2] = {s0, s0 + 72 * t.k};
  const int od = (t.q & 1) ? t.o1 : t.o0;
  int acc[3][4];
#pragma unroll
  for (int nt = 0; nt < 3; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[nt][x] = 0;
#pragma unroll
  for (int kt = 0; kt < 3; ++kt) {
    uint32_t av[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      // A fragment: x & 1 picks the row (cw0 + gq or + 8), x >> 1 the
      // symbol 8kt + q or 8kt + 4 + q
      const int c = 8 * kt + 4 * (x >> 1);
      const bool live = ok[x & 1] && c + t.q < t.k;
      int i = s[x & 1] + 9 * c;
      if (P5) i = live && i < t.L ? __ldg(t.perm + i) : -1;
      const int xs = live && (!P5 || i >= 0) ? t.sym[i - 26 * t.m0] : 0;
      if (live) {
        const int j = (t.cw0 + 8 * (x & 1)) * N + c + t.q;
        const int h = cell_row<BEACON_BAND>(t, j);
        t.stage[h] =
            t.scr[64 * (BEACON_BAND ? ((h & 1) ? t.o1 : t.o0) : od) + xs];
      }
      av[x] = spread(xs);
    }
#pragma unroll
    for (int nt = 0; nt < 3; ++nt)
      mma_s8(acc[nt], av, bf[kt][nt][0], bf[kt][nt][1]);
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int c = 2 * t.q + (x & 1);
    if (ok[x >> 1] && c < N - t.k) {
      const int h = cell_row<BEACON_BAND>(t, (t.cw0 + 8 * (x >> 1)) * N
                                                 + t.k + c);
      const int o = BEACON_BAND ? ((h & 1) ? t.o1 : t.o0)
                                : ((x & 1) ? t.o1 : t.o0);
      t.stage[h] = (uint8_t)(mod3(acc[0][x] + o) + 3 * mod3(acc[1][x] + o)
                             + 9 * mod3(acc[2][x] + o));
    }
  }
}

template <bool P5>
__global__ void __launch_bounds__(THREADS, 4)
superframe_encode_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t sm[];
  int* U = reinterpret_cast<int*>(sm);               // the unit's record
  int* Bt = reinterpret_cast<int*>(sm + SM_BAND);    // the band table
  int* Off = reinterpret_cast<int*>(sm + SM_OFF);    // scramble offsets
  uint32_t* dw = reinterpret_cast<uint32_t*>(sm + SM_DW);
  uint8_t* scr = sm + SM_SCR;
  uint8_t* sym = sm + SM_SYM;
  const int tid = threadIdx.x;
  const long long sf = blockIdx.x / a.n_units;
  const int* __restrict__ C = a.consts;
  const int H = C[C_H], row_len = HDR + H;
  const int bc_band = C[C_BCBAND], bc_p = C[C_BCP], bc_sym = C[C_BCSYM];
  // the staging, which holds the RAW window until the symbols are made
  uint8_t* stage = sym + C[C_SYMB];
  int8_t* out_sf = a.out + sf * BANDS * row_len;
  // the staging of slot R's band: byte x is output column col0 + x,
  // aligned as the output is mod 16
  auto stg = [&](const int* R) {
    const uintptr_t dst = (uintptr_t)(out_sf + R[0] * row_len + R[3]);
    return stage + Bt[BAND_WORDS * R[0] + 4] + (dst & 15);
  };

  // ---- parameters and tables ----
  const int ub = UNIT_OFF + (int)(blockIdx.x % a.n_units) * UNIT_WORDS;
  if (tid < UNIT_WORDS)
    U[tid] = C[ub + tid];
  else if (tid < UNIT_WORDS + BAND_WORDS * BANDS)
    Bt[tid - UNIT_WORDS] = C[BAND_OFF + tid - UNIT_WORDS];
  else if (tid < UNIT_WORDS + BAND_WORDS * BANDS + 2 * BANDS)
    Off[tid - UNIT_WORDS - BAND_WORDS * BANDS] =
        C[SCR_OFF + tid - UNIT_WORDS - BAND_WORDS * BANDS];
  if (tid < 192) {
    const int o = tid >> 6, d0 = tid & 3, d1 = tid >> 2 & 3, d2 = tid >> 4 & 3;
    scr[tid] = (uint8_t)((d0 + o) % 3 + 3 * ((d1 + o) % 3) + 9 * ((d2 + o) % 3));
  }
  for (int x = tid; x < 256; x += THREADS) {
    const int v = (int)(int8_t)x + 243;              // floor digits of any int8
    dw[x] = (uint32_t)(v % 3) | (uint32_t)(v / 3 % 3) << 8
            | (uint32_t)(v / 9 % 3) << 16;
  }

  // ---- the RAW window, bytes [27 m0, 27 m1) of the superframe, into the
  // staging: 16-byte copies, the edges byte by byte, zeros past the words --
  const int m0 = C[ub], m1 = C[ub + 1];
  const long long sf_bytes = 9 * a.n_raw;
  const long long w0 = 27LL * m0;
  const int wlen = 27 * (m1 - m0);
  const int vlen = (int)max(0LL, min((long long)wlen, sf_bytes - w0));
  const uintptr_t src = (uintptr_t)(a.raw + sf * sf_bytes + w0);
  uint8_t* rw = stage + (src & 15);                  // rw[x]: window byte x
  {
    const uintptr_t end = src + vlen;
    const uintptr_t up = (src + 15) & ~(uintptr_t)15;
    const uintptr_t down = end & ~(uintptr_t)15;
    const uintptr_t a0 = up < end ? up : end;
    const uintptr_t a1 = down > a0 ? down : a0;
    const int nvec = (int)((a1 - a0) >> 4);
    for (int x = tid; x < nvec; x += THREADS)
      cp_async16(rw + (a0 - src) + 16 * x, (const void*)(a0 + 16 * x));
    const int head = (int)(a0 - src), tail = (int)(end - a1);
    if (tid < head) rw[tid] = reinterpret_cast<const uint8_t*>(src)[tid];
    else if (tid >= 32 && tid < 32 + tail)
      rw[a1 - src + tid - 32] = reinterpret_cast<const uint8_t*>(a1)[tid - 32];
    for (int x = vlen + tid; x < wlen; x += THREADS) rw[x] = 0;
  }
  for (int x = tid; x < PMAX * BF_WORDS / 4; x += THREADS)
    cp_async16(sm + SM_BF + 16 * x, C + BF_OFF + 4 * x);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // ---- the stream symbols: a thread a group of three words, 27 bytes
  // (read as 8 words and aligned by funnel shifts) -> 26 symbols, their
  // digits packed, stored in pairs ----
  for (int mm = tid; mm < m1 - m0; mm += THREADS) {
    const int off = (int)(src & 15) + 27 * mm;       // rw + 27 mm in stage
    const uint32_t* g = reinterpret_cast<const uint32_t*>(stage + (off & ~3));
    const int sh = 8 * (off & 3);
    uint32_t a[8], w[27];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = g[i];
#pragma unroll
    for (int i = 0; i < 7; ++i) a[i] = __funnelshift_r(a[i], a[i + 1], sh);
#pragma unroll
    for (int x = 0; x < 27; ++x) w[x] = dw[(a[x >> 2] >> (8 * (x & 3))) & 0xff];
    uint16_t* o = reinterpret_cast<uint16_t*>(sym + 26 * mm);
#pragma unroll
    for (int r = 0; r < N; r += 2) {
      const uint32_t p0 = __dp4a(__byte_perm(w[trit_byte(r, 0)],
                                             w[trit_byte(r, 0) + 1],
                                             trit_sel(r)), 0x00100401u, 0u);
      const uint32_t p1 = __dp4a(__byte_perm(w[trit_byte(r + 1, 0)],
                                             w[trit_byte(r + 1, 0) + 1],
                                             trit_sel(r + 1)), 0x00100401u, 0u);
      o[r / 2] = (uint16_t)(p0 | p1 << 8);
    }
  }
  __syncthreads();

  // ---- cells no codeword writes: header, rows past the codewords, the
  // beacon band's beacon cells ----
  for (int i = 0; i < BANDS; ++i) {
    const int* R = U + UNIT_BAND + SLOT_WORDS * i;
    const int b = R[0], col0 = R[3], col1 = R[4], fill_from = R[5];
    if (col1 <= col0) continue;
    uint8_t* st = stg(R) - col0;                     // st[col]
    // a zero cell scrambled: o in each digit
    const uint8_t s0 = (uint8_t)(13 * Off[2 * b]);
    const uint8_t s1 = (uint8_t)(13 * Off[2 * b + 1]);
    if (col0 == 0 && tid < HDR) st[tid] = (uint8_t)C[HDR_OFF + HDR * b + tid];
    for (int h = max(fill_from, col0 - HDR) + tid; h < col1 - HDR;
         h += THREADS)
      st[HDR + h] = (b == bc_band && h % bc_p == 0) ? (uint8_t)bc_sym
                                                    : ((h & 1) ? s1 : s0);
    if (Bt[BAND_WORDS * b + 1] == BEACON) {
      const int r0 = max(col0 - HDR, 0), r1 = min(col1 - HDR, fill_from);
      for (int t = (r0 + bc_p - 1) / bc_p + tid; t * bc_p < r1; t += THREADS)
        st[HDR + t * bc_p] = (uint8_t)bc_sym;
    }
  }

  // ---- codewords: a warp takes 16 codewords of one band a task ----
  const int warp = tid >> 5, lane = tid & 31;
  const int ntask = U[2];
  uint32_t bf[3][3][2];
  int have = -1, i = 0;
  Task t;
  t.sym = sym;
  t.scr = scr;
  t.perm = a.perm;
  t.m0 = m0;
  t.L = C[C_L];
  t.bc_p = bc_p;
  t.q = lane & 3;
  for (int task = warp; task < ntask; task += WARPS) {
    while (i + 1 < BANDS && U[UNIT_BAND + SLOT_WORDS * (i + 1) + 6] <= task)
      ++i;
    const int* R = U + UNIT_BAND + SLOT_WORDS * i;
    const int b = R[0];
    const int* Bd = Bt + BAND_WORDS * b;
    const int pset = Bd[3];
    if (pset != have) {
      const int* bw = reinterpret_cast<const int*>(sm + SM_BF)
                         + pset * BF_WORDS + lane * 18;
#pragma unroll
      for (int kt = 0; kt < 3; ++kt)
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
#pragma unroll
          for (int reg = 0; reg < 2; ++reg)
            bf[kt][nt][reg] = (uint32_t)bw[(kt * 3 + nt) * 2 + reg];
      have = pset;
    }
    t.cw0 = R[1] + (task - R[6]) * TILE + (lane >> 2);
    t.cw1 = R[2];
    t.k = Bd[0];
    t.b = b;
    t.o0 = Off[2 * b];
    t.o1 = Off[2 * b + 1];
    t.stage = stg(R) - R[3] + HDR;
    if (Bd[1] == BEACON) codewords<P5, true>(t, bf);
    else codewords<P5, false>(t, bf);
  }
  __syncthreads();

  // ---- out: each band's columns [col0, col1), 16-byte stores ----
  for (int i = 0; i < BANDS; ++i) {
    const int* R = U + UNIT_BAND + SLOT_WORDS * i;
    const int len = R[4] - R[3];
    if (len <= 0) continue;
    int8_t* dst = out_sf + R[0] * row_len + R[3];
    const uint8_t* st = stg(R);
    const int head = min(len, (int)((16 - ((uintptr_t)dst & 15)) & 15));
    const int nvec = (len - head) >> 4;
    const int tail = len - head - 16 * nvec;
    for (int x = tid; x < nvec; x += THREADS)
      *reinterpret_cast<uint4*>(dst + head + 16 * x) =
          *reinterpret_cast<const uint4*>(st + head + 16 * x);
    if (tid < head) dst[tid] = (int8_t)st[tid];
    else if (tid >= 32 && tid < 32 + tail)
      dst[head + 16 * nvec + tid - 32] = (int8_t)st[head + 16 * nvec + tid - 32];
  }
}

template <bool P5>
int launch(const Args& a, long long n, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      superframe_encode_kernel<P5>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  superframe_encode_kernel<P5>
      <<<(unsigned)(n * a.n_units), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// raw (n, n_raw, 9) int8 contiguous; out (n, 9, 6 + H) int8 contiguous;
// consts the wrapper's int32 table (ops/enc_cuda.py) on the device, with
// n_units units a superframe and smem bytes of dynamic shared memory a
// block; perm P5's int32 interleave table, or null for a layout without P5.
extern "C" int t3_superframe_encode(const void* raw, long long n, int n_raw,
                                    int n_units, int smem, const void* perm,
                                    const void* consts, void* out,
                                    void* stream) {
  if (n <= 0) return 0;
  if (n_units <= 0 || n > 0x7fffffffLL / n_units)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.raw = (const int8_t*)raw;
  a.n_raw = n_raw;
  a.perm = (const int*)perm;
  a.consts = (const int*)consts;
  a.out = (int8_t*)out;
  a.n_units = n_units;
  return perm ? launch<true>(a, n, smem, (cudaStream_t)stream)
              : launch<false>(a, n, smem, (cudaStream_t)stream);
}
