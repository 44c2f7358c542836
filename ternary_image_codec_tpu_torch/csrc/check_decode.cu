// K1: superframe check decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ternary_image_codec_tpu/ops/dec_pallas.py
// `check_decode_fn` (body `kernel`, launched by `fn`).  Its contract is the
// reference's XLA check path (`pipeline_v3.check_decode_fn_v3`,
// rs_mode="check"): in wire-plane bodies (n_sf, 9, H) int8 symbols, out the
// RAW planes (n_sf, 9, n_out) int8 and one ok flag per superframe, true iff
// every RS(26, k_b) codeword of every band has zero syndromes (band b checks
// its r_b = 26 - k_b rows).  Scope (`supported()` in ops/dec_cuda.py): no
// beacon, no P5, the same nblk in every band, H == 26 * nblk, every k even
// (and 16 <= k <= 24, which every profile's k is).
//
// The same source covers the layouts of the grid route (`covers()`): a
// sparse beacon and/or P5's 2D interleave, every band but the beacon's
// with H == 26 * nblk.  Its contract there is `pipeline.grid_check`.  Two
// template flags specialise the kernel; with both off it is the P2 kernel.
// * kBeacon: the beacon band's codewords run down its payload rows:
//   coefficient h (codeword h / 26) sits on body row h + h / (p - 1) + 1,
//   rows r % p == 0 holding the beacon symbol.  Once the band's part has
//   landed, its 26 * nblk_b codeword cells are compacted into a strip (the
//   beacon cells and the payload rows past the last whole codeword are
//   never read), each byte re-scrambled from its true row's column parity
//   to the strip position's, so the check pass reads the strip as a band
//   of nblk_b blocks with the descramble table as it is.
// * kP5: the data symbol at band-stream index s goes to stream position
//   perm(s) (ops/interleave.py), s < L_out only.  The snake order is an
//   involution tile by tile: in a w x h tile at t, t + r*w + c maps to
//   t + r*w + (r odd ? w-1-c : c); in the last, partial tile of
//   q*w + rem symbols row q reverses over its rem symbols.  The divisions
//   by the tile area, the width and p - 1 are multiplications by
//   ceil(2^31 / d) (exact while n * d < 2^31, which the gate checks).
// The word-major gather reads the stream buffer as it does for P2.
//
// Output symbol (b, w) holds trits 3b..3b+2 of RAW word w; stream trit
// T = 26w + t (t < 26) is digit T % 3 of stream symbol i = T / 3.  Data
// symbol c < k of band b's codeword blk (body column blk * 26 + c) is
// stream symbol 9 * (blk * k + c) + b.  Trit 26 of every word is 0.
//
// What bounds it.  An 8K frame (2,025 superframes of 8,192 words) moves
// 336.7 MB: 187.2 MB of wire body in, 149.5 MB of RAW planes out, which
// is 0.1005 ms at the H100's 3.35 TB/s.  Its arithmetic is small but
// irregular: per superframe 3,555 codewords x 78 digits through a
// (24 x 78) GF(3) syndrome map, and 71,100 symbols moved from 9 rows into
// stream order and then into 9 output planes.  Once the copies run under
// the compute, the issue rate of that byte-wise work (shared-memory loads
// and stores, lookups, address arithmetic), not device memory, sets the
// pace; the design moves every device-memory byte once, in large copies,
// and spends few instructions per byte:
//
// * Staging.  Persistent blocks, one per SM, loop over superframes.  One
//   thread copies each superframe's body into shared memory with
//   `cp.async.bulk` completing on an mbarrier, in two parts (rows 0..3
//   and rows 4..8), each into its own region.  The check pass works band
//   by band: once it is past row 3, the next superframe's rows 0..3
//   stream in (under the rest of the check and the gather), and its rows
//   4..8 stream in under the check of rows 0..3, so device memory is read
//   while the block checks and written while it gathers.  The body is a
//   strided view (byte 6 of each (6 + H)-byte row; the superframe stride
//   is only 4-byte aligned), so a copy takes the 16-aligned span that
//   encloses its rows, clamped to the tensor's own 16-aligned byte range;
//   the few bytes outside the clamp are read with plain loads.  Bodies
//   too large for shared memory (superframe_words above about 10,000;
//   the default is 8,192) run the same code on global memory (unstaged:
//   the body read in place, the stream buffer in a scratch tensor).
// * Descramble by lookup.  The host table (column parity x band x 256 byte
//   values) gives each wire byte's descrambled symbol (byte 0) and its
//   digits (bytes 1..3; floor semantics for any int8, invalid bytes
//   included), read from shared memory.
// * Check on tensor cores.  A lookup word is already an int8 fragment of
//   four k-values, and the syndrome map's column for the symbol byte is
//   zero.  Sixteen codewords of one band are the A operand of
//   `mma.sync.m16n8k32.s8`; the r = 8 map, its columns the syndrome digits
//   in j-major order, is the B operand held in registers for the whole
//   launch, and a band with r syndromes multiplies only ceil(3r / 8) of
//   its three n-tiles.  Then a divisibility test by 3 (multiply by 3^-1
//   mod 2^32, keep the maximum) on the columns below 3r, and one warp vote
//   per superframe.
// * Extract while checking.  The check pass has every data symbol in a
//   register already; it stores each into a shared stream-ordered buffer
//   (one byte store at 9 * (blk * k + c) + b), so no division by k is
//   ever needed.
// * Gather word-major from the stream buffer.  One thread per output word
//   reads the 9 or 10 consecutive symbols the word spans and shifts their
//   trits into place; consecutive threads write consecutive bytes of each
//   output plane row.
#include "gf27.cuh"

namespace {

constexpr int BANDS = 9;
constexpr int N = t3::N;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SPLIT = 4;               // body rows [0, 4) and [4, 9)
// constants uploaded by the wrapper, as uint32 words:
//   [0, LUT_WORDS)            lut[(parity * 9 + band) * 256 + byte]
//   [BFRAG_OFF, +768)         B fragments, [lane][nt][kt][reg]
//   [BAND_OFF, +9)            k of each band (16 <= k <= 24)
//   [FIX_OFF, +128)           kBeacon: fix[parity][byte] as bytes, the
//                             beacon band's byte at a row of the other
//                             parity re-scrambled to this parity
constexpr int LUT_WORDS = 2 * BANDS * 256;
constexpr int BFRAG_OFF = LUT_WORDS;
constexpr int BAND_OFF = BFRAG_OFF + 32 * 24;
constexpr int FIX_OFF = BAND_OFF + BANDS;
constexpr int FIX_BYTES = 2 * 256;
// dynamic shared memory: the lookup table, the per-band k, the two
// mbarriers and the dirty flag, then the stream buffer and the two body
// regions (each 128-aligned); kBeacon adds the fix table and (staged) the
// beacon band's strip after them
constexpr int SM_BAND = LUT_WORDS * 4;
constexpr int SM_BAR = SM_BAND + 64;
constexpr int SM_FLAG = SM_BAR + 16;
constexpr int SM_STREAM = SM_BAND + 128;
constexpr unsigned CHUNK = 32768;      // bytes per bulk copy instruction

// The grid route's layout, as the wrapper passes it (11 uint32 words, in
// this order; ops/dec_cuda.py `grid_args`).  A magic m of divisor d is
// ceil(2^31 / d): n / d = umulhi(2n, m).
struct Grid {
  int beacon_band;                     // -1: no beacon
  int beacon_blocks;                   // its whole codewords
  unsigned beacon_magic;               // of p - 1
  int stream_len;                      // L_out; 0: no P5
  int tile_area;
  unsigned area_magic;
  int tile_w;
  unsigned w_magic;
  int last_tile, last_rows, last_rem;  // the partial tile: start, rows, rest
};

struct Args {
  const int8_t* body;
  long long sf_stride, n_sf;
  int row_stride, H;
  uintptr_t lo_bound, hi_bound;        // the tensor's 16-aligned byte range
  int nblk, n_out, stream_bytes, part_bytes[2];
  const uint32_t* consts;
  int8_t* out;
  bool* ok;
  uint8_t* scratch;                    // unstaged: a stream buffer per block
  Grid grid;                           // kBeacon, kP5
  int strip_bytes;                     // kBeacon: the beacon band's strip
};

__device__ __forceinline__ int magic_div(int n, unsigned m) {
  return (int)__umulhi((unsigned)n << 1, m);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A 32-bit load from the lookup table at a shared-space byte address.  The
// table is written once, before the block's first barrier, so the load is
// a pure function of its address (a non-volatile asm the compiler may
// schedule freely).
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Where part h (rows [0, 4) or [4, 9)) of superframe s lies: the 16-aligned
// span [lo, ...) that encloses it, and the part [clo, chi) that one bulk
// copy may read (inside the tensor).
struct Span {
  uintptr_t start, end, lo, clo, chi;
};

__device__ __forceinline__ Span span_of(const Args& a, long long s, int h) {
  Span p;
  const int rows = h ? BANDS - SPLIT : SPLIT;
  p.start = (uintptr_t)(a.body + s * a.sf_stride + (h ? SPLIT * a.row_stride : 0));
  p.end = p.start + (uintptr_t)((rows - 1) * a.row_stride + a.H);
  p.lo = p.start & ~(uintptr_t)15;
  p.clo = p.lo > a.lo_bound ? p.lo : a.lo_bound;
  const uintptr_t hi = (p.end + 15) & ~(uintptr_t)15;
  p.chi = hi < a.hi_bound ? hi : a.hi_bound;
  return p;
}

// thread 0: start the bulk copy of part h of superframe s into its region
__device__ void issue_copy(const Args& a, long long s, int h, uint8_t* region,
                           uint64_t* bar) {
  const Span p = span_of(a, s, h);
  const unsigned bytes = (unsigned)(p.chi - p.clo);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  for (unsigned off = 0; off < bytes; off += CHUNK) {
    const unsigned n = bytes - off < CHUNK ? bytes - off : CHUNK;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(region + (p.clo - p.lo) + off)),
        "l"((const void*)(p.clo + off)), "r"(n), "r"(smem_u32(bar))
        : "memory");
  }
}

// all threads: wait for part h, read the bytes the clamped copy left out
// with plain loads, and return where row 0 of the part starts in the region
__device__ __forceinline__ const uint8_t* land(const Args& a, long long s, int h,
                                               uint8_t* region, uint64_t* bar,
                                               uint32_t parity) {
  mbar_wait(bar, parity);
  const Span p = span_of(a, s, h);
  const int tid = threadIdx.x;
  const int head = p.clo > p.start ? (int)(p.clo - p.start) : 0;
  const int tail = p.end > p.chi ? (int)(p.end - p.chi) : 0;
  if (tid < head) region[(p.start - p.lo) + tid] = *(const uint8_t*)(p.start + tid);
  if (tid >= 32 && tid - 32 < tail)
    region[(p.chi - p.lo) + (tid - 32)] = *(const uint8_t*)(p.chi + (tid - 32));
  return region + (p.start - p.lo);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The first NT n-tiles of C = A B, their chains interleaved; then the
// largest 3^-1 * C (mod 2^32) over this thread's columns 8nt + 2q, + 1
// below r3: above 0x55555555 iff one is no multiple of 3.
template <int NT>
__device__ __forceinline__ uint32_t tiles_worst(const uint32_t (&a)[4][4],
                                                const uint32_t (&B)[3][4][2],
                                                int q, int r3) {
  int c[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0;
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_s8(c[nt], a[kt], B[nt][kt][0], B[nt][kt][1]);
  }
  uint32_t worst = 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (8 * nt + 2 * q + e < r3) {
        worst = max(worst, (uint32_t)c[nt][e] * 0xAAAAAAABu);
        worst = max(worst, (uint32_t)c[nt][2 + e] * 0xAAAAAAABu);
      }
    }
  }
  return worst;
}

// kP5: the stream position of band-stream index s < L_out, perm(s).
__device__ __forceinline__ int snake(const Grid& v, int s) {
  const int t = magic_div(s, v.area_magic) * v.tile_area;
  const int u = s - t;
  const int r = magic_div(u, v.w_magic);
  const int c = u - r * v.tile_w;
  const int w = t == v.last_tile && r == v.last_rows ? v.last_rem : v.tile_w;
  return r & 1 ? s + w - 1 - 2 * c : s;
}

// kBeacon: the beacon band's codeword cells, read down its payload rows
// from `row`, into the strip; a byte whose row parity differs from its
// strip position's is re-scrambled by the fix table.
__device__ __forceinline__ void beacon_strip(const uint8_t* row, uint8_t* strip,
                                             const Grid& v, const uint8_t* fix) {
  const int cells = v.beacon_blocks * N;
  for (int h = threadIdx.x; h < cells; h += THREADS) {
    const int r = h + magic_div(h, v.beacon_magic) + 1;
    const uint8_t x = row[r];
    strip[h] = (r ^ h) & 1 ? fix[(h & 1) << 8 | x] : x;
  }
}

// Check pass over bands [bd0, bd1), whose rows start at `rows` (band bd at
// rows + (bd - bd0) * row_stride; kBeacon: the beacon band's at `strip`,
// with its own block count).  A step is 16 codewords of one band,
// blocks 16*p .. 16*p + 15, the M rows of the product: thread (g = lane / 4,
// q = lane % 4) loads A for blocks 16*p + 2g (row g) and 16*p + 2g + 1
// (row g + 8), symbols 8kt + q (reg 0 / 1) and 8kt + 4 + q (reg 2 / 3), and
// stores its data symbols (c < k) into the stream buffer.  A block past
// the band's last is read as the last block again: it checks and stores
// what that block's own thread does, so nothing needs masking.  Steps run
// band-major, warp w taking w, w + WARPS, ...; all loads of a step come
// before its stores (the stream buffer and the stage are both shared
// memory, and a store between two loads would order them).
template <bool kBeacon, bool kP5>
__device__ __forceinline__ uint32_t check_pass(const uint8_t* rows, int bd0,
                                               int bd1, int row_stride,
                                               int nblk, const uint32_t* lut,
                                               const int* band_k,
                                               const uint32_t (&B)[3][4][2],
                                               uint8_t* stream, const Grid& v,
                                               const uint8_t* strip) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int npair = (nblk + 15) / 16;
  const int bpair = kBeacon ? (v.beacon_blocks + 15) / 16 : 0;
  // every symbol index this thread loads has the parity of q; slot (3, 0)
  // reads symbol 24 + q, or 25 for q >= 2 (a zero column then)
  const uint32_t lutq = smem_u32(lut + (q & 1) * BANDS * 256);
  const int i24 = 24 + q < N ? 24 + q : N - 1;
  uint32_t worst = 0;
  for (int bd = bd0, p = threadIdx.x >> 5;; p += WARPS) {
    if constexpr (kBeacon) {                             // warp-uniform
      for (int n; bd < bd1 && p >= (n = bd == v.beacon_band ? bpair : npair);)
        p -= n, ++bd;
    } else {
      while (p >= npair && bd < bd1) p -= npair, ++bd;   // warp-uniform
    }
    if (bd >= bd1) break;
    const bool bc = kBeacon && bd == v.beacon_band;
    const int nb = bc ? v.beacon_blocks : nblk;
    const int k = band_k[bd], r3 = 3 * (N - k);
    const uint32_t lb = lutq + bd * 1024;               // shared address
    // rows g and g + 8 take blocks 16p + 2g and 16p + 2g + 1: 52 bytes
    // apart across g, so a byte load of eight rows meets eight banks
    const int blk[2] = {min(16 * p + 2 * g, nb - 1), min(16 * p + 2 * g + 1, nb - 1)};
    uint32_t a[4][4];
#pragma unroll
    for (int cw = 0; cw < 2; ++cw) {
      const uint8_t* row = (bc ? strip : rows + (bd - bd0) * row_stride) + blk[cw] * N;
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        const int i0 = kt < 3 ? 8 * kt + q : i24;
        a[kt][cw] = lds32(lb + (row[i0] << 2));
        a[kt][2 + cw] = kt < 3 ? lds32(lb + (row[8 * kt + 4 + q] << 2)) : 0u;
      }
    }
    worst = max(worst, r3 > 16 ? tiles_worst<3>(a, B, q, r3)
                     : r3 > 8  ? tiles_worst<2>(a, B, q, r3)
                               : tiles_worst<1>(a, B, q, r3));
#pragma unroll
    for (int cw = 0; cw < 2; ++cw) {
      if constexpr (kP5) {
        const int s0 = 9 * (blk[cw] * k + q) + bd;
        auto put = [&](int s, uint32_t x) {
          if (s < v.stream_len) stream[snake(v, s)] = (uint8_t)x;
        };
#pragma unroll
        for (int kt = 0; kt < 3; ++kt) {                 // c < k, 16 <= k <= 24
          if (kt < 2 || 16 + q < k) put(s0 + 9 * 8 * kt, a[kt][cw]);
          if (kt < 2 || 20 + q < k) put(s0 + 9 * (8 * kt + 4), a[kt][2 + cw]);
        }
      } else {
        uint8_t* out = stream + 9 * (blk[cw] * k + q) + bd;
#pragma unroll
        for (int kt = 0; kt < 3; ++kt) {                 // c < k, 16 <= k <= 24
          if (kt < 2 || 16 + q < k) out[9 * 8 * kt] = (uint8_t)a[kt][cw];
          if (kt < 2 || 20 + q < k) out[9 * (8 * kt + 4)] = (uint8_t)a[kt][2 + cw];
        }
      }
    }
  }
  return worst;
}

// The 9 or 10 stream symbols output word w spans, and the digit its first
// trit starts at.
__device__ __forceinline__ int word_symbols(const uint8_t* stream, int w,
                                            int (&s)[10]) {
  const int T0 = 26 * w;
  const int i0 = T0 / 3, off = T0 - 3 * i0;
#pragma unroll
  for (int j = 0; j < 9; ++j) s[j] = stream[i0 + j];
  s[9] = off == 2 ? stream[i0 + 9] : 0;              // the 10th only if read
  return off;
}

// Output byte b of a word = trits off + 3b .. off + 3b + 2 of its symbol
// run: d_b + u * (s_(b+1) mod p) = d_b + u * s_(b+1) - 27 * d_(b+1), with
// p = 3^off, u = 27 / p and d = s / p = (s * m) >> 8 for s < 27; trit 26
// of the word is 0.
__device__ __forceinline__ void word_emit(int8_t* o, int n_out, int w,
                                          const int (&s)[10], int off) {
  const int m = off == 0 ? 256 : (off == 1 ? 86 : 29);
  const int u = off == 0 ? 27 : (off == 1 ? 9 : 3);
  int d[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) d[j] = (s[j] * m) >> 8;
  int8_t* ob = o + w;
#pragma unroll
  for (int b = 0; b < BANDS; ++b, ob += n_out) {
    int v = d[b] + u * s[b + 1] - 27 * d[b + 1];
    if (b == BANDS - 1) v %= 9;
    *ob = (int8_t)v;
  }
}

// Gather pass: one thread per output word, two words at a time.
__device__ __forceinline__ void gather_pass(const uint8_t* stream, int n_out,
                                            int8_t* o) {
  for (int w = threadIdx.x; w < n_out; w += 2 * THREADS) {
    const int w1 = w + THREADS;
    int s0[10], s1[10];
    const int off0 = word_symbols(stream, w, s0);
    const int off1 = word_symbols(stream, w1 < n_out ? w1 : w, s1);
    word_emit(o, n_out, w, s0, off0);
    if (w1 < n_out) word_emit(o, n_out, w1, s1, off1);
  }
}

// kStaged: the body and the stream buffer in shared memory; else both in
// global memory (the body read in place, the stream and the beacon strip
// in a scratch tensor).  kBeacon, kP5: the grid route's layouts (the note
// at the head of the file).
template <bool kStaged, bool kBeacon, bool kP5>
__global__ void __launch_bounds__(THREADS, 1) check_decode_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem);
  int* band_k = reinterpret_cast<int*>(smem + SM_BAND);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + SM_BAR);
  int* s_bad = reinterpret_cast<int*>(smem + SM_FLAG);
  uint8_t* stream =
      kStaged ? smem + SM_STREAM
              : a.scratch + (size_t)blockIdx.x *
                                (kBeacon ? a.stream_bytes + a.strip_bytes : a.stream_bytes);
  uint8_t* region[2] = {smem + SM_STREAM + a.stream_bytes,
                        smem + SM_STREAM + a.stream_bytes + a.part_bytes[0]};
  uint8_t* fix = smem + (kStaged ? SM_STREAM + a.stream_bytes + a.part_bytes[0] +
                                       a.part_bytes[1]
                                 : SM_STREAM);
  uint8_t* strip = kStaged ? fix + FIX_BYTES : stream + a.stream_bytes;
  const int tid = threadIdx.x, lane = tid & 31;

  const long long G = gridDim.x, first = blockIdx.x;
  const int count = (int)((a.n_sf - first + G - 1) / G);
  if (tid == 0) {
    *s_bad = 0;
    if (kStaged) {
      for (int h = 0; h < 2; ++h)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bar[h])));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int h = 0; h < 2; ++h) issue_copy(a, first, h, region[h], &bar[h]);
    }
  }
  for (int e = tid; e < LUT_WORDS; e += THREADS) lut[e] = a.consts[e];
  if (tid < BANDS) band_k[tid] = (int)a.consts[BAND_OFF + tid];
  if constexpr (kBeacon) {
    for (int e = tid; e < FIX_BYTES / 4; e += THREADS)
      reinterpret_cast<uint32_t*>(fix)[e] = a.consts[FIX_OFF + e];
  }
  uint32_t B[3][4][2];
  {
    const uint2* bf = reinterpret_cast<const uint2*>(a.consts + BFRAG_OFF) + lane * 12;
#pragma unroll
    for (int nt = 0; nt < 3; ++nt) {
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        const uint2 v = bf[nt * 4 + kt];
        B[nt][kt][0] = v.x;
        B[nt][kt][1] = v.y;
      }
    }
  }
  __syncthreads();

  for (int t = 0; t < count; ++t) {
    const long long s = first + t * G;
    uint32_t worst = 0;
    // rows 4..8 stream in under the check of rows 0..3, away from the
    // gather's output stores (region 1 is free since the last check)
    if (kStaged && t > 0 && tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue_copy(a, s, 1, region[1], &bar[1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint8_t* rows =
          kStaged ? land(a, s, h, region[h], &bar[h], (uint32_t)(t & 1))
                  : reinterpret_cast<const uint8_t*>(a.body + s * a.sf_stride) +
                        h * SPLIT * a.row_stride;
      __syncthreads();   // part landed; the last gather done with the stream
      const int bd0 = h ? SPLIT : 0, bd1 = h ? BANDS : SPLIT;
      if constexpr (kBeacon) {
        const int bb = a.grid.beacon_band;
        if (bb >= bd0 && bb < bd1) {                     // block-uniform
          beacon_strip(rows + (bb - bd0) * a.row_stride, strip, a.grid, fix);
          __syncthreads();
        }
      }
      worst = max(worst, check_pass<kBeacon, kP5>(rows, bd0, bd1, a.row_stride,
                                                  a.nblk, lut, band_k, B, stream,
                                                  a.grid, strip));
      if (h == 1 && __any_sync(0xffffffffu, worst > 0x55555555u) && lane == 0)
        *s_bad = 1;
      __syncthreads();   // the part's rows are read: its region is free
      if (tid == 0) {
        if (kStaged && h == 0 && t + 1 < count) {
          // rows 0..3 of the next superframe stream in under the check of
          // rows 4..8 and the gather; the region was read (and patched)
          // through the generic proxy
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          issue_copy(a, s + G, 0, region[0], &bar[0]);
        }
        if (h == 1) {
          a.ok[s] = *s_bad == 0;
          *s_bad = 0;
        }
      }
    }
    gather_pass(stream, a.n_out, a.out + s * (long long)BANDS * a.n_out);
  }
}

struct Plan {
  int staged, max_grid, smem, blocks_per_sm, stream_bytes, strip_bytes;
  int part_bytes[2];
};

// The kernel of one specialisation: index 4 * staged + 2 * beacon + p5.
using Kernel = void (*)(const Args);
const Kernel KERNELS[8] = {
    check_decode_kernel<false, false, false>, check_decode_kernel<false, false, true>,
    check_decode_kernel<false, true, false>,  check_decode_kernel<false, true, true>,
    check_decode_kernel<true, false, false>,  check_decode_kernel<true, false, true>,
    check_decode_kernel<true, true, false>,   check_decode_kernel<true, true, true>};

// Per device, queried once: SM count, shared-memory limit, and for each
// kernel the dynamic shared size last set and the blocks per SM it allows.
struct DeviceInfo {
  int nsm = 0, optin = 0, smem[8] = {-1, -1, -1, -1, -1, -1, -1, -1},
      blocks_per_sm[8] = {};
};
constexpr int MAX_DEVICES = 64;
DeviceInfo g_devices[MAX_DEVICES];

// The grid route's layout from the wrapper's words (null: the P2 route).
Grid grid_of(const unsigned* w) {
  Grid v = {-1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (w) {
    v.beacon_band = (int)w[0];
    v.beacon_blocks = (int)w[1];
    v.beacon_magic = w[2];
    v.stream_len = (int)w[3];
    v.tile_area = (int)w[4];
    v.area_magic = w[5];
    v.tile_w = (int)w[6];
    v.w_magic = w[7];
    v.last_tile = (int)w[8];
    v.last_rows = (int)w[9];
    v.last_rem = (int)w[10];
  }
  return v;
}

// The body, the stream buffer (and a beacon strip) are staged in shared
// memory when they fit there, else they stay in global memory.
int make_plan(long long row_stride, int nblk, int kmax, const Grid& v,
              Plan* plan, int* kernel) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  DeviceInfo& d = g_devices[dev];
  if (d.nsm == 0) {
    e = cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&d.nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)(d.nsm = 0, e);
  }
  const bool beacon = v.beacon_band >= 0, p5 = v.stream_len > 0;
  const long long H = (long long)N * nblk;
  const long long span = 8 * row_stride + H;
  const long long stream = ((long long)BANDS * nblk * kmax + 127) / 128 * 128;
  const long long strip = beacon ? ((long long)N * v.beacon_blocks + 127) / 128 * 128 : 0;
  if (span >= (1LL << 30) || stream >= (1LL << 30) || strip >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  long long parts = 0;
  for (int h = 0; h < 2; ++h) {
    const long long rows = h ? BANDS - SPLIT : SPLIT;
    plan->part_bytes[h] = (int)(((rows - 1) * row_stride + H + 32 + 127) / 128 * 128);
    parts += plan->part_bytes[h];
  }
  const long long fix = beacon ? FIX_BYTES : 0;
  const int staged = SM_STREAM + stream + parts + fix + strip <= d.optin;
  plan->staged = staged;
  plan->stream_bytes = (int)stream;
  plan->strip_bytes = (int)strip;
  plan->smem = staged ? (int)(SM_STREAM + stream + parts + fix + strip)
                      : (int)(SM_STREAM + fix);
  const int kv = 4 * staged + 2 * beacon + p5;
  if (d.smem[kv] != plan->smem) {
    e = cudaFuncSetAttribute(KERNELS[kv], cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan->smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.blocks_per_sm[kv],
                                                        KERNELS[kv], THREADS, plan->smem);
    if (e != cudaSuccess) return (int)(d.smem[kv] = -1, e);
    d.smem[kv] = plan->smem;
  }
  plan->blocks_per_sm = d.blocks_per_sm[kv];
  if (plan->blocks_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  plan->max_grid = d.nsm * plan->blocks_per_sm;
  *kernel = kv;
  return 0;
}

}  // namespace

// The launch plan for bodies of this geometry on the current device:
// plan[0..4] = staged (1: body and stream buffer in shared memory; 0: in
// global memory), the largest grid (SMs x resident blocks per SM; a launch
// of n_sf superframes takes min(n_sf, it)), dynamic shared bytes, resident
// blocks per SM, and the scratch bytes a block of an unstaged launch needs
// (its stream buffer and beacon strip).  grid: the grid route's 11 words
// (struct Grid), or null for the P2 route.  Returns a CUDA error code.
extern "C" int t3_check_decode_plan(long long row_stride, int nblk, int kmax,
                                    const unsigned* grid, int* plan) {
  Plan p;
  int kv = 0;
  const int err = make_plan(row_stride, nblk, kmax, grid_of(grid), &p, &kv);
  if (err) return err;
  plan[0] = p.staged;
  plan[1] = p.max_grid;
  plan[2] = p.smem;
  plan[3] = p.blocks_per_sm;
  plan[4] = p.stream_bytes + (p.staged ? 0 : p.strip_bytes);
  return 0;
}

// body: n_sf superframes of 9 rows, element (s, b, h) at
// body[s * sf_stride + b * row_stride + h]; nblk the uniform bands' block
// count (H = 26 * nblk); out (n_sf, 9, n_out) int8 contiguous; ok (n_sf,)
// bool; consts the wrapper's uint32 table (layout above) on the device;
// kmax the largest k; grid as for the plan (host memory); scratch
// min(n_sf, max grid) x the plan's scratch bytes a block when it is
// unstaged (else unused).
extern "C" int t3_check_decode(const void* body, long long sf_stride,
                               long long row_stride, long long n_sf, int nblk,
                               int kmax, int n_out, const void* consts,
                               const unsigned* grid, void* out, void* ok,
                               void* scratch, void* stream) {
  if (n_sf <= 0) return 0;
  Plan p;
  int kv = 0;
  const Grid v = grid_of(grid);
  const int err = make_plan(row_stride, nblk, kmax, v, &p, &kv);
  if (err) return err;
  const int launch_grid = (int)(n_sf < p.max_grid ? n_sf : p.max_grid);
  Args a;
  a.body = (const int8_t*)body;
  a.sf_stride = sf_stride;
  a.n_sf = n_sf;
  a.row_stride = (int)row_stride;
  a.H = N * nblk;
  const uintptr_t begin = (uintptr_t)body;
  const uintptr_t end =
      begin + (uintptr_t)((n_sf - 1) * sf_stride + 8 * row_stride + a.H);
  a.lo_bound = (begin + 15) & ~(uintptr_t)15;
  a.hi_bound = end & ~(uintptr_t)15;
  a.nblk = nblk;
  a.n_out = n_out;
  a.stream_bytes = p.stream_bytes;
  a.part_bytes[0] = p.part_bytes[0];
  a.part_bytes[1] = p.part_bytes[1];
  a.consts = (const uint32_t*)consts;
  a.out = (int8_t*)out;
  a.ok = (bool*)ok;
  a.scratch = (uint8_t*)scratch;
  a.grid = v;
  a.strip_bytes = p.strip_bytes;
  KERNELS[kv]<<<launch_grid, THREADS, p.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
