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
constexpr int LUT_WORDS = 2 * BANDS * 256;
constexpr int BFRAG_OFF = LUT_WORDS;
constexpr int BAND_OFF = BFRAG_OFF + 32 * 24;
// dynamic shared memory: the lookup table, the per-band k, the two
// mbarriers and the dirty flag, then the stream buffer and the two body
// regions (each 128-aligned)
constexpr int SM_BAND = LUT_WORDS * 4;
constexpr int SM_BAR = SM_BAND + 64;
constexpr int SM_FLAG = SM_BAR + 16;
constexpr int SM_STREAM = SM_BAND + 128;
constexpr unsigned CHUNK = 32768;      // bytes per bulk copy instruction

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
};

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

// Check pass over bands [bd0, bd1), whose rows start at `rows` (band bd at
// rows + (bd - bd0) * row_stride).  A step is 16 codewords of one band,
// blocks 16*p .. 16*p + 15, the M rows of the product: thread (g = lane / 4,
// q = lane % 4) loads A for blocks 16*p + 2g (row g) and 16*p + 2g + 1
// (row g + 8), symbols 8kt + q (reg 0 / 1) and 8kt + 4 + q (reg 2 / 3), and
// stores its data symbols (c < k) into the stream buffer.  A block past
// the band's last is read as the last block again: it checks and stores
// what that block's own thread does, so nothing needs masking.  Steps run
// band-major, warp w taking w, w + WARPS, ...; all loads of a step come
// before its stores (the stream buffer and the stage are both shared
// memory, and a store between two loads would order them).
__device__ __forceinline__ uint32_t check_pass(const uint8_t* rows, int bd0,
                                               int bd1, int row_stride,
                                               int nblk, const uint32_t* lut,
                                               const int* band_k,
                                               const uint32_t (&B)[3][4][2],
                                               uint8_t* stream) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int npair = (nblk + 15) / 16;
  // every symbol index this thread loads has the parity of q; slot (3, 0)
  // reads symbol 24 + q, or 25 for q >= 2 (a zero column then)
  const uint32_t lutq = smem_u32(lut + (q & 1) * BANDS * 256);
  const int i24 = 24 + q < N ? 24 + q : N - 1;
  uint32_t worst = 0;
  for (int bd = bd0, p = threadIdx.x >> 5;; p += WARPS) {
    while (p >= npair && bd < bd1) p -= npair, ++bd;     // warp-uniform
    if (bd >= bd1) break;
    const int k = band_k[bd], r3 = 3 * (N - k);
    const uint32_t lb = lutq + bd * 1024;               // shared address
    // rows g and g + 8 take blocks 16p + 2g and 16p + 2g + 1: 52 bytes
    // apart across g, so a byte load of eight rows meets eight banks
    const int blk[2] = {min(16 * p + 2 * g, nblk - 1), min(16 * p + 2 * g + 1, nblk - 1)};
    uint32_t a[4][4];
#pragma unroll
    for (int cw = 0; cw < 2; ++cw) {
      const uint8_t* row = rows + (bd - bd0) * row_stride + blk[cw] * N;
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
      uint8_t* out = stream + 9 * (blk[cw] * k + q) + bd;
#pragma unroll
      for (int kt = 0; kt < 3; ++kt) {                   // c < k, 16 <= k <= 24
        if (kt < 2 || 16 + q < k) out[9 * 8 * kt] = (uint8_t)a[kt][cw];
        if (kt < 2 || 20 + q < k) out[9 * (8 * kt + 4)] = (uint8_t)a[kt][2 + cw];
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
// global memory (the body read in place, the stream in a scratch tensor).
template <bool kStaged>
__global__ void __launch_bounds__(THREADS, 1) check_decode_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem);
  int* band_k = reinterpret_cast<int*>(smem + SM_BAND);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + SM_BAR);
  int* s_bad = reinterpret_cast<int*>(smem + SM_FLAG);
  uint8_t* stream = kStaged ? smem + SM_STREAM
                            : a.scratch + (size_t)blockIdx.x * a.stream_bytes;
  uint8_t* region[2] = {smem + SM_STREAM + a.stream_bytes,
                        smem + SM_STREAM + a.stream_bytes + a.part_bytes[0]};
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
      worst = max(worst, check_pass(rows, h ? SPLIT : 0, h ? BANDS : SPLIT,
                                    a.row_stride, a.nblk, lut, band_k, B, stream));
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
  int staged, max_grid, smem, blocks_per_sm, stream_bytes;
  int part_bytes[2];
};

// Per device, queried once: SM count, shared-memory limit, and for each
// kernel the dynamic shared size last set and the blocks per SM it allows.
struct DeviceInfo {
  int nsm = 0, optin = 0, smem[2] = {-1, -1}, blocks_per_sm[2] = {0, 0};
};
constexpr int MAX_DEVICES = 64;
DeviceInfo g_devices[MAX_DEVICES];

// The body and the stream buffer are staged in shared memory when they
// fit there, else both stay in global memory.
int make_plan(long long row_stride, int nblk, int kmax, Plan* plan) {
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
  const long long H = (long long)N * nblk;
  const long long span = 8 * row_stride + H;
  const long long stream = ((long long)BANDS * nblk * kmax + 127) / 128 * 128;
  if (span >= (1LL << 30) || stream >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  long long parts = 0;
  for (int h = 0; h < 2; ++h) {
    const long long rows = h ? BANDS - SPLIT : SPLIT;
    plan->part_bytes[h] = (int)(((rows - 1) * row_stride + H + 32 + 127) / 128 * 128);
    parts += plan->part_bytes[h];
  }
  const int staged = SM_STREAM + stream + parts <= d.optin;
  plan->staged = staged;
  plan->stream_bytes = (int)stream;
  plan->smem = staged ? (int)(SM_STREAM + stream + parts) : SM_STREAM;
  if (d.smem[staged] != plan->smem) {
    const auto kernel = staged ? check_decode_kernel<true> : check_decode_kernel<false>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan->smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.blocks_per_sm[staged],
                                                        kernel, THREADS, plan->smem);
    if (e != cudaSuccess) return (int)(d.smem[staged] = -1, e);
    d.smem[staged] = plan->smem;
  }
  plan->blocks_per_sm = d.blocks_per_sm[staged];
  if (plan->blocks_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  plan->max_grid = d.nsm * plan->blocks_per_sm;
  return 0;
}

}  // namespace

// The launch plan for bodies of this geometry on the current device:
// plan[0..4] = staged (1: body and stream buffer in shared memory; 0: in
// global memory), the largest grid (SMs x resident blocks per SM; a launch
// of n_sf superframes takes min(n_sf, it)), dynamic shared bytes, resident
// blocks per SM, and the stream buffer's bytes (an unstaged launch needs
// one per block of its grid as scratch).  Returns a CUDA error code.
extern "C" int t3_check_decode_plan(long long row_stride, int nblk, int kmax,
                                    int* plan) {
  Plan p;
  const int err = make_plan(row_stride, nblk, kmax, &p);
  if (err) return err;
  plan[0] = p.staged;
  plan[1] = p.max_grid;
  plan[2] = p.smem;
  plan[3] = p.blocks_per_sm;
  plan[4] = p.stream_bytes;
  return 0;
}

// body: n_sf superframes of 9 rows, element (s, b, h) at
// body[s * sf_stride + b * row_stride + h]; out (n_sf, 9, n_out) int8
// contiguous; ok (n_sf,) bool; consts the wrapper's uint32 table (layout
// above) on the device; kmax the largest k; scratch min(n_sf, max grid) x
// stream bytes of the plan when it is unstaged (else unused).
extern "C" int t3_check_decode(const void* body, long long sf_stride,
                               long long row_stride, long long n_sf, int nblk,
                               int kmax, int n_out, const void* consts,
                               void* out, void* ok, void* scratch,
                               void* stream) {
  if (n_sf <= 0) return 0;
  Plan p;
  const int err = make_plan(row_stride, nblk, kmax, &p);
  if (err) return err;
  const int grid = (int)(n_sf < p.max_grid ? n_sf : p.max_grid);
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
  if (p.staged)
    check_decode_kernel<true><<<grid, THREADS, p.smem, (cudaStream_t)stream>>>(a);
  else
    check_decode_kernel<false><<<grid, THREADS, p.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
