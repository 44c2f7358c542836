// GF(27) arithmetic shared by the port's CUDA kernels.
//
// Symbols 0..26 are digit triples a0 + 3 a1 + 9 a2 over GF(3), reduced mod
// p(x) = x^3 + 2x + 1; the primitive element is alpha = x (symbol 3).
// The product, sum, negation, inverse and alpha-power tables (1.5 KB) are
// read from shared memory, so the hot loops are single table reads; K2
// copies them in from the image in rs_tables.cuh (ops/rs_tables.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace t3 {

constexpr int N = 26;          // RS codeword length

struct __align__(16) GfTables {
  uint8_t mul[27 * 27];
  uint8_t add[27 * 27];
  uint8_t neg[27];
  uint8_t inv[27];
  uint8_t exp[26];             // alpha^e, e = 0..25
  uint8_t pad[14];             // to 1,552 bytes, 97 16-byte words
};
static_assert(sizeof(GfTables) == 1552, "GfTables is the 1,552-byte image");

__device__ __forceinline__ int gmul(const GfTables& t, int a, int b) {
  return t.mul[a * 27 + b];
}
__device__ __forceinline__ int gadd(const GfTables& t, int a, int b) {
  return t.add[a * 27 + b];
}
__device__ __forceinline__ int gsub(const GfTables& t, int a, int b) {
  return t.add[a * 27 + t.neg[b]];
}
// alpha^e for any integer e
__device__ __forceinline__ int gpow(const GfTables& t, int e) {
  return t.exp[((e % 26) + 26) % 26];
}

}  // namespace t3

extern "C" const char* t3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
