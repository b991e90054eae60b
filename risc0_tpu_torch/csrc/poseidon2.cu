// Poseidon2 (BabyBear, t = 24) row hashing and pair compression for Hopper.
//
// Replaces the Pallas kernels in risc0_tpu/hal/pallas/poseidon2.py:
//   * p2_hash_rows  <- hash_rows (:121, kernel _hash_rows_kernel :97-117,
//                      permutation _permute_planar :44-94)
//   * p2_hash_pairs <- hash_pairs (:149, kernel _hash_pairs_kernel :138-145)
//
// What bounds it: arithmetic, not memory.  One permutation is 4+4 full
// rounds of 24 x^7 S-boxes (4 Montgomery products each) plus 24 diagonal
// products in each of 21 partial rounds: about 1300 32x32->64 products
// for 16 absorbed words (~80 per input word), against 4 bytes read per
// word.  The design keeps the 24-cell state of a row in registers for the
// whole absorb (one thread per row), so device memory sees only the input
// stream and the 32-byte digest; the round constants and the internal
// diagonal sit in __constant__ memory, where every thread of a warp reads
// the same word at the same time (a broadcast).  Reads of matrix[c, r] are
// coalesced across neighbouring rows.
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

constexpr int CELLS = 24;
constexpr int RATE = 16;
constexpr int OUT = 8;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 21;
constexpr int ROUNDS = 2 * HALF_FULL + PARTIAL;

__constant__ uint32_t RC[ROUNDS * CELLS];
__constant__ uint32_t MINT[CELLS];

__device__ __forceinline__ uint32_t dbl(uint32_t x) { return bb::add(x, x); }

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  uint32_t x2 = bb::mul(x, x);
  uint32_t x4 = bb::mul(x2, x2);
  return bb::mul(bb::mul(x4, x2), x);
}

// External layer: 4x4 circulant butterfly on each of the 6 blocks, then
// every cell adds the sum of its column across blocks (mod.rs:137-176).
__device__ __forceinline__ void m_ext(uint32_t* c) {
  uint32_t sums[4] = {0, 0, 0, 0};
#pragma unroll
  for (int blk = 0; blk < CELLS / 4; ++blk) {
    uint32_t c0 = c[4 * blk], c1 = c[4 * blk + 1];
    uint32_t c2 = c[4 * blk + 2], c3 = c[4 * blk + 3];
    uint32_t t0 = bb::add(c0, c1);
    uint32_t t1 = bb::add(c2, c3);
    uint32_t t2 = bb::add(dbl(c1), t1);
    uint32_t t3 = bb::add(dbl(c3), t0);
    uint32_t t4 = bb::add(dbl(dbl(t1)), t3);
    uint32_t t5 = bb::add(dbl(dbl(t0)), t2);
    uint32_t t6 = bb::add(t3, t5);
    uint32_t t7 = bb::add(t2, t4);
    c[4 * blk] = t6;
    c[4 * blk + 1] = t5;
    c[4 * blk + 2] = t7;
    c[4 * blk + 3] = t4;
    sums[0] = bb::add(sums[0], t6);
    sums[1] = bb::add(sums[1], t5);
    sums[2] = bb::add(sums[2], t7);
    sums[3] = bb::add(sums[3], t4);
  }
#pragma unroll
  for (int i = 0; i < CELLS; ++i) c[i] = bb::add(c[i], sums[i % 4]);
}

// Internal layer: all-ones matrix plus diag(MINT).
__device__ __forceinline__ void m_int(uint32_t* c) {
  uint32_t total = c[0];
#pragma unroll
  for (int i = 1; i < CELLS; ++i) total = bb::add(total, c[i]);
#pragma unroll
  for (int i = 0; i < CELLS; ++i) c[i] = bb::add(total, bb::mul(c[i], MINT[i]));
}

__device__ __forceinline__ void full_round(uint32_t* c, int rnd) {
#pragma unroll
  for (int i = 0; i < CELLS; ++i) c[i] = sbox(bb::add(c[i], RC[rnd * CELLS + i]));
  m_ext(c);
}

__device__ void permute(uint32_t* c) {
  m_ext(c);
#pragma unroll 1
  for (int rnd = 0; rnd < HALF_FULL; ++rnd) full_round(c, rnd);
#pragma unroll 1
  for (int rnd = HALF_FULL; rnd < HALF_FULL + PARTIAL; ++rnd) {
    c[0] = sbox(bb::add(c[0], RC[rnd * CELLS]));
    m_int(c);
  }
#pragma unroll 1
  for (int rnd = HALF_FULL + PARTIAL; rnd < ROUNDS; ++rnd) full_round(c, rnd);
}

// One thread per row: absorb `cols` words of column r of a (cols, rows)
// matrix, 16 at a time with *set* semantics, zero-padding the last chunk
// and permuting once even when cols == 0.
__global__ void hash_rows_kernel(const uint32_t* __restrict__ mat,
                                 uint32_t* __restrict__ out, uint32_t cols,
                                 uint64_t rows) {
  uint64_t r = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  uint32_t c[CELLS];
#pragma unroll
  for (int i = 0; i < CELLS; ++i) c[i] = 0;
  const uint32_t full = cols / RATE, rem = cols % RATE;
  for (uint32_t chunk = 0; chunk < full; ++chunk) {
    const uint32_t* src = mat + (uint64_t)chunk * RATE * rows + r;
#pragma unroll
    for (int i = 0; i < RATE; ++i) c[i] = src[(uint64_t)i * rows];
    permute(c);
  }
  if (rem != 0 || cols == 0) {
    const uint32_t* src = mat + (uint64_t)full * RATE * rows + r;
#pragma unroll
    for (int i = 0; i < RATE; ++i)
      c[i] = (uint32_t)i < rem ? src[(uint64_t)i * rows] : 0u;
    permute(c);
  }
#pragma unroll
  for (int i = 0; i < OUT; ++i) out[r * OUT + i] = c[i];
}

// One thread per output digest: state = left(8) | right(8) | 0(8).
__global__ void hash_pairs_kernel(const uint32_t* __restrict__ left,
                                  const uint32_t* __restrict__ right,
                                  uint32_t* __restrict__ out, uint64_t n,
                                  uint64_t lstride, uint64_t rstride) {
  uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t c[CELLS];
#pragma unroll
  for (int j = 0; j < OUT; ++j) {
    c[j] = left[i * lstride + j];
    c[OUT + j] = right[i * rstride + j];
    c[2 * OUT + j] = 0;
  }
  permute(c);
#pragma unroll
  for (int j = 0; j < OUT; ++j) out[i * OUT + j] = c[j];
}

constexpr int THREADS = 128;

}  // namespace

extern "C" int p2_set_constants(const uint32_t* rc, const uint32_t* mint) {
  cudaError_t e = cudaMemcpyToSymbol(RC, rc, sizeof(uint32_t) * ROUNDS * CELLS);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(MINT, mint, sizeof(uint32_t) * CELLS);
}

extern "C" int p2_hash_rows(const uint32_t* mat, uint32_t* out, uint32_t cols,
                            uint64_t rows, void* stream) {
  if (rows == 0) return 0;
  uint64_t blocks = (rows + THREADS - 1) / THREADS;
  hash_rows_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      mat, out, cols, rows);
  return (int)cudaGetLastError();
}

extern "C" int p2_hash_pairs(const uint32_t* left, const uint32_t* right,
                             uint32_t* out, uint64_t n, uint64_t lstride,
                             uint64_t rstride, void* stream) {
  if (n == 0) return 0;
  uint64_t blocks = (n + THREADS - 1) / THREADS;
  hash_pairs_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      left, right, out, n, lstride, rstride);
  return (int)cudaGetLastError();
}
