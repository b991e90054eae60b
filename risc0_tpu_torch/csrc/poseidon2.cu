// Poseidon2 (BabyBear, t = 24) row hashing and Merkle folding for Hopper.
//
// Replaces the Pallas kernels in risc0_tpu/hal/pallas/poseidon2.py:
//   * p2_hash_rows   <- hash_rows (:121, kernel _hash_rows_kernel :97-117,
//                       permutation _permute_planar :44-94)
//   * p2_merkle_fold <- hash_pairs (:149, kernel _hash_pairs_kernel :138-145),
//                       one to nine Merkle layers a launch
//
// What bounds it: the FMA pipe's multiplies, not memory.  One permutation
// is 1356 Montgomery products (4 per x^7 S-box, 24 diagonal products per
// partial round) against 4 bytes read per absorbed word.  Each product is
// a 64-bit IMAD.WIDE, an IMAD and an IMAD.HI; on an NVIDIA H100 80GB HBM3
// at 700 W the WIDE and HI forms issue at about half the IMAD rate
// (scripts/torch_p2_bench.py --pipes), so the products alone hold the FMA
// pipe for about 2.7 warp-cycles each.  The first port also reduced every
// field add to [0, P), which cost about 6.7k ALU-pipe instructions a
// permutation against 5.2k on the FMA pipe (SASS of the loops over rounds;
// PERF.md has the counts).
//
// The design here reduces once per linear-layer output instead of once
// per add, and leaves a value unreduced wherever its consumer accepts it,
// which cuts the ALU pipe's share to about 4.8k instructions:
//   * the external layer (4x4 circulant blocks plus column sums) and the
//     internal layer's 24-cell sum accumulate 32-bit words exactly in
//     64-bit sums, with the next round's constants folded in, and reduce
//     each sum once (reduce64: a quotient estimate and one multiply-add,
//     both full-rate IMADs, no compare);
//   * a Montgomery product is left below 2P where the next product or sum
//     accepts it, and uses the signed REDC, which needs no carry;
//   * the 24-cell sum is a tree of three-input adds, so a partial round's
//     dependency chain is short for the latency-bound launches (the final
//     FRI digest and the top of each Merkle tree run a few threads).
// Every lazy bound is stated beside the code that relies on it, and
// tests/test_torch_poseidon2.py checks each of them on an int64 model of
// this schedule under worst-case words.
//
// The state of a row lives in one thread's registers for a whole absorb
// (hash_rows) or hash (merkle_fold); the round constants and the internal
// diagonal sit in __constant__ memory, read by every thread of a warp at
// once (a broadcast).  merkle_fold keeps the digests between the levels of
// one launch in shared memory and writes every level to device memory.
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

using bb::P;

constexpr int CELLS = 24;
constexpr int RATE = 16;
constexpr int OUT = 8;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 21;
constexpr int ROUNDS = 2 * HALF_FULL + PARTIAL;
constexpr int FIRST_LAST_FULL = HALF_FULL + PARTIAL;  // round 25

// RCF[r]: the constants added right after the linear layer that precedes
// round r (r = 0: the initial external layer; r = 29: none), laid out by
// the host (hal/cuda/poseidon2.py folded_round_constants): a full round's
// row holds its 24 constants, a partial round's row only cell 0's.
__constant__ uint32_t RCF[(ROUNDS + 1) * CELLS];
__constant__ uint32_t MINT[CELLS];

// Bounds below are in units of P.

// a * b * 2^-32 mod P for a * b < P * 2^32, below a * b / 2^32 + P (so
// below 2P).  Signed REDC: m = low(t) P^-1 makes low(t) = low(m P), so
// (t - m P) / 2^32 = hi(t) - hi(m P) exactly, with no carry to track, and
// adding P keeps it positive.  Three multiplies on the FMA pipe (one of
// them the 64-bit product) and one three-input add.
__device__ __forceinline__ uint32_t mul_lazy(uint32_t a, uint32_t b) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * bb::M;
  return (uint32_t)(t >> 32) + P - __umulhi(m, P);
}

// x - P where x >= P: for x < 2P the canonical word; for x < (1 + b) P,
// a word below max(P, b P).
__device__ __forceinline__ uint32_t sub_p(uint32_t x) {
  return __viaddmin_u32(x, 0u - P, x);  // min(x - P mod 2^32, x)
}

// v < 2^39 -> a word below 1.009 P congruent to v, with multiplies that
// keep only the low word (the full rate of the FMA pipe).  x = v >> 23 <
// 2^16 and q = floor(x * 34952 / 2^23), with 34952 = floor(2^46 / P), never
// exceed v / P and fall short of it by less than 1 + 1/240 + 273 * 2^-16
// < 1.009, so v - q P lies in [0, 1.009 P) and its low word is
// (uint32)v - q P.
__device__ __forceinline__ uint32_t reduce64(uint64_t v) {
  const uint32_t q = ((uint32_t)(v >> 23) * 34952u) >> 23;
  return (uint32_t)v - q * P;
}

// x < 1.07P -> x^7 (Montgomery form), below 1.85P.  (The state's words
// are below 1.01P here.)
__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  const uint32_t x2 = sub_p(mul_lazy(x, x));  // x^2 < 1.15 P^2: < 1.54P -> < P
  const uint32_t x4 = mul_lazy(x2, x2);       // < P^2 / 2^32 + P = 1.47P
  const uint32_t x6 = mul_lazy(x4, x2);       // < 1.47 * 0.47 + 1 = 1.69P
  return mul_lazy(x6, x);                     // 1.69 * 1.07 P^2 < P 2^32: < 1.85P
}

// The 4x4 circulant M4 of the external layer (mod.rs:137-176) on exact
// sums: out = (5 7 1 3; 4 6 1 1; 1 3 5 7; 1 1 4 6) in.  Row sums 16, 12,
// 16, 12.
__device__ __forceinline__ void m4(uint64_t a, uint64_t b, uint64_t c,
                                   uint64_t d, uint64_t* o) {
  const uint64_t t0 = a + b, t1 = c + d;
  const uint64_t t2 = b + b + t1, t3 = d + d + t0;
  const uint64_t t4 = 4 * t1 + t3, t5 = 4 * t0 + t2;
  o[0] = t3 + t5;
  o[1] = t5;
  o[2] = t2 + t4;
  o[3] = t4;
}

// External layer, then the constants of round `next`: every block b gets
// M4 c_b + M4 (sum over blocks of c_b) = M4 (c_b + column sums), exactly
// in 64 bits, then one reduce64.  In: c < 1.85P.  The sum is below 112 *
// 1.85P + P = 208P < 2^39.  Out: c < 1.009P.
__device__ __forceinline__ void ext_layer(uint32_t* c, int next) {
  uint64_t col[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    col[j] = ((uint64_t)c[j] + c[4 + j] + c[8 + j]) +
             ((uint64_t)c[12 + j] + c[16 + j] + c[20 + j]);
  uint64_t s[4];
  m4(col[0], col[1], col[2], col[3], s);
  const uint32_t* rc = RCF + next * CELLS;
#pragma unroll
  for (int blk = 0; blk < CELLS / 4; ++blk) {
    uint32_t* x = c + 4 * blk;
    uint64_t o[4];
    m4(x[0], x[1], x[2], x[3], o);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = reduce64(o[j] + s[j] + rc[4 * blk + j]);
  }
}

// Full round `rnd`: S-boxes (round constants already folded in), then the
// external layer with the next round's constants.  In and out c < 1.01P.
__device__ __forceinline__ void full_round(uint32_t* c, int rnd) {
#pragma unroll
  for (int i = 0; i < CELLS; ++i) c[i] = sbox(c[i]);  // < 1.85P
  ext_layer(c, rnd + 1);
}

// Partial round `rnd`: S-box on cell 0, then the internal layer (the
// all-ones matrix plus diag(MINT)) and cell 0's constant of round rnd+1.
// In: c0 < 1.01P, c_i < 2.01P.  Out: the same.
__device__ __forceinline__ void partial_round(uint32_t* c, int rnd) {
  c[0] = sbox(c[0]);  // < 1.85P
  // 24 words below 2.01P, summed in a tree of three-input adds: below 49P
  // < 2^39
  uint64_t s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    s[k] = (uint64_t)c[3 * k] + c[3 * k + 1] + c[3 * k + 2];
  const uint32_t t = reduce64((s[0] + s[1] + s[2]) + (s[3] + s[4] + s[5]) +
                              (s[6] + s[7]));  // < 1.009P
  // c_i MINT_i < 2.01 P^2 < P 2^32, so the product is below 1.95P and one
  // sub_p makes it canonical; t + that < 2.01P < 2^32
#pragma unroll
  for (int i = 1; i < CELLS; ++i) c[i] = t + sub_p(mul_lazy(c[i], MINT[i]));
  // cell 0: (t + rc) < 2.01P -> < 1.01P; plus a canonical product < 2.01P
  // -> < 1.01P, as the next S-box needs
  const uint32_t z0 = sub_p(mul_lazy(c[0], MINT[0]));  // 1.85P * P: < 1.87P -> < P
  c[0] = sub_p(sub_p(t + RCF[(rnd + 1) * CELLS]) + z0);
}

// The permutation (reference mod.rs:180-213).  In: c < 1.85P.  Out:
// c < 1.01P; callers apply sub_p to the words they store.
__device__ void permute(uint32_t* c) {
  ext_layer(c, 0);
#pragma unroll 1
  for (int rnd = 0; rnd < HALF_FULL; ++rnd) full_round(c, rnd);
#pragma unroll 1
  for (int rnd = HALF_FULL; rnd < FIRST_LAST_FULL; ++rnd)
    partial_round(c, rnd);
  // cell 0 holds round 25's constant already (the last partial round);
  // the others add theirs: c < 2.01P -> < 1.01P, + rc < 2.01P -> < 1.01P
#pragma unroll
  for (int i = 1; i < CELLS; ++i)
    c[i] = sub_p(sub_p(c[i]) + RCF[FIRST_LAST_FULL * CELLS + i]);
#pragma unroll 1
  for (int rnd = FIRST_LAST_FULL; rnd < ROUNDS; ++rnd) full_round(c, rnd);
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
  for (int i = 0; i < OUT; ++i) out[r * OUT + i] = sub_p(c[i]);
}

constexpr int THREADS = 128;
constexpr int FOLD_THREADS = 256;  // 512 digests: up to 9 levels a launch

__device__ __forceinline__ void compress(uint32_t* c, const uint32_t* l,
                                         const uint32_t* r) {
#pragma unroll
  for (int j = 0; j < OUT; ++j) {
    c[j] = l[j];
    c[OUT + j] = r[j];
    c[2 * OUT + j] = 0;
  }
  permute(c);
#pragma unroll
  for (int j = 0; j < OUT; ++j) c[j] = sub_p(c[j]);
}

// `levels` Merkle levels: level 1 hashes the pairs (left[i], right[i]),
// i < n; level k > 1 hashes pairs of level k-1 digests.  Level k's n >>
// (k-1) digests are written consecutively after level k-1's, from `out`.
// A block of FOLD_THREADS threads takes 2 * FOLD_THREADS inputs and keeps
// its level's digests in shared memory for the next; when levels > 1, n
// is a multiple of 2^(levels-1).
__global__ void __launch_bounds__(FOLD_THREADS)
    merkle_fold_kernel(const uint32_t* __restrict__ left,
                       const uint32_t* __restrict__ right,
                       uint32_t* __restrict__ out, uint64_t n,
                       uint64_t lstride, uint64_t rstride, int levels) {
  __shared__ uint32_t level_digests[FOLD_THREADS * OUT];
  const uint64_t base = (uint64_t)blockIdx.x * FOLD_THREADS;
  const uint32_t t = threadIdx.x;
  const uint64_t here = n - base < FOLD_THREADS ? n - base : FOLD_THREADS;
  uint32_t c[CELLS];
  uint64_t width = n;  // digests of the current level
  uint64_t first = base;
  for (int k = 0; k < levels; ++k) {
    const uint64_t active = here >> k;
    uint32_t l[OUT], r[OUT];
    if (k > 0) {
      if (t < active) {
#pragma unroll
        for (int j = 0; j < OUT; ++j) {
          l[j] = level_digests[(2 * t) * OUT + j];
          r[j] = level_digests[(2 * t + 1) * OUT + j];
        }
      }
      __syncthreads();  // every read of level k-1 before any write of k
    }
    if (t < active) {
      if (k == 0)
        compress(c, left + (base + t) * lstride, right + (base + t) * rstride);
      else
        compress(c, l, r);
#pragma unroll
      for (int j = 0; j < OUT; ++j) {
        out[(first + t) * OUT + j] = c[j];
        level_digests[t * OUT + j] = c[j];
      }
    }
    __syncthreads();
    out += width * OUT;
    width >>= 1;
    first >>= 1;
  }
}

}  // namespace

extern "C" int p2_set_constants(const uint32_t* rcf, const uint32_t* mint) {
  cudaError_t e =
      cudaMemcpyToSymbol(RCF, rcf, sizeof(uint32_t) * (ROUNDS + 1) * CELLS);
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

extern "C" int p2_merkle_fold(const uint32_t* left, const uint32_t* right,
                              uint32_t* out, uint64_t n, uint64_t lstride,
                              uint64_t rstride, int levels, void* stream) {
  if (n == 0) return 0;
  if (levels < 1 || (1ull << (levels - 1)) > FOLD_THREADS ||
      (n & ((1ull << (levels - 1)) - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  uint64_t blocks = (n + FOLD_THREADS - 1) / FOLD_THREADS;
  unsigned threads = n < FOLD_THREADS ? (unsigned)n : FOLD_THREADS;
  merkle_fold_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      left, right, out, n, lstride, rstride, levels);
  return (int)cudaGetLastError();
}
