// Batched BabyBear NTTs for Hopper.
//
// Replaces the Pallas kernels in risc0_tpu/hal/pallas/ntt.py:
//   * ntt_evaluate    <- evaluate_ntt (:124; pass 1 _local_stages :77-95 at
//                        :148, pass 2 _outer_stage :98-115 at :173)
//   * ntt_interpolate <- interpolate_ntt (:186; outer stages at :221, local
//                        stages with the 1/n scale fused at :240)
//
// Layout: (batch, n) row-major words; coefficients bit-reversed, evaluations
// natural.  evaluate runs DIT stages expand_bits+1..n_bits (the bottom
// expand_bits stages are skipped: an expanded input is constant inside
// those blocks); interpolate runs DIF stages n_bits..1 and scales by 1/n.
// Stage l pairs x[i] with x[i + 2^(l-1)] inside blocks of 2^l, with twiddle
// W^(j * 2^(n_bits-l)) read from one table of W^0..W^(n/2-1).
//
// What bounds it: memory traffic.  A butterfly is one Montgomery product
// and two adds per two words, far below the card's integer rate, so the
// cost is how often the (batch, n) array crosses device memory.  The design
// runs the stages that stay inside a 2^LOCAL_BITS block (the bottom stages
// for DIT, the last ones for DIF) in shared memory in one pass: one read
// and one write for LOCAL_BITS stages.  Each stage above that is one
// launch over device memory (a read and a write each), coalesced along the
// row.  At n = 2^22 that is 1 + 11 passes; the Pallas design needed 2 plus
// a transpose.  Folding the outer stages into a second shared-memory pass
// over a strided view is later work.
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

constexpr uint32_t LOCAL_BITS = 11;  // 2^11 words = 8 KB of shared memory
constexpr int STAGE_THREADS = 256;

// Stages [lo, hi] of one 2^k block of one row in shared memory.  FWD runs
// them ascending (DIT), otherwise descending (DIF) and then scales.
template <bool FWD>
__global__ void local_kernel(const uint32_t* src, uint32_t* dst,
                             const uint32_t* __restrict__ tw, uint32_t n_bits,
                             uint32_t k, uint32_t lo, uint32_t hi,
                             uint32_t scale) {
  extern __shared__ uint32_t s[];
  const uint32_t blk = 1u << k;
  const uint64_t base =
      ((uint64_t)blockIdx.y << n_bits) + ((uint64_t)blockIdx.x << k);
  for (uint32_t t = threadIdx.x; t < blk; t += blockDim.x) s[t] = src[base + t];
  __syncthreads();
  const uint32_t nb = blk >> 1;
  for (uint32_t step = 0; lo <= hi && step <= hi - lo; ++step) {
    const uint32_t l = FWD ? lo + step : hi - step;
    const uint32_t half_bits = l - 1;
    for (uint32_t b = threadIdx.x; b < nb; b += blockDim.x) {
      const uint32_t j = b & ((1u << half_bits) - 1);
      const uint32_t i0 = ((b >> half_bits) << l) + j;
      const uint32_t i1 = i0 + (1u << half_bits);
      const uint32_t w = tw[(uint64_t)j << (n_bits - l)];
      const uint32_t a = s[i0];
      if (FWD) {
        const uint32_t bt = bb::mul(s[i1], w);
        s[i0] = bb::add(a, bt);
        s[i1] = bb::sub(a, bt);
      } else {
        const uint32_t c = s[i1];
        s[i0] = bb::add(a, c);
        s[i1] = bb::mul(bb::sub(a, c), w);
      }
    }
    __syncthreads();
  }
  for (uint32_t t = threadIdx.x; t < blk; t += blockDim.x)
    dst[base + t] = FWD ? s[t] : bb::mul(s[t], scale);
}

// One stage l over device memory: one thread per butterfly.
template <bool FWD>
__global__ void stage_kernel(const uint32_t* src, uint32_t* dst,
                             const uint32_t* __restrict__ tw, uint32_t n_bits,
                             uint32_t l, uint64_t total) {
  const uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const uint64_t row = t >> (n_bits - 1);
  const uint64_t b = t & ((1ull << (n_bits - 1)) - 1);
  const uint32_t half_bits = l - 1;
  const uint64_t j = b & ((1ull << half_bits) - 1);
  const uint64_t i0 = (row << n_bits) + ((b >> half_bits) << l) + j;
  const uint64_t i1 = i0 + (1ull << half_bits);
  const uint32_t w = tw[j << (n_bits - l)];
  const uint32_t a = src[i0];
  const uint32_t c = src[i1];
  if (FWD) {
    const uint32_t ct = bb::mul(c, w);
    dst[i0] = bb::add(a, ct);
    dst[i1] = bb::sub(a, ct);
  } else {
    dst[i0] = bb::add(a, c);
    dst[i1] = bb::mul(bb::sub(a, c), w);
  }
}

template <bool FWD>
cudaError_t launch_local(const uint32_t* src, uint32_t* dst, const uint32_t* tw,
                         uint32_t batch, uint32_t n_bits, uint32_t k,
                         uint32_t lo, uint32_t hi, uint32_t scale,
                         cudaStream_t stream) {
  const uint32_t threads = k == 0 ? 1 : (k - 1 >= 10 ? 1024 : 1u << (k - 1));
  dim3 grid(1u << (n_bits - k), batch);
  local_kernel<FWD><<<grid, threads, sizeof(uint32_t) << k, stream>>>(
      src, dst, tw, n_bits, k, lo, hi, scale);
  return cudaGetLastError();
}

template <bool FWD>
cudaError_t launch_stage(const uint32_t* src, uint32_t* dst, const uint32_t* tw,
                         uint32_t batch, uint32_t n_bits, uint32_t l,
                         cudaStream_t stream) {
  const uint64_t total = (uint64_t)batch << (n_bits - 1);
  const uint64_t blocks = (total + STAGE_THREADS - 1) / STAGE_THREADS;
  stage_kernel<FWD><<<(unsigned)blocks, STAGE_THREADS, 0, stream>>>(
      src, dst, tw, n_bits, l, total);
  return cudaGetLastError();
}

}  // namespace

// src -> dst (which may alias src); tw = forward table W^0..W^(n/2-1).
extern "C" int ntt_evaluate(const uint32_t* src, uint32_t* dst,
                            const uint32_t* tw, uint32_t batch,
                            uint32_t n_bits, uint32_t expand_bits,
                            void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t k = n_bits < LOCAL_BITS ? n_bits : LOCAL_BITS;
  cudaError_t e = launch_local<true>(src, dst, tw, batch, n_bits, k,
                                     expand_bits + 1, k, 0, st);
  if (e != cudaSuccess) return (int)e;
  const uint32_t first = (expand_bits + 1 > k + 1) ? expand_bits + 1 : k + 1;
  for (uint32_t l = first; l <= n_bits; ++l) {
    e = launch_stage<true>(dst, dst, tw, batch, n_bits, l, st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// src -> dst (which may alias src); tw = inverse table; norm = 1/n
// (Montgomery), applied as the local pass writes back.
extern "C" int ntt_interpolate(const uint32_t* src, uint32_t* dst,
                               const uint32_t* tw, uint32_t batch,
                               uint32_t n_bits, uint32_t norm, void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t k = n_bits < LOCAL_BITS ? n_bits : LOCAL_BITS;
  const uint32_t* cur = src;
  cudaError_t e;
  for (uint32_t l = n_bits; l > k; --l) {
    e = launch_stage<false>(cur, dst, tw, batch, n_bits, l, st);
    if (e != cudaSuccess) return (int)e;
    cur = dst;
  }
  e = launch_local<false>(cur, dst, tw, batch, n_bits, k, 1, k, norm, st);
  return (int)e;
}
