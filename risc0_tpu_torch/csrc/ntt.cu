// Batched BabyBear NTTs for Hopper: two shared-memory passes.
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
// Stage l pairs x[i] with x[i + 2^(l-1)] inside blocks of 2^l, with the
// twiddle w_l^j, j = i mod 2^(l-1), w_l the (inverse) 2^l-th root.
//
// What bounds it: memory traffic.  A butterfly is one Montgomery product
// and two adds per two words, so the cost is how often the array crosses
// device memory.  The design reads and writes it twice (the Pallas
// four-step, without its transpose), with n = 2^(k1 + k2) split by the
// wrapper (hal/cuda/ntt.py split()):
//   * the contiguous pass runs the stages inside 2^k1-word blocks: one
//     block per row segment, loaded with 16-byte reads into shared memory
//     (padded one word in 32 against bank conflicts);
//   * the strided pass runs stages k1+1..k1+k2.  For an offset r < 2^k1,
//     the words x[q * 2^k1 + r] (q < 2^k2) form an independent transform
//     whose stage-m twiddle is A_m[q'] * B_m[r]: A_m = w_m^q' is the local
//     table of stage m, B_m = w_(k1+m)^r.  A block loads a tile of 2^k2
//     rows x 2^cb consecutive offsets (16 or 32 words, so every row read
//     is a whole 64- or 128-byte run) with cp.async into dynamic shared
//     memory, runs its stages in place and writes the tile back.
// The wrapper chooses k1, k2 and cb; a block that does not fit in shared
// memory fails at launch.  Above k1 + k2 each remaining stage is one
// launch over device memory; those sizes (n > 2^24) are not on the
// prover's path.
//
// Inside a pass, each thread takes 8 words into registers and runs three
// stages on them (radix 8) between two __syncthreads, with 32-bit
// indices within a row.  Blocks of 256 threads keep several blocks
// resident on an SM, so one block's loads overlap another's arithmetic.
// On the H100 both passes then run at about half the card's memory rate,
// limited by instruction issue (butterflies, twiddle products, shared-
// memory index arithmetic) rather than by bytes: PERF.md has the numbers.
// Twiddles come from host-built tables read contiguously:
// local[2^(l-1) - 1 + j] = w_l^j, outer[(m-1) * 2^k1 + r] = w_(k1+m)^r
// (the words of the Pallas _stage_tables and _outer_tables).
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

constexpr int RADIX_BITS = 3;  // stages per round: 8 words per thread
constexpr uint32_t THREADS = 256;  // per block, in every kernel

__host__ __device__ __forceinline__ uint32_t pad(uint32_t i) {
  return i + (i >> 5);
}

template <bool FWD>
__device__ __forceinline__ void butterfly(uint32_t& a, uint32_t& b,
                                          uint32_t w) {
  if (FWD) {
    const uint32_t t = bb::mul(b, w);
    b = bb::sub(a, t);
    a = bb::add(a, t);
  } else {
    const uint32_t d = bb::sub(a, b);
    a = bb::add(a, b);
    b = bb::mul(d, w);
  }
}

// S stages l..l+S-1 on v[t] = x[base + t * 2^(l-1)], base mod 2^(l-1) = j0.
// Stage l+u pairs t with t + 2^u (bit u of t clear); its twiddle index is
// j0 + (t mod 2^u) * 2^(l-1), so it takes 2^u distinct twiddles, each
// fetched once.  FWD runs u ascending (DIT), else descending.
template <bool FWD, int S, class Tw>
__device__ __forceinline__ void radix_round(uint32_t (&v)[1 << S], uint32_t l,
                                            uint32_t j0, const Tw& tw) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int u = FWD ? k : S - 1 - k;
#pragma unroll
    for (int r = 0; r < (1 << u); ++r) {
      const uint32_t w = tw(l + u, j0 + ((uint32_t)r << (l - 1)));
#pragma unroll
      for (int h = 0; h < (1 << (S - 1 - u)); ++h) {
        const int t = (h << (u + 1)) | r;
        butterfly<FWD>(v[t], v[t + (1 << u)], w);
      }
    }
  }
}

// One round of S stages over every group of a shared-memory array of
// 2^bits elements; at(i) maps element i to its shared-memory word.
template <bool FWD, int S, class At, class Tw>
__device__ __forceinline__ void smem_round(uint32_t* s, uint32_t groups,
                                           uint32_t l, const At& at,
                                           const Tw& tw, uint32_t lane_bits) {
  const uint32_t lanes = 1u << lane_bits;
  for (uint32_t gi = threadIdx.x; gi < groups; gi += blockDim.x) {
    const uint32_t lane = gi & (lanes - 1);
    const uint32_t g = gi >> lane_bits;
    const uint32_t j0 = g & ((1u << (l - 1)) - 1);
    const uint32_t base = ((g >> (l - 1)) << (l + S - 1)) + j0;
    uint32_t v[1 << S];
#pragma unroll
    for (int t = 0; t < (1 << S); ++t)
      v[t] = s[at(base + ((uint32_t)t << (l - 1)), lane)];
    radix_round<FWD, S>(v, l, j0, [&](uint32_t st, uint32_t j) {
      return tw(st, j, lane);
    });
#pragma unroll
    for (int t = 0; t < (1 << S); ++t)
      s[at(base + ((uint32_t)t << (l - 1)), lane)] = v[t];
  }
}

// Stages [lo, hi] of a 2^bits-element transform held in shared memory, in
// rounds of up to RADIX_BITS stages (ascending for DIT, descending for
// DIF).  Each of the 2^lane_bits lanes is its own transform.
template <bool FWD, class At, class Tw>
__device__ void smem_stages(uint32_t* s, uint32_t bits, uint32_t lane_bits,
                            uint32_t lo, uint32_t hi, const At& at,
                            const Tw& tw) {
  uint32_t done = 0;
  const uint32_t count = hi + 1 - lo;
  while (done < count) {
    const uint32_t S = count - done < RADIX_BITS ? count - done : RADIX_BITS;
    const uint32_t l = FWD ? lo + done : hi + 1 - done - S;
    const uint32_t groups = 1u << (bits - S + lane_bits);
    if (S == 3)
      smem_round<FWD, 3>(s, groups, l, at, tw, lane_bits);
    else if (S == 2)
      smem_round<FWD, 2>(s, groups, l, at, tw, lane_bits);
    else
      smem_round<FWD, 1>(s, groups, l, at, tw, lane_bits);
    done += S;
    __syncthreads();
  }
}

// Contiguous pass: stages [lo, hi] (lo <= hi) of every 2^k-word block of
// every row; the DIF direction multiplies by `scale` as it stores.
template <bool FWD>
__global__ void __launch_bounds__(THREADS)
    contiguous_kernel(const uint32_t* src, uint32_t* dst,
                      const uint32_t* __restrict__ local, uint32_t n_bits,
                      uint32_t k, uint32_t lo, uint32_t hi, uint32_t scale) {
  extern __shared__ __align__(16) uint32_t s[];
  const uint32_t blk = 1u << k;
  const size_t off =
      ((size_t)blockIdx.y << n_bits) + ((size_t)blockIdx.x << k);
  const uint32_t* in = src + off;
  uint32_t* out = dst + off;
  if (k >= 2) {
    for (uint32_t i = threadIdx.x * 4; i < blk; i += blockDim.x * 4) {
      const uint4 w = *reinterpret_cast<const uint4*>(in + i);
      s[pad(i)] = w.x;
      s[pad(i + 1)] = w.y;
      s[pad(i + 2)] = w.z;
      s[pad(i + 3)] = w.w;
    }
  } else {
    for (uint32_t i = threadIdx.x; i < blk; i += blockDim.x) s[pad(i)] = in[i];
  }
  __syncthreads();
  if (lo <= hi)
    smem_stages<FWD>(
        s, k, 0, lo, hi, [](uint32_t i, uint32_t) { return pad(i); },
        [local](uint32_t l, uint32_t j, uint32_t) {
          return __ldg(local + (1u << (l - 1)) - 1 + j);
        });
  if (k >= 2) {
    for (uint32_t i = threadIdx.x * 4; i < blk; i += blockDim.x * 4) {
      uint4 w = make_uint4(s[pad(i)], s[pad(i + 1)], s[pad(i + 2)],
                           s[pad(i + 3)]);
      if (!FWD) {
        w.x = bb::mul(w.x, scale);
        w.y = bb::mul(w.y, scale);
        w.z = bb::mul(w.z, scale);
        w.w = bb::mul(w.w, scale);
      }
      *reinterpret_cast<uint4*>(out + i) = w;
    }
  } else {
    for (uint32_t i = threadIdx.x; i < blk; i += blockDim.x)
      out[i] = FWD ? s[pad(i)] : bb::mul(s[pad(i)], scale);
  }
}

__device__ __forceinline__ void cp_async16(uint32_t* smem, const uint32_t* g) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(g));
}

// Strided pass: stages k1+mlo..k1+mhi of every super-block of 2^(k1+k2)
// words.  Block (x, row): super-block x >> (k1 - CB), offsets r0 = C *
// (x mod 2^(k1 - CB)) .. r0 + C - 1.  Shared memory: the tile s[q * C + c]
// (2^k2 rows x C offsets), then B_m[r0 + c] for m = 1..k2.
template <bool FWD, int CB>
__global__ void __launch_bounds__(THREADS)
    strided_kernel(const uint32_t* src, uint32_t* dst,
                   const uint32_t* __restrict__ local,
                   const uint32_t* __restrict__ outer, uint32_t n_bits,
                   uint32_t k1, uint32_t k2, uint32_t mlo, uint32_t mhi) {
  constexpr uint32_t C = 1u << CB;
  extern __shared__ __align__(16) uint32_t s[];
  uint32_t* bs = s + (C << k2);
  const uint32_t tile_bits = k1 - CB;
  const uint32_t r0 = (blockIdx.x & ((1u << tile_bits) - 1)) << CB;
  const size_t off = ((size_t)blockIdx.y << n_bits) +
                     ((size_t)(blockIdx.x >> tile_bits) << (k1 + k2)) + r0;
  const uint32_t chunks = (C / 4) << k2;
  for (uint32_t id = threadIdx.x; id < chunks; id += blockDim.x) {
    const uint32_t q = id / (C / 4), v = 4 * (id % (C / 4));
    cp_async16(s + q * C + v, src + off + ((size_t)q << k1) + v);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (uint32_t id = threadIdx.x; id < k2 * C; id += blockDim.x)
    bs[id] = __ldg(outer + ((size_t)(id / C) << k1) + r0 + id % C);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  smem_stages<FWD>(
      s, k2, CB, mlo, mhi,
      [](uint32_t q, uint32_t c) { return (q << CB) + c; },
      [local, bs](uint32_t m, uint32_t j, uint32_t c) {
        return bb::mul(__ldg(local + (1u << (m - 1)) - 1 + j),
                       bs[((m - 1) << CB) + c]);
      });
  for (uint32_t id = threadIdx.x; id < chunks; id += blockDim.x) {
    const uint32_t q = id / (C / 4), v = 4 * (id % (C / 4));
    *reinterpret_cast<uint4*>(dst + off + ((size_t)q << k1) + v) =
        *reinterpret_cast<const uint4*>(s + q * C + v);
  }
}

// One stage l over device memory, one thread per butterfly (n_bits > 24
// only); tw = W^0..W^(n/2-1) of the 2^n_bits-th root.
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
  uint32_t a = src[i0], c = src[i1];
  butterfly<FWD>(a, c, tw[j << (n_bits - l)]);
  dst[i0] = a;
  dst[i1] = c;
}

struct Plan {
  const uint32_t* local;  // w_l^j at 2^(l-1) - 1 + j
  const uint32_t* outer;  // w_(k1+m)^r at (m-1) * 2^k1 + r
  const uint32_t* full;   // W^0..W^(n/2-1), read only when k1 + k2 < n_bits
  uint32_t batch, n_bits, k1, k2, cb;
  cudaStream_t stream;
};

template <bool FWD>
cudaError_t launch_contiguous(const Plan& p, const uint32_t* src,
                              uint32_t* dst, uint32_t lo, uint32_t hi,
                              uint32_t scale) {
  const uint32_t k = p.k1;
  uint32_t threads = (1u << k) >> RADIX_BITS;
  threads = threads < 32 ? 32 : (threads > THREADS ? THREADS : threads);
  const size_t smem = sizeof(uint32_t) * (size_t)pad(1u << k);
  cudaError_t e = cudaFuncSetAttribute(
      contiguous_kernel<FWD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(1u << (p.n_bits - k), p.batch);
  contiguous_kernel<FWD><<<grid, threads, smem, p.stream>>>(
      src, dst, p.local, p.n_bits, k, lo, hi, scale);
  return cudaGetLastError();
}

template <bool FWD, int CB>
cudaError_t launch_strided_cb(const Plan& p, const uint32_t* src,
                              uint32_t* dst, uint32_t mlo, uint32_t mhi) {
  const size_t smem = sizeof(uint32_t) * (((size_t)1 << (p.k2 + CB)) +
                                          ((size_t)p.k2 << CB));
  cudaError_t e = cudaFuncSetAttribute(
      strided_kernel<FWD, CB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  uint32_t threads = (1u << (p.k2 + CB)) >> RADIX_BITS;
  threads = threads < 32 ? 32 : (threads > THREADS ? THREADS : threads);
  dim3 grid(1u << (p.n_bits - p.k2 - CB), p.batch);
  strided_kernel<FWD, CB><<<grid, threads, smem, p.stream>>>(
      src, dst, p.local, p.outer, p.n_bits, p.k1, p.k2, mlo, mhi);
  return cudaGetLastError();
}

// Tiles 2^cb = 16 or 32 offsets wide.
template <bool FWD>
cudaError_t launch_strided(const Plan& p, const uint32_t* src, uint32_t* dst,
                           uint32_t mlo, uint32_t mhi) {
  if (p.cb == 5) return launch_strided_cb<FWD, 5>(p, src, dst, mlo, mhi);
  return launch_strided_cb<FWD, 4>(p, src, dst, mlo, mhi);
}

template <bool FWD>
cudaError_t launch_stage(const Plan& p, const uint32_t* src, uint32_t* dst,
                         uint32_t l) {
  const uint64_t total = (uint64_t)p.batch << (p.n_bits - 1);
  const uint64_t blocks = (total + THREADS - 1) / THREADS;
  stage_kernel<FWD><<<(unsigned)blocks, THREADS, 0, p.stream>>>(
      src, dst, p.full, p.n_bits, l, total);
  return cudaGetLastError();
}

bool valid(const Plan& p) {
  return p.k1 + p.k2 <= p.n_bits &&
         (p.k2 == 0 ? p.k1 == p.n_bits
                    : (p.cb == 4 || p.cb == 5) && p.k1 >= p.cb) &&
         (p.k1 + p.k2 == p.n_bits || p.full != nullptr);
}

#define NTT_TRY(x)                            \
  do {                                        \
    const cudaError_t e_ = (x);               \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

}  // namespace

// src -> dst (distinct buffers, 16-byte aligned); k1, k2, cb from the
// wrapper's split() and cols_bits().  Runs DIT stages expand_bits+1..n_bits.
extern "C" int ntt_evaluate(const uint32_t* src, uint32_t* dst,
                            const uint32_t* local, const uint32_t* outer,
                            const uint32_t* full, uint32_t batch,
                            uint32_t n_bits, uint32_t k1, uint32_t k2,
                            uint32_t cb, uint32_t expand_bits, void* stream) {
  const Plan p{local, outer, full, batch, n_bits, k1, k2, cb,
               (cudaStream_t)stream};
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const uint32_t* cur = src;
  if (expand_bits < k1) {
    NTT_TRY(launch_contiguous<true>(p, cur, dst, expand_bits + 1, k1, 0));
    cur = dst;
  }
  if (k2 > 0 && expand_bits < k1 + k2) {
    const uint32_t mlo = expand_bits > k1 ? expand_bits - k1 + 1 : 1;
    NTT_TRY(launch_strided<true>(p, cur, dst, mlo, k2));
    cur = dst;
  }
  for (uint32_t l = k1 + k2 + 1; l <= n_bits; ++l) {
    if (l <= expand_bits) continue;
    NTT_TRY(launch_stage<true>(p, cur, dst, l));
    cur = dst;
  }
  if (cur == src)  // every stage skipped
    NTT_TRY(cudaMemcpyAsync(dst, src, sizeof(uint32_t) * ((size_t)batch
                            << n_bits), cudaMemcpyDeviceToDevice, p.stream));
  return 0;
}

// src -> dst (distinct buffers, 16-byte aligned); norm = 1/n (Montgomery),
// applied as the contiguous pass stores.  Runs DIF stages n_bits..1.
extern "C" int ntt_interpolate(const uint32_t* src, uint32_t* dst,
                               const uint32_t* local, const uint32_t* outer,
                               const uint32_t* full, uint32_t batch,
                               uint32_t n_bits, uint32_t k1, uint32_t k2,
                               uint32_t cb, uint32_t norm, void* stream) {
  const Plan p{local, outer, full, batch, n_bits, k1, k2, cb,
               (cudaStream_t)stream};
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const uint32_t* cur = src;
  for (uint32_t l = n_bits; l > k1 + k2; --l) {
    NTT_TRY(launch_stage<false>(p, cur, dst, l));
    cur = dst;
  }
  if (k2 > 0) {
    NTT_TRY(launch_strided<false>(p, cur, dst, 1, k2));
    cur = dst;
  }
  // k1 = 0 (n = 1) runs no stage: lo > hi, the pass only scales
  NTT_TRY(launch_contiguous<false>(p, cur, dst, 1, k1, norm));
  return 0;
}
