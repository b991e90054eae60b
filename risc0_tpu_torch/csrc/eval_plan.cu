// The plan interpreter: constraint evaluation of one domain chunk, with the
// range plan's op stream (risc0_tpu_torch/circuit/ir_range.py encode_plan)
// run over the register files, one thread a domain row.
//
// It replaces no Pallas kernel: the JAX package evaluates its range plan in
// plain XLA (risc0_tpu/circuit/ir_range.py).  Its plain twin on torch,
// ir_range._run_chunk, makes about 11,800 launches a chunk, each a full pass
// over a (rows, T) temporary; this kernel makes one.
//
// The plan is data.  The stream's words name each group's kind, rows and mix
// powers, so one build serves rv32im, the recursion circuit and keccak, and
// nothing is compiled per circuit.  Every thread walks the same stream, so
// the branches are warp-uniform and each word is one broadcast load through
// the read-only cache.
//
// Bound: register-file bytes.  A row of the rv32im plan reads 178,772 B and
// writes 76,044 B (fp words 4 B, ext elements 16 B): 1.07 TB over the 2^22
// rows of a po2 20 domain, 0.32 s at 3.35 TB/s if nothing stayed in L2 (the
// recursion circuit 79,092 + 31,248 B a row, keccak 322,252 + 106,912).  The
// field products are a small share of that.
//
// The file stays in device memory, in the twin's layout: fp word r of row t
// at r * T + t, ext element r at (r * T + t) * 4, so the two compare bit for
// bit on any chunk.  An rv32im row holds 8,229 fp and 3,018 ext registers,
// 81 KB, far beyond a thread's 255 registers or an SM's 227 KB of shared
// memory.  A warp's fp access is one 128-byte line, its ext access one
// 16-byte vector a thread.  T = 2^16 rows are about 500 threads a SM, too
// few to hide the memory's latency one load at a time; the ops of a group
// are independent (one level of the plan), so a thread issues the loads of
// up to U of them before it computes and stores any.
//
// Field arithmetic is exact (babybear.cuh's Montgomery product on the
// native 32x32->64 multiply), so every row equals the twin's word for word.
// Chain terms and signed-sum leaves accumulate in 64 bits and reduce once.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "babybear.cuh"

namespace {

// opcodes: ir_range.OPCODES
enum : int32_t {
  FADD, FSUB, FMUL, EADD, ESUB, EMUL, ESCALE, EADDF, ESUBF, FSUBE, CHAIN, FSUM
};
constexpr int HEAD = 4;        // ir_range.STREAM_HEAD
constexpr int BLOCK = 128;
// 4 blocks a SM hold 512 threads, the whole chunk of 2^16 rows at once
// (about 496 a SM): the launch bounds cap a thread at 128 registers, where
// 168 had left a second wave of blocks (1.5x the time on the card)
constexpr int MIN_BLOCKS = 4;
constexpr int U_FP = 4;        // loads of U_FP fp ops in flight a thread
constexpr int U_EXT = 4;       // of U_EXT ext ops
constexpr uint32_t MONT_NBETA = 1073741848u;  // field.MONT_NBETA: -11 R mod P

__device__ __forceinline__ uint32_t neg(uint32_t a) { return bb::sub(0, a); }

__device__ __forceinline__ uint4 e_add(uint4 a, uint4 b) {
  return make_uint4(bb::add(a.x, b.x), bb::add(a.y, b.y), bb::add(a.z, b.z),
                    bb::add(a.w, b.w));
}

__device__ __forceinline__ uint4 e_sub(uint4 a, uint4 b) {
  return make_uint4(bb::sub(a.x, b.x), bb::sub(a.y, b.y), bb::sub(a.z, b.z),
                    bb::sub(a.w, b.w));
}

__device__ __forceinline__ uint4 e_scale(uint4 a, uint32_t s) {
  return make_uint4(bb::mul(a.x, s), bb::mul(a.y, s), bb::mul(a.z, s),
                    bb::mul(a.w, s));
}

// F_p4 product, x^4 = -11 (field.ext_mul)
__device__ __forceinline__ uint4 e_mul(uint4 a, uint4 b) {
  using bb::add;
  using bb::mul;
  const uint32_t c0 = add(mul(a.x, b.x),
                          mul(MONT_NBETA, add(add(mul(a.y, b.w),
                                                  mul(a.z, b.z)),
                                              mul(a.w, b.y))));
  const uint32_t c1 = add(add(mul(a.x, b.y), mul(a.y, b.x)),
                          mul(MONT_NBETA, add(mul(a.z, b.w), mul(a.w, b.z))));
  const uint32_t c2 = add(add(add(mul(a.x, b.z), mul(a.y, b.y)),
                              mul(a.z, b.x)),
                          mul(MONT_NBETA, mul(a.w, b.w)));
  const uint32_t c3 = add(add(add(mul(a.x, b.w), mul(a.y, b.z)),
                              mul(a.z, b.y)),
                          mul(a.w, b.x));
  return make_uint4(c0, c1, c2, c3);
}

// one thread's domain row of the two files
struct Row {
  uint32_t* fp;  // &fp[0][t]
  uint4* ext;    // &ext[0][t]
  size_t T;
};

template <class X>
__device__ __forceinline__ X* reg(const Row& r, int32_t i);

template <>
__device__ __forceinline__ uint32_t* reg<uint32_t>(const Row& r, int32_t i) {
  return r.fp + (size_t)i * r.T;
}

template <>
__device__ __forceinline__ uint4* reg<uint4>(const Row& r, int32_t i) {
  return r.ext + (size_t)i * r.T;
}

template <class X>
__device__ __forceinline__ X load(const Row& r, int32_t i) {
  return *reg<X>(r, i);
}

template <class X>
__device__ __forceinline__ void store(const Row& r, int32_t i, X v) {
  *reg<X>(r, i) = v;
}

// dst + i = fn(a_i, b_i) for the n (a_i, b_i) pairs at s; A, B and D are
// the operands' and the result's file (uint32_t fp, uint4 ext)
template <int U, class A, class B, class D, class Fn>
__device__ __forceinline__ void binary(const Row& r,
                                       const int32_t* __restrict__ s,
                                       int32_t n, int32_t dst, Fn fn) {
  for (int32_t i = 0; i < n; i += U) {
    A a[U];
    B b[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (i + j < n) {
        a[j] = load<A>(r, __ldg(s + 2 * (i + j)));
        b[j] = load<B>(r, __ldg(s + 2 * (i + j) + 1));
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (i + j < n) store<D>(r, dst + i + j, fn(a[j], b[j]));
    }
  }
}

struct Sum4 {
  uint64_t x, y, z, w;

  __device__ __forceinline__ void add(uint4 v) {
    x += v.x;
    y += v.y;
    z += v.z;
    w += v.w;
  }
  __device__ __forceinline__ uint4 reduce() const {
    return make_uint4((uint32_t)(x % bb::P), (uint32_t)(y % bb::P),
                      (uint32_t)(z % bb::P), (uint32_t)(w % bb::P));
  }
};

// dst = acc + sum pm[k] * f + sum pm[k] * e + sum pm[k] * f * e over the
// chain's three term lists at s; returns the word after them
__device__ __forceinline__ const int32_t* chain(
    const Row& r, const int32_t* __restrict__ s,
    const uint4* __restrict__ pm) {
  const int32_t dst = __ldg(s + 1), acc = __ldg(s + 2);
  const int32_t n1 = __ldg(s + 3), n2 = __ldg(s + 4), n3 = __ldg(s + 5);
  s += 6;
  const uint4 a0 = load<uint4>(r, acc);
  Sum4 c{a0.x, a0.y, a0.z, a0.w};
  for (int32_t i = 0; i < n1; i += U_FP) {
    uint32_t f[U_FP];
    uint4 m[U_FP];
#pragma unroll
    for (int j = 0; j < U_FP; ++j) {
      if (i + j < n1) {
        m[j] = __ldg(pm + __ldg(s + 2 * (i + j)));
        f[j] = load<uint32_t>(r, __ldg(s + 2 * (i + j) + 1));
      }
    }
#pragma unroll
    for (int j = 0; j < U_FP; ++j) {
      if (i + j < n1) c.add(e_scale(m[j], f[j]));
    }
  }
  s += 2 * n1;
  for (int32_t i = 0; i < n2; i += U_EXT) {
    uint4 e[U_EXT], m[U_EXT];
#pragma unroll
    for (int j = 0; j < U_EXT; ++j) {
      if (i + j < n2) {
        m[j] = __ldg(pm + __ldg(s + 2 * (i + j)));
        e[j] = load<uint4>(r, __ldg(s + 2 * (i + j) + 1));
      }
    }
#pragma unroll
    for (int j = 0; j < U_EXT; ++j) {
      if (i + j < n2) c.add(e_mul(m[j], e[j]));
    }
  }
  s += 2 * n2;
  for (int32_t i = 0; i < n3; i += U_EXT) {
    uint32_t f[U_EXT];
    uint4 e[U_EXT], m[U_EXT];
#pragma unroll
    for (int j = 0; j < U_EXT; ++j) {
      if (i + j < n3) {
        m[j] = __ldg(pm + __ldg(s + 3 * (i + j)));
        f[j] = load<uint32_t>(r, __ldg(s + 3 * (i + j) + 1));
        e[j] = load<uint4>(r, __ldg(s + 3 * (i + j) + 2));
      }
    }
#pragma unroll
    for (int j = 0; j < U_EXT; ++j) {
      if (i + j < n3) c.add(e_mul(e_scale(m[j], f[j]), e[j]));
    }
  }
  s += 3 * n3;
  store<uint4>(r, dst, c.reduce());
  return s;
}

// dst0 + i = the signed sum of sum i's leaves (row << 1 | negative);
// returns the word after the group
__device__ __forceinline__ const int32_t* fsum(const Row& r,
                                               const int32_t* __restrict__ s) {
  const int32_t n = __ldg(s + 1), dst = __ldg(s + 2);
  s += 3;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t len = __ldg(s);
    ++s;
    uint64_t acc = 0;  // < 2^15 leaves of < 2^31: no wrap
    for (int32_t k = 0; k < len; k += U_FP) {
      int32_t w[U_FP];
      uint32_t v[U_FP];
#pragma unroll
      for (int j = 0; j < U_FP; ++j) {
        if (k + j < len) {
          w[j] = __ldg(s + k + j);
          v[j] = load<uint32_t>(r, w[j] >> 1);
        }
      }
#pragma unroll
      for (int j = 0; j < U_FP; ++j) {
        if (k + j < len) acc += (w[j] & 1) ? bb::P - v[j] : v[j];
      }
    }
    store<uint32_t>(r, dst + i, (uint32_t)(acc % bb::P));
    s += len;
  }
  return s;
}

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
eval_plan_kernel(const int32_t* __restrict__ ops, uint32_t n_words,
                 uint32_t* __restrict__ fp, uint4* __restrict__ ext,
                 const uint4* __restrict__ pm, uint32_t T) {
  const uint32_t t = blockIdx.x * BLOCK + threadIdx.x;
  if (t >= T) return;
  const Row r{fp + t, ext + t, T};
  const int32_t* s = ops + HEAD;
  const int32_t* const end = ops + n_words;
  while (s < end) {
    const int32_t op = __ldg(s);
    if (op == CHAIN) {
      s = chain(r, s, pm);
      continue;
    }
    if (op == FSUM) {
      s = fsum(r, s);
      continue;
    }
    const int32_t n = __ldg(s + 1), dst = __ldg(s + 2);
    const int32_t* const ab = s + 3;
    s = ab + 2 * n;
    switch (op) {
      case FADD:
        binary<U_FP, uint32_t, uint32_t, uint32_t>(
            r, ab, n, dst,
            [](uint32_t a, uint32_t b) { return bb::add(a, b); });
        break;
      case FSUB:
        binary<U_FP, uint32_t, uint32_t, uint32_t>(
            r, ab, n, dst,
            [](uint32_t a, uint32_t b) { return bb::sub(a, b); });
        break;
      case FMUL:
        binary<U_FP, uint32_t, uint32_t, uint32_t>(
            r, ab, n, dst,
            [](uint32_t a, uint32_t b) { return bb::mul(a, b); });
        break;
      case EADD:
        binary<U_EXT, uint4, uint4, uint4>(
            r, ab, n, dst, [](uint4 a, uint4 b) { return e_add(a, b); });
        break;
      case ESUB:
        binary<U_EXT, uint4, uint4, uint4>(
            r, ab, n, dst, [](uint4 a, uint4 b) { return e_sub(a, b); });
        break;
      case EMUL:
        binary<U_EXT, uint4, uint4, uint4>(
            r, ab, n, dst, [](uint4 a, uint4 b) { return e_mul(a, b); });
        break;
      case ESCALE:
        binary<U_EXT, uint4, uint32_t, uint4>(
            r, ab, n, dst,
            [](uint4 a, uint32_t b) { return e_scale(a, b); });
        break;
      case EADDF:
        binary<U_EXT, uint4, uint32_t, uint4>(
            r, ab, n, dst, [](uint4 a, uint32_t b) {
              a.x = bb::add(a.x, b);
              return a;
            });
        break;
      case ESUBF:
        binary<U_EXT, uint4, uint32_t, uint4>(
            r, ab, n, dst, [](uint4 a, uint32_t b) {
              a.x = bb::sub(a.x, b);
              return a;
            });
        break;
      case FSUBE:
        binary<U_EXT, uint32_t, uint4, uint4>(
            r, ab, n, dst, [](uint32_t a, uint4 b) {
              return make_uint4(bb::sub(a, b.x), neg(b.y), neg(b.z), neg(b.w));
            });
        break;
      default:
        __trap();  // not a stream of encode_plan
    }
  }
}

}  // namespace

// Evaluate the op stream ops[0, n_words) over the files fp (fp_rows, T)
// and ext (ext_rows, T, 4) in place, with the mix powers pm (n, 4); the
// wrapper (hal/cuda/eval_plan.py) checks the files against the stream's
// header.  One launch on `stream`; returns the launch's error.
extern "C" int eval_plan(const int32_t* ops, uint32_t n_words, uint32_t* fp,
                         uint32_t* ext, const uint32_t* pm, uint32_t T,
                         void* stream) {
  if (n_words < HEAD) return (int)cudaErrorInvalidValue;
  if (T == 0 || n_words == HEAD) return 0;
  eval_plan_kernel<<<(T + BLOCK - 1) / BLOCK, BLOCK, 0,
                     (cudaStream_t)stream>>>(
      ops, n_words, fp, reinterpret_cast<uint4*>(ext),
      reinterpret_cast<const uint4*>(pm), T);
  return (int)cudaGetLastError();
}
