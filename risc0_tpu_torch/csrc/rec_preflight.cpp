// Recursion VM preflight on the host: one call interprets every code row of
// a recursion program.  A literal port of the Python interpreter in
// risc0_tpu_torch/circuit/recursion/preflight.py (itself a port of the
// reference risc0/circuit/recursion/src/prove/preflight.rs): the same
// write-once memory (WOM), IOP rows, per-cycle (iop_idx, par_safe), output
// words, checked-byte reads and collected EQ failures, bit for bit.
//
// Field values are standard-form BabyBear words; a WOM cell is four words
// (an F_p4 element, x^4 = -11).  Words read from the code or the WOM may be
// unreduced (a const is any u32): arithmetic reduces them first, compares
// and bit ops see them raw, as the Python does.
//
// Poseidon2 and SHA-256 constants come from the caller (the port's
// hash/poseidon2_consts.py and circuit/keccak/preflight.py).  Faults end
// the run with a status the caller raises as the Python exception class:
// 1 ValueError, 2 IndexError, 3 AssertionError.
//
// Built with the host C++ compiler alone (no CUDA) by
// risc0_tpu_torch/circuit/recursion/native.py and bound with ctypes.

#include <array>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

using u32 = uint32_t;
using u64 = uint64_t;
using Ext = std::array<u32, 4>;

constexpr u64 P = 2013265921u;        // 15 * 2^27 + 1
constexpr u64 R_MOD_P = 268435454u;   // 2^32 mod P (to Montgomery)
constexpr u64 R_INV = 943718400u;     // 2^-32 mod P (from Montgomery)
constexpr u64 NBETA = P - 11;
constexpr int CELLS = 24;
constexpr int CODE_SIZE = 23;
constexpr int CHECKED_COEFFS_PER_POLY = 16;

// CODE_LAYOUT offsets (reference layout.rs.inc:223-335)
constexpr int WRITE_ADDR = 0;
constexpr int SEL_MICRO = 1, SEL_MACRO = 2, SEL_P2_LOAD = 3, SEL_P2_FULL = 4,
              SEL_P2_PARTIAL = 5, SEL_P2_STORE = 6, SEL_CHECKED = 7;
constexpr int MICRO_INSTS[3][4] = {{8, 9, 10, 11}, {12, 13, 14, 15},
                                   {16, 17, 18, 19}};
constexpr int MAC_BIT_AND_ELEM = 11, MAC_BIT_OP_SHORTS = 12, MAC_SHA_INIT = 13,
              MAC_SHA_FINI = 14, MAC_SHA_LOAD = 15, MAC_SHA_MIX = 16;
constexpr int MACRO_OPERAND[3] = {18, 19, 20};
constexpr int P2_DO_MONT = 8, P2_KEEP_STATE = 9, P2_KEEP_UPPER = 10,
              P2_G1 = 13, P2_G2 = 14, P2_INPUTS = 15;
constexpr int CB_EVAL_POINT = 8, CB_KEEP_COEFFS = 9, CB_KEEP_UPPER = 10;

enum MicroOp : u32 {
  M_CONST, M_ADD, M_SUB, M_MUL, M_INV, M_EQ, M_READ_IOP_HEADER,
  M_READ_IOP_BODY, M_MIX_RNG, M_SELECT, M_EXTRACT
};

enum Status : int32_t { OK = 0, VALUE_ERROR = 1, INDEX_ERROR = 2,
                        ASSERTION_ERROR = 3 };

struct Fault {
  Status status;
  std::string message;
};

std::string ext_str(const Ext& v) {
  return "(" + std::to_string(v[0]) + ", " + std::to_string(v[1]) + ", " +
         std::to_string(v[2]) + ", " + std::to_string(v[3]) + ")";
}

u64 red(u64 x) { return x % P; }
u64 mulm(u64 a, u64 b) { return red(a) * red(b) % P; }

Ext eadd(const Ext& a, const Ext& b) {
  Ext r;
  for (int i = 0; i < 4; i++) r[i] = u32((red(a[i]) + red(b[i])) % P);
  return r;
}

Ext esub(const Ext& a, const Ext& b) {
  Ext r;
  for (int i = 0; i < 4; i++) r[i] = u32((red(a[i]) + P - red(b[i])) % P);
  return r;
}

Ext emul(const Ext& a, const Ext& b) {
  u64 a0 = red(a[0]), a1 = red(a[1]), a2 = red(a[2]), a3 = red(a[3]);
  u64 b0 = red(b[0]), b1 = red(b[1]), b2 = red(b[2]), b3 = red(b[3]);
  auto m = [](u64 x, u64 y) { return x * y % P; };
  Ext r;
  r[0] = u32((m(a0, b0) + m(NBETA, (m(a1, b3) + m(a2, b2) + m(a3, b1)) % P)) % P);
  r[1] = u32((m(a0, b1) + m(a1, b0) + m(NBETA, (m(a2, b3) + m(a3, b2)) % P)) % P);
  r[2] = u32((m(a0, b2) + m(a1, b1) + m(a2, b0) + m(NBETA, m(a3, b3))) % P);
  r[3] = u32((m(a0, b3) + m(a1, b2) + m(a2, b1) + m(a3, b0)) % P);
  return r;
}

u64 powm(u64 a, u64 e) {
  u64 r = 1;
  a = red(a);
  while (e) {
    if (e & 1) r = r * a % P;
    a = a * a % P;
    e >>= 1;
  }
  return r;
}

// F_p4 inverse by the composite-field method (field.py ext_inv_np, in
// standard form: the method commutes with the Montgomery encoding).
Ext einv(const Ext& a) {
  u64 a0 = red(a[0]), a1 = red(a[1]), a2 = red(a[2]), a3 = red(a[3]);
  auto m = [](u64 x, u64 y) { return x * y % P; };
  auto ad = [](u64 x, u64 y) { return (x + y) % P; };
  auto sb = [](u64 x, u64 y) { return (x + P - y) % P; };
  const u64 beta = 11;
  u64 b0 = ad(m(a0, a0), m(beta, sb(m(a1, ad(a3, a3)), m(a2, a2))));
  u64 b2 = ad(sb(m(a0, ad(a2, a2)), m(a1, a1)), m(beta, m(a3, a3)));
  u64 ic = powm(ad(m(b0, b0), m(beta, m(b2, b2))), P - 2);
  b0 = m(b0, ic);
  b2 = m(b2, ic);
  Ext r;
  r[0] = u32(ad(m(a0, b0), m(beta, m(a2, b2))));
  r[1] = u32(ad(m(sb(0, a1), b0), m(NBETA, m(a3, b2))));
  r[2] = u32(ad(m(sb(0, a0), b2), m(a2, b0)));
  r[3] = u32(sb(m(a1, b2), m(a3, b0)));
  return r;
}

u32 bswap32(u32 x) {
  return (x & 0xFF) << 24 | (x & 0xFF00) << 8 | (x >> 8 & 0xFF00) | x >> 24;
}

u32 rotr(u32 x, int n) { return x >> n | x << (32 - n); }

struct Consts {
  const u32* p2_rc;    // rounds x 24, standard form
  const u32* p2_diag;  // 24
  u32 rounds_half_full;
  u32 rounds_partial;
  const u32* sha_init;  // 8
  const u32* sha_k;     // 64
};

// Poseidon2 (t = 24) on standard-form words, as hash/poseidon2.py
// _permute_std.
void m_ext(u64* c) {
  u64 out[CELLS];
  for (int blk = 0; blk < CELLS; blk += 4) {
    u64 c0 = c[blk], c1 = c[blk + 1], c2 = c[blk + 2], c3 = c[blk + 3];
    u64 t0 = c0 + c1, t1 = c2 + c3, t2 = 2 * c1 + t1, t3 = 2 * c3 + t0;
    u64 t4 = 4 * t1 + t3, t5 = 4 * t0 + t2;
    out[blk] = t3 + t5;
    out[blk + 1] = t5;
    out[blk + 2] = t2 + t4;
    out[blk + 3] = t4;
  }
  u64 sums[4] = {0, 0, 0, 0};
  for (int i = 0; i < CELLS; i++) sums[i % 4] += out[i];
  for (int i = 0; i < CELLS; i++) c[i] = (out[i] + sums[i % 4]) % P;
}

u64 sbox(u64 x) {
  u64 x2 = x * x % P;
  u64 x4 = x2 * x2 % P;
  return x4 * x2 % P * x % P;
}

void poseidon2_mix(u32* state, const Consts& k) {
  u64 c[CELLS];
  for (int i = 0; i < CELLS; i++) c[i] = state[i];
  m_ext(c);
  const u32 rounds = 2 * k.rounds_half_full + k.rounds_partial;
  for (u32 rnd = 0; rnd < rounds; rnd++) {
    const u32* rc = k.p2_rc + rnd * CELLS;
    if (rnd >= k.rounds_half_full &&
        rnd < k.rounds_half_full + k.rounds_partial) {
      c[0] = sbox((c[0] + rc[0]) % P);
      u64 total = 0;
      for (int i = 0; i < CELLS; i++) total += c[i];
      for (int i = 0; i < CELLS; i++)
        c[i] = (total + c[i] * k.p2_diag[i]) % P;
    } else {
      for (int i = 0; i < CELLS; i++) c[i] = sbox((c[i] + rc[i]) % P);
      m_ext(c);
    }
  }
  for (int i = 0; i < CELLS; i++) state[i] = u32(c[i]);
}

// SHA-256 compression of one block into `state` (keccak/preflight.py
// compute_sha_infos without its per-round records).
void sha_compress(u32* state, const u32* data, const u32* K) {
  u32 a = state[0], b = state[1], c = state[2], d = state[3];
  u32 e = state[4], f = state[5], g = state[6], h = state[7];
  u32 w[64];
  for (int i = 0; i < 64; i++) {
    if (i < 16) {
      w[i] = bswap32(data[i]);
    } else {
      u32 s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      u32 s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      w[i] = s1 + w[i - 7] + s0 + w[i - 16];
    }
    u32 e1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    u32 ch = (e & f) ^ (~e & g);
    u32 t1 = h + e1 + ch + K[i] + w[i];
    u32 e0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    u32 maj = (a & b) ^ (a & c) ^ (b & c);
    u32 t2 = e0 + maj;
    h = g; g = f; f = e;
    e = d + t1;
    d = c; c = b; b = a;
    a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

}  // namespace

extern "C" struct R0RecPreflight {
  int32_t status;
  char message[512];
  u64 rows_run;
  u64 input_used;
  const u32* wom;          // (n_wom, 4)
  u64 n_wom;
  const u32* iops;         // (n_iops, 4)
  u64 n_iops;
  const u32* iop_idx;      // rows_run
  const u32* par_safe;     // rows_run
  const u32* output;
  u64 n_output;
  const u32* byte_reads;   // (n_byte_reads, 5): cycle, four tape words
  u64 n_byte_reads;
  const u32* eq_failures;  // (n_eq_failures, 9): cycle, a[4], b[4]
  u64 n_eq_failures;
};

namespace {

class Vm {
 public:
  Vm(const u32* input, u64 n_input, bool eq_strict, const Consts& k)
      : input_(input), n_input_(n_input), eq_strict_(eq_strict), k_(k) {}

  std::vector<Ext> wom;
  std::vector<Ext> iops;
  std::vector<u32> iop_idx, par_safe, output, byte_reads, eq_failures;

  void run(const u32* code, u64 rows) {
    iop_idx.reserve(rows);
    par_safe.reserve(rows);
    for (u64 cycle = 0; cycle < rows; cycle++) {
      cycle_ = cycle;
      step(code + cycle * CODE_SIZE);
      iop_idx.push_back(cur_iop_idx_);
      par_safe.push_back(par_ ? 1 : 0);
      cur_iop_idx_ = u32(iops.size());
    }
  }

  u64 input_used() const { return pos_; }
  u64 cycle() const { return cycle_; }

 private:
  const u32* input_;
  u64 n_input_;
  u64 pos_ = 0;
  bool eq_strict_;
  const Consts k_;
  u64 cycle_ = 0;
  bool par_ = false;
  u32 cur_iop_idx_ = 0;
  u32 p2_state_[CELLS] = {};
  u32 sha_state_[8] = {};
  u32 sha_load_[16] = {};
  u32 sha_init_pos_ = 0, sha_load_pos_ = 0, sha_fini_pos_ = 0;
  std::unordered_map<u32, std::array<Ext, CHECKED_COEFFS_PER_POLY>> eval_pts_;
  std::vector<Ext> iop_body_;
  size_t iop_body_head_ = 0;

  [[noreturn]] void fail(Status s, const std::string& what) {
    throw Fault{s, what + " at cycle " + std::to_string(cycle_)};
  }

  u32 pop_input() {
    if (pos_ >= n_input_) fail(INDEX_ERROR, "input tape exhausted");
    return input_[pos_++];
  }

  // A WOM index as a Python list index: negative counts from the end.
  u64 index(int64_t addr) {
    int64_t n = int64_t(wom.size());
    if (addr < 0) addr += n;
    if (addr < 0 || addr >= n)
      fail(INDEX_ERROR, "WOM read of unwritten address " +
                            std::to_string(addr));
    return u64(addr);
  }

  const Ext& rd(int64_t addr) { return wom[index(addr)]; }

  void wr(int64_t addr, const Ext& val) {
    if (addr >= int64_t(wom.size())) wom.resize(u64(addr) + 1, Ext{0, 0, 0, 0});
    u64 i = index(addr);
    Ext& cur = wom[i];
    if (cur != Ext{0, 0, 0, 0} && cur != val)
      fail(VALUE_ERROR, "WOM " + std::to_string(addr) + " overwritten: " +
                            ext_str(val) + " over " + ext_str(cur));
    cur = val;
  }

  void step(const u32* code) {
    if (code[SEL_MACRO] == 1) par_ = macro_op(code);
    else if (code[SEL_MICRO] == 1) par_ = micro_ops(code);
    else if (code[SEL_CHECKED] == 1) par_ = checked_bytes(code);
    else if (code[SEL_P2_LOAD] == 1) par_ = poseidon2_load(code);
    else if (code[SEL_P2_FULL] == 1) par_ = false;
    else if (code[SEL_P2_PARTIAL] == 1) {
      poseidon2_mix(p2_state_, k_);
      par_ = false;
    } else if (code[SEL_P2_STORE] == 1) par_ = poseidon2_store(code);
    else fail(VALUE_ERROR, "illegal recursion op");
  }

  // -- iop ------------------------------------------------------------------
  void read_iop_header(u64 count, u64 k_flip) {
    u64 k = k_flip / 2;
    bool flip = k_flip & 1;
    if (iop_body_head_ != iop_body_.size())
      fail(ASSERTION_ERROR, "IOP header read before the last body ended");
    iop_body_.clear();
    iop_body_head_ = 0;
    if (k == 2) {
      for (u64 i = 0; i < count; i++) {
        u32 w = pop_input();
        iop_body_.push_back(Ext{w & 0xFFFF, w >> 16, 0, 0});
      }
      return;
    }
    u64 avail = n_input_ - pos_;
    if (k != 0 && count > avail / k) fail(INDEX_ERROR, "input tape exhausted");
    const u32* arr = input_ + pos_;
    pos_ += k * count;
    for (u64 i = 0; i < count; i++) {
      Ext poly{0, 0, 0, 0};
      for (u64 j = 0; j < k && j < 4; j++) {
        u64 raw = flip ? arr[i * k + j] : arr[j * count + i];
        poly[j] = u32(raw * R_INV % P);
      }
      iop_body_.push_back(poly);
    }
  }

  Ext read_iop_body(u32 do_mont) {
    if (iop_body_head_ >= iop_body_.size())
      fail(INDEX_ERROR, "IOP body read with no body left");
    Ext front = iop_body_[iop_body_head_++];
    if (do_mont != 0)
      for (auto& x : front) x = u32(u64(x) * R_MOD_P % P);
    return front;
  }

  // -- micro ops ------------------------------------------------------------
  bool micro_ops(const u32* code) {
    int64_t write_addr = code[WRITE_ADDR];
    bool par = true;
    for (int i = 0; i < 3; i++)
      par &= micro_op(code, write_addr + i, MICRO_INSTS[i]);
    return par;
  }

  bool micro_op(const u32* code, int64_t write_addr, const int* inst) {
    u32 opcode = code[inst[0]];
    u32 a0 = code[inst[1]], a1 = code[inst[2]], a2 = code[inst[3]];
    switch (opcode) {
      case M_CONST:
        wr(write_addr, Ext{a0, a1, 0, 0});
        return true;
      case M_ADD: {
        Ext a = rd(a0), b = rd(a1);
        wr(write_addr, eadd(a, b));
        if (a2 != 0) output.push_back(a[0]);
        return true;
      }
      case M_SUB: {
        Ext a = rd(a0), b = rd(a1);
        wr(write_addr, esub(a, b));
        return true;
      }
      case M_MUL: {
        Ext a = rd(a0), b = rd(a1);
        wr(write_addr, emul(a, b));
        return true;
      }
      case M_INV: {
        Ext a = rd(a0);
        if (a1 == 0) wr(write_addr, Ext{a[0] == 0 ? 1u : 0u, 0, 0, 0});
        else wr(write_addr, einv(a));
        return true;
      }
      case M_EQ: {
        Ext a = rd(a0), b = rd(a1);
        if (a != b) {
          if (eq_strict_)
            fail(VALUE_ERROR, "recursion EQ failed: " + ext_str(a) + " != " +
                                  ext_str(b));
          eq_failures.push_back(u32(cycle_));
          eq_failures.insert(eq_failures.end(), a.begin(), a.end());
          eq_failures.insert(eq_failures.end(), b.begin(), b.end());
        }
        return true;
      }
      case M_READ_IOP_HEADER:
        read_iop_header(a0, a1);
        return true;
      case M_READ_IOP_BODY: {
        Ext body = read_iop_body(a2);
        wr(write_addr, body);
        iops.push_back(body);
        return true;
      }
      case M_MIX_RNG: {
        u64 val = a2;
        bool par = true;
        if (a2 != 0) {
          val = val * rd(write_addr - 1)[0] % P;
          par = false;
        }
        Ext a = rd(a0), b = rd(a1);
        for (u64 elem : {u64(a[1]), u64(a[0]), u64(b[1]), u64(b[0])})
          val = (val * (1u << 16) + elem) % P;
        wr(write_addr, Ext{u32(val), 0, 0, 0});
        return par;
      }
      case M_SELECT: {
        Ext a = rd(a0);
        Ext val = rd(int64_t((red(a1) + mulm(a2, a[0])) % P));
        wr(write_addr, val);
        return true;
      }
      case M_EXTRACT: {
        Ext a = rd(a0);
        u64 b1 = red(a1), b2 = red(a2);
        u64 nb1 = (1 + P - b1) % P, nb2 = (1 + P - b2) % P;
        u64 val = (mulm(b1 * b2 % P, a[3]) + mulm(b1 * nb2 % P, a[2]) +
                   mulm(nb1 * b2 % P, a[1]) + mulm(nb1 * nb2 % P, a[0])) % P;
        wr(write_addr, Ext{u32(val), 0, 0, 0});
        return true;
      }
      default:
        fail(VALUE_ERROR, "unknown micro opcode " + std::to_string(opcode));
    }
  }

  // -- macro ops ------------------------------------------------------------
  bool macro_op(const u32* code) {
    u32 a0 = code[MACRO_OPERAND[0]], a2 = code[MACRO_OPERAND[2]];
    int64_t write_addr = code[WRITE_ADDR];
    if (code[MAC_BIT_AND_ELEM] == 1) {
      Ext a = rd(a0), b = rd(code[MACRO_OPERAND[1]]);
      wr(write_addr, Ext{a[0] & b[0], 0, 0, 0});
      return true;
    }
    if (code[MAC_BIT_OP_SHORTS] == 1) {
      Ext a = rd(a0), b = rd(code[MACRO_OPERAND[1]]);
      if (a2 != 0)
        wr(write_addr, Ext{(a[0] & b[0]) + ((a[1] & b[1]) << 16), 0, 0, 0});
      else
        wr(write_addr, Ext{a[0] ^ b[0], a[1] ^ b[1], 0, 0});
      return true;
    }
    if (code[MAC_SHA_INIT] == 1) {
      if (sha_init_pos_ == 0) std::memcpy(sha_state_, k_.sha_init, 32);
      sha_init_pos_ = (sha_init_pos_ + 1) % 4;
      return false;
    }
    if (code[MAC_SHA_LOAD] == 1) {
      Ext io0 = rd(a0);
      u32 val = a2 == 0 ? u32(u64(io0[0]) * R_MOD_P % P)
                        : u32(u64(io0[0]) + (u64(io0[1]) << 16));
      sha_load_[sha_load_pos_] = val;
      sha_load_pos_ = (sha_load_pos_ + 1) % 16;
      return false;
    }
    if (code[MAC_SHA_MIX] == 1) return false;
    if (code[MAC_SHA_FINI] == 1) {
      if (sha_fini_pos_ == 0) {
        sha_compress(sha_state_, sha_load_, k_.sha_k);
        int64_t out_addr = int64_t(a0) - 3;
        for (int i = 0; i < 8; i++) {
          u32 out = bswap32(sha_state_[i]);
          wr(out_addr + i, Ext{out & 0xFFFF, out >> 16, 0, 0});
        }
      }
      sha_fini_pos_ = (sha_fini_pos_ + 1) % 4;
      return false;
    }
    return true;  // nop / wom_init / wom_fini / set_global
  }

  // -- poseidon2 ------------------------------------------------------------
  u64 group_base(const u32* code) {
    u64 group = u64(code[P2_G1]) + u64(code[P2_G2]) * 2;
    if (group > 2) fail(INDEX_ERROR, "Poseidon2 group " + std::to_string(group));
    return group * 8;
  }

  bool poseidon2_load(const u32* code) {
    if (code[P2_KEEP_STATE] != 1) {
      int upto = code[P2_KEEP_UPPER] != 1 ? CELLS : 16;
      for (int i = 0; i < upto; i++) p2_state_[i] = 0;
    }
    u64 base = group_base(code);
    for (int i = 0; i < 8; i++) {
      u64 load = rd(code[P2_INPUTS + i])[0];
      if (code[P2_DO_MONT] != 0) load = load * R_INV % P;
      p2_state_[base + i] = u32((p2_state_[base + i] + load) % P);
    }
    return false;
  }

  bool poseidon2_store(const u32* code) {
    u64 base = group_base(code);
    int64_t write_addr = code[WRITE_ADDR];
    for (int i = 0; i < 8; i++) {
      u64 store = p2_state_[base + i];
      if (code[P2_DO_MONT] != 0) store = store * R_MOD_P % P;
      wr(write_addr + i, Ext{u32(store), 0, 0, 0});
    }
    return false;
  }

  // -- checked bytes --------------------------------------------------------
  bool checked_bytes(const u32* code) {
    for (int i = 0; i < 16; i++)
      p2_state_[i] = code[CB_KEEP_COEFFS] == 1
                         ? u32(u64(p2_state_[i]) * 256 % P) : 0;
    if (code[CB_KEEP_UPPER] != 1)
      for (int i = 16; i < CELLS; i++) p2_state_[i] = 0;

    u32 pt_addr = code[CB_EVAL_POINT];
    auto it = eval_pts_.find(pt_addr);
    if (it == eval_pts_.end()) {
      Ext pt = rd(pt_addr);
      std::array<Ext, CHECKED_COEFFS_PER_POLY> pows;
      pows[0] = Ext{1, 0, 0, 0};
      for (int i = 1; i < CHECKED_COEFFS_PER_POLY; i++)
        pows[i] = emul(pows[i - 1], pt);
      it = eval_pts_.emplace(pt_addr, pows).first;
    }
    const auto& pows = it->second;
    Ext evaluated{0, 0, 0, 0};
    byte_reads.push_back(u32(cycle_));
    for (int i = 0; i < 4; i++) {
      u32 word = pop_input();
      for (int j = 0; j < 4; j++) {
        u64 b = (word >> (8 * j)) & 0xFF;
        int idx = i * 4 + j;
        p2_state_[idx] = u32((p2_state_[idx] + b) % P);
        for (int c = 0; c < 4; c++)
          evaluated[c] = u32((evaluated[c] + pows[idx][c] * b % P) % P);
      }
      byte_reads.push_back(word);
    }
    wr(code[WRITE_ADDR], evaluated);
    return false;
  }
};

struct Result {
  R0RecPreflight out{};
  Vm* vm = nullptr;
};

}  // namespace

extern "C" {

// Interpret `rows` code rows (rows x 23 words) over the input tape.  Always
// returns a result; its status says whether the run ended in a fault.  Free
// it with r0_rec_preflight_free.
R0RecPreflight* r0_rec_preflight(const u32* code, u64 rows, const u32* input,
                                 u64 n_input, int32_t eq_strict,
                                 const u32* p2_rc, const u32* p2_diag,
                                 u32 rounds_half_full, u32 rounds_partial,
                                 const u32* sha_init, const u32* sha_k) {
  auto* res = new Result();
  Consts k{p2_rc, p2_diag, rounds_half_full, rounds_partial, sha_init, sha_k};
  Vm* vm = res->vm = new Vm(input, n_input, eq_strict != 0, k);
  R0RecPreflight& o = res->out;
  try {
    vm->run(code, rows);
  } catch (const Fault& f) {
    o.status = f.status;
    std::snprintf(o.message, sizeof o.message, "%s", f.message.c_str());
  } catch (const std::exception& e) {
    o.status = VALUE_ERROR;
    std::snprintf(o.message, sizeof o.message, "preflight failed: %s",
                  e.what());
  }
  o.rows_run = vm->iop_idx.size();
  o.input_used = vm->input_used();
  o.wom = vm->wom.empty() ? nullptr : vm->wom[0].data();
  o.n_wom = vm->wom.size();
  o.iops = vm->iops.empty() ? nullptr : vm->iops[0].data();
  o.n_iops = vm->iops.size();
  o.iop_idx = vm->iop_idx.data();
  o.par_safe = vm->par_safe.data();
  o.output = vm->output.data();
  o.n_output = vm->output.size();
  o.byte_reads = vm->byte_reads.data();
  o.n_byte_reads = vm->byte_reads.size() / 5;
  o.eq_failures = vm->eq_failures.data();
  o.n_eq_failures = vm->eq_failures.size() / 9;
  return &res->out;
}

void r0_rec_preflight_free(R0RecPreflight* out) {
  auto* res = reinterpret_cast<Result*>(out);
  delete res->vm;
  delete res;
}

}  // extern "C"
