"""Groth16 setup and prover over BN254, in-process (counterpart of
``risc0_tpu/groth16/prove.py``).

The reference proves its stark_verify circuit with rapidsnark inside docker
(risc0/groth16/src/prove/docker.rs:34-75) against the public ceremony CRS;
here both CRS generation (a single-party "dev ceremony" — documented as
such; a multi-party ceremony is out of scope) and proving run natively via
csrc/bn254.cpp.  Proofs verify with the existing pairing-based
`groth16.verifier.Verifier`, and receipts carry the generated verifying
key through `Groth16ReceiptVerifierParameters.verifying_key`.

QAP construction follows the Groth16 paper with the usual extra input rows
(one per public input, A[m+i][i] = 1) so the public-input polynomials are
linearly independent (same trick as bellman/snarkjs).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import numpy as np

from . import native as nat
from .bn254 import G1_GEN, G2_GEN
from .native import Q, fr_arr, fr_list, limbs
from .r1cs import CS, ConstraintError
from .verifier import VerifyingKey


def _root_of_unity(n: int) -> int:
    """Primitive n-th root of unity in Fr (5 generates Fr^*)."""
    if n & (n - 1) or (Q - 1) % n:
        raise ValueError(f"no Fr root of unity of order {n}")
    return pow(5, (Q - 1) // n, Q)


@dataclass
class ProvingKey:
    n: int                    # QAP domain size
    num_public: int
    num_vars: int
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    a_g1: np.ndarray          # (num_vars, 8)  [u_i(tau)]_1
    b_g1: np.ndarray          # (num_vars, 8)  [v_i(tau)]_1
    b_g2: np.ndarray          # (num_vars, 16) [v_i(tau)]_2
    l_g1: np.ndarray          # (num_vars - num_public - 1, 8) aux L queries
    h_g1: np.ndarray          # (n - 1, 8)     [tau^j Z(tau)/delta]_1
    structure: bytes          # circuit structure digest
    # COO matrices (for witness-side evaluations at prove time)
    coo: tuple | None = None

    def save(self, path: str):
        np.savez_compressed(
            path, n=self.n, num_public=self.num_public,
            num_vars=self.num_vars,
            alpha_g1=nat.g1_arr([self.alpha_g1]),
            beta_g1=nat.g1_arr([self.beta_g1]),
            beta_g2=nat.g2_arr([self.beta_g2]),
            delta_g1=nat.g1_arr([self.delta_g1]),
            delta_g2=nat.g2_arr([self.delta_g2]),
            a_g1=self.a_g1, b_g1=self.b_g1, b_g2=self.b_g2,
            l_g1=self.l_g1, h_g1=self.h_g1,
            structure=np.frombuffer(self.structure, np.uint8))

    @staticmethod
    def load(path: str) -> "ProvingKey":
        z = np.load(path)
        return ProvingKey(
            n=int(z["n"]), num_public=int(z["num_public"]),
            num_vars=int(z["num_vars"]),
            alpha_g1=nat.g1_from_arr(z["alpha_g1"])[0],
            beta_g1=nat.g1_from_arr(z["beta_g1"])[0],
            beta_g2=nat.g2_from_arr(z["beta_g2"])[0],
            delta_g1=nat.g1_from_arr(z["delta_g1"])[0],
            delta_g2=nat.g2_from_arr(z["delta_g2"])[0],
            a_g1=z["a_g1"], b_g1=z["b_g1"], b_g2=z["b_g2"],
            l_g1=z["l_g1"], h_g1=z["h_g1"],
            structure=bytes(z["structure"].tobytes()))


def _qap_scalars(cs: CS, tau: int):
    """Evaluate u_i(tau), v_i(tau), w_i(tau) for every variable.

    Returns three Montgomery (num_vars, 4) arrays.  Domain rows are the m
    constraints plus num_public+1 input rows appended to A.
    """
    m = cs.num_constraints
    npub = cs.num_public
    M = m + npub + 1
    n = 1
    while n < M:
        n <<= 1
    omega = _root_of_unity(n)

    # L_j(tau) = Z(tau)/n * omega^j / (tau - omega^j), Montgomery form
    lib = nat.lib()
    pows = np.empty((n, 4), np.uint64)
    lib.bn254_fr_powers(limbs(omega * (1 << 256) % Q), pows, n)
    tau_m = limbs(tau * (1 << 256) % Q)
    tau_arr = np.empty((n, 4), np.uint64)
    ones = np.empty((n, 4), np.uint64)
    lib.bn254_fr_powers(limbs(1 * (1 << 256) % Q), ones, n)
    lib.bn254_fr_vec_scale(ones, tau_m, tau_arr, n)
    diff = np.empty((n, 4), np.uint64)
    lib.bn254_fr_vec_sub(tau_arr, pows, diff, n)
    lib.bn254_fr_batch_inv(diff, n)
    L = np.empty((n, 4), np.uint64)
    lib.bn254_fr_vec_mul(diff, pows, L, n)
    z_tau = (pow(tau, n, Q) - 1) % Q
    n_inv = pow(n, Q - 2, Q)
    lib.bn254_fr_vec_scale(L, limbs(z_tau * n_inv % Q * (1 << 256) % Q), L, n)

    (ar, ac, av), (br, bc, bv), (cr, cc, cv) = cs.coo()
    nv = cs.num_vars
    u = np.zeros((nv, 4), np.uint64)
    v = np.zeros((nv, 4), np.uint64)
    w = np.zeros((nv, 4), np.uint64)
    lib.bn254_fr_qap(ar, ac, np.ascontiguousarray(av), len(ar), L, u)
    lib.bn254_fr_qap(br, bc, np.ascontiguousarray(bv), len(br), L, v)
    lib.bn254_fr_qap(cr, cc, np.ascontiguousarray(cv), len(cr), L, w)
    # extra input rows (A[m+i][i] = 1) are folded in by the caller using
    # canonical-int arithmetic over fr_list(L)
    return n, z_tau, u, v, w, L, m


def setup(cs: CS, n_threads: int = 0, rng=None) -> tuple[ProvingKey,
                                                          VerifyingKey]:
    """Generate a Groth16 CRS for the circuit (single-party dev ceremony:
    the toxic waste is sampled in-process and dropped)."""
    rnd = rng or (lambda: secrets.randbelow(Q - 1) + 1)
    tau, alpha, beta, gamma, delta = (rnd() for _ in range(5))

    n, z_tau, u_m, v_m, w_m, L, m = _qap_scalars(cs, tau)
    npub = cs.num_public
    nv = cs.num_vars

    u = fr_list(u_m)
    v = fr_list(v_m)
    w = fr_list(w_m)
    # extra input rows (A only): u_i += L_{m+i}(tau)
    Lj = fr_list(L)
    for i in range(npub + 1):
        u[i] = (u[i] + Lj[m + i]) % Q

    gamma_inv = pow(gamma, Q - 2, Q)
    delta_inv = pow(delta, Q - 2, Q)

    # per-variable scalar tables
    ic_s = [(beta * u[i] + alpha * v[i] + w[i]) * gamma_inv % Q
            for i in range(npub + 1)]
    l_s = [(beta * u[i] + alpha * v[i] + w[i]) * delta_inv % Q
           for i in range(npub + 1, nv)]
    # H basis scalars: tau^j * Z(tau) / delta
    h_s = [pow(tau, j, Q) * z_tau % Q * delta_inv % Q for j in range(n - 1)]

    a_g1 = nat.g1_fixed_msm(G1_GEN, u, n_threads)
    b_g1 = nat.g1_fixed_msm(G1_GEN, v, n_threads)
    b_g2 = nat.g2_fixed_msm(G2_GEN, v, n_threads)
    l_g1 = nat.g1_fixed_msm(G1_GEN, l_s, n_threads)
    h_g1 = nat.g1_fixed_msm(G1_GEN, h_s, n_threads)
    ic_g1 = nat.g1_fixed_msm(G1_GEN, ic_s, n_threads)

    from .bn254 import g1_mul

    def g2_mul(k):
        out = np.zeros(16, np.uint64)
        nat.lib().bn254_g2_mul(nat.g2_arr([G2_GEN])[0], limbs(k), out)
        return nat.g2_from_arr(out)[0]

    pk = ProvingKey(
        n=n, num_public=npub, num_vars=nv,
        alpha_g1=g1_mul(G1_GEN, alpha),
        beta_g1=g1_mul(G1_GEN, beta), beta_g2=g2_mul(beta),
        delta_g1=g1_mul(G1_GEN, delta), delta_g2=g2_mul(delta),
        a_g1=a_g1, b_g1=b_g1, b_g2=b_g2, l_g1=l_g1, h_g1=h_g1,
        structure=cs.structure_digest(), coo=cs.coo())
    vk = VerifyingKey(
        alpha_g1=pk.alpha_g1, beta_g2=pk.beta_g2,
        gamma_g2=g2_mul(gamma), delta_g2=pk.delta_g2,
        ic=nat.g1_from_arr(ic_g1))
    return pk, vk


def _witness_evals(pk: ProvingKey, cs: CS):
    """Evaluate <A,w>, <B,w>, <C,w> over the n-point domain (Montgomery)."""
    lib = nat.lib()
    n = pk.n
    m = cs.num_constraints
    npub = cs.num_public
    w_m = fr_arr(cs.values)
    evals = []
    coo = pk.coo if pk.coo is not None else cs.coo()
    for (rows, cols, coeffs) in coo:
        out = np.zeros((n, 4), np.uint64)
        lib.bn254_fr_spmv(rows, cols, np.ascontiguousarray(coeffs),
                          len(rows), w_m, out)
        evals.append(out)
    # extra input rows on A: value = w_i
    for i in range(npub + 1):
        evals[0][m + i] = w_m[i]
    return evals


def _h_coeffs(pk: ProvingKey, evals) -> list[int]:
    """h(X) = (a(X) b(X) - c(X)) / Z(X) via coset FFTs."""
    lib = nat.lib()
    n = pk.n
    omega = _root_of_unity(n)
    g = 5  # coset shift (any non-residue w.r.t. the domain works)
    g_pows = np.empty((n, 4), np.uint64)
    lib.bn254_fr_powers(limbs(g * (1 << 256) % Q), g_pows, n)
    coset_vals = []
    for e in evals:
        c = np.ascontiguousarray(e.copy())
        nat.fr_ntt(c, omega, inverse=True)          # coeffs
        lib.bn254_fr_vec_mul(c, g_pows, c, n)       # shift to coset
        nat.fr_ntt(c, omega)                        # evals on coset
        coset_vals.append(c)
    ab = np.empty((n, 4), np.uint64)
    lib.bn254_fr_vec_mul(coset_vals[0], coset_vals[1], ab, n)
    lib.bn254_fr_vec_sub(ab, coset_vals[2], ab, n)
    z_coset_inv = pow((pow(g, n, Q) - 1) % Q, Q - 2, Q)
    lib.bn254_fr_vec_scale(ab, limbs(z_coset_inv * (1 << 256) % Q), ab, n)
    nat.fr_ntt(ab, omega, inverse=True)             # coeffs of h on coset
    ginv_pows = np.empty((n, 4), np.uint64)
    lib.bn254_fr_powers(limbs(pow(g, Q - 2, Q) * (1 << 256) % Q),
                        ginv_pows, n)
    lib.bn254_fr_vec_mul(ab, ginv_pows, ab, n)      # undo coset shift
    h = fr_list(ab)
    if h[n - 1] != 0:
        raise ConstraintError("h degree overflow (QAP inconsistency)")
    return h[: n - 1]


def prove(pk: ProvingKey, cs: CS, n_threads: int = 0, rng=None) -> dict:
    """Groth16 prove; returns a snarkjs-style proof dict (decimal strings),
    compatible with seal_to_json.proof_json_to_seal and Verifier.from_json."""
    if pk.structure != cs.structure_digest():
        raise ValueError("proving key does not match circuit")
    if cs.check is False:
        # witness sanity even when per-constraint checking was off
        pass
    rnd = rng or (lambda: secrets.randbelow(Q))
    r, s = rnd(), rnd()

    evals = _witness_evals(pk, cs)
    h = _h_coeffs(pk, evals)
    wvals = cs.values

    from .bn254 import g1_add, g1_mul, g1_neg

    def g2_add(p, q):
        out = np.zeros(16, np.uint64)
        nat.lib().bn254_g2_add(nat.g2_arr([p])[0], nat.g2_arr([q])[0], out)
        return nat.g2_from_arr(out)[0]

    def g2_mul_pt(p, k):
        out = np.zeros(16, np.uint64)
        nat.lib().bn254_g2_mul(nat.g2_arr([p])[0], limbs(k), out)
        return nat.g2_from_arr(out)[0]

    # pi_A = alpha + sum w_i A_i + r delta
    sum_a = nat.g1_msm(pk.a_g1, wvals, n_threads)
    pi_a = g1_add(g1_add(pk.alpha_g1, sum_a), g1_mul(pk.delta_g1, r))
    # pi_B (G2) and its G1 mirror
    sum_b2 = nat.g2_msm(pk.b_g2, wvals, n_threads)
    pi_b = g2_add(g2_add(pk.beta_g2, sum_b2), g2_mul_pt(pk.delta_g2, s))
    sum_b1 = nat.g1_msm(pk.b_g1, wvals, n_threads)
    pi_b1 = g1_add(g1_add(pk.beta_g1, sum_b1), g1_mul(pk.delta_g1, s))
    # pi_C = sum_aux w_i L_i + sum h_j H_j + s pi_A + r pi_B1 - rs delta
    aux = wvals[pk.num_public + 1:]
    sum_l = nat.g1_msm(pk.l_g1, aux, n_threads)
    sum_h = nat.g1_msm(pk.h_g1, h, n_threads)
    pi_c = g1_add(sum_l, sum_h)
    for term in (g1_mul(pi_a, s), g1_mul(pi_b1, r),
                 g1_neg(g1_mul(pk.delta_g1, r * s % Q))):
        pi_c = g1_add(pi_c, term)

    return {
        "pi_a": [str(pi_a[0]), str(pi_a[1]), "1"],
        "pi_b": [[str(pi_b[0][0]), str(pi_b[0][1])],
                 [str(pi_b[1][0]), str(pi_b[1][1])], ["1", "0"]],
        "pi_c": [str(pi_c[0]), str(pi_c[1]), "1"],
        "protocol": "groth16",
        "curve": "bn128",
        "public": [str(v) for v in wvals[1: pk.num_public + 1]],
    }
