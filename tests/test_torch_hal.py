"""Each op of risc0_tpu_torch.hal.torch_hal against risc0_tpu.hal.jnp_hal on
the same numpy inputs, at small sizes (n <= 2^8).  Field arithmetic is
exact, so every comparison is bit for bit; the chunked commit must equal
the fused one.

Every case runs the same inputs through both packages.  The jnp side
compiles for minutes on the CPU, so the tier-1 tests compare the port with
the jnp outputs saved in tests/data/torch_hal_reference.npz, and the live
comparison is marked slow.  Regenerate the file with

    JAX_PLATFORMS=cpu python tests/test_torch_hal.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from risc0_tpu_torch.convert import to_numpy, to_torch
from risc0_tpu_torch.hal import torch_hal as hal
from risc0_tpu_torch.prove.merkle import merkle_params

torch.set_num_threads(2)

P = 2013265921
SAVED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "torch_hal_reference.npz")


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint32)


def _jnp_hal():
    import jax.numpy as jnp

    from risc0_tpu.hal import jnp_hal

    return jnp, jnp_hal


def _np(xs):
    return [to_numpy(x) if isinstance(x, torch.Tensor)
            else np.asarray(x, np.uint32) for x in xs]


# Each case maps an implementation ("port" or "jax") to a list of numpy
# outputs computed from the same seeded inputs.

def case_commit(impl, encode=False):
    w = _rand(1, (3, 1 << 6))
    if impl == "port":
        c, e, layers = hal.commit_pipeline(w, encode=encode)
    else:
        jnp, rhal = _jnp_hal()
        c, e, layers = rhal.commit_pipeline(jnp.asarray(w), "poseidon2",
                                            encode=encode)
    return _np([c, e, *layers])


def case_commit_encode(impl):
    return case_commit(impl, encode=True)


def case_commit_chunked(impl):
    w = _rand(2, (5, 1 << 6))
    if impl == "port":
        c, e, layers = hal.commit_pipeline_chunked(w, encode=True,
                                                   chunk_cols=2)
    else:
        _, rhal = _jnp_hal()
        c, e, *layers = rhal._commit_pipeline_chunked_p2(w, encode=True,
                                                         chunk_cols=2)
    return _np([c, e, *layers])


def case_check_pipeline(impl):
    cp = _rand(4, (4, 1 << 8))
    if impl == "port":
        c, e, layers = hal.check_pipeline(to_torch(cp), 16)
    else:
        jnp, rhal = _jnp_hal()
        c, e, layers = rhal.check_pipeline(jnp.asarray(cp), "poseidon2", 16)
    return _np([c, e, *layers])


def case_merkle_layers(impl):
    m = _rand(5, (7, 1 << 5))
    if impl == "port":
        return _np(hal.merkle_layers(to_torch(m)))
    jnp, rhal = _jnp_hal()
    return _np(rhal.merkle_layers(jnp.asarray(m), "poseidon2"))


def case_evaluate_tap_groups(impl):
    n = 1 << 6
    groups = [_rand(6, (2, n)), _rand(7, (1, n)), _rand(8, (3, n))]
    group_ids = [0, 0, 1, 2, 2, 2, 2]
    cols = [0, 1, 0, 0, 2, 2, 1]
    backs = [0, 1, 0, 0, 1, 2, 0]
    xs = _rand(9, (3, 4))
    if impl == "port":
        return _np([hal.evaluate_tap_groups(
            [to_torch(g) for g in groups], group_ids, cols, backs, xs, backs,
            chunk=16)])
    jnp, rhal = _jnp_hal()
    return _np([rhal.evaluate_tap_groups(
        [jnp.asarray(g) for g in groups], group_ids, cols, backs, xs, backs,
        chunk=32)])


def case_batch_evaluate_any(impl):
    coeffs = _rand(10, (5, 1 << 6))
    which = [4, 0, 4, 2]
    xs = _rand(11, (4, 4))
    if impl == "port":
        return _np([hal.batch_evaluate_any(to_torch(coeffs), which, xs,
                                           chunk=16)])
    jnp, rhal = _jnp_hal()
    return _np([rhal.batch_evaluate_any(jnp.asarray(coeffs), which,
                                        jnp.asarray(xs), chunk=64)])


def case_mix_poly_coeffs(impl):
    n, count, combo_count = 1 << 6, 11, 3
    combos = _rand(12, (combo_count + 1, n, 4))
    mix_pows = _rand(13, (count, 4))
    inp = _rand(14, (count, n))
    which = [0, 1, 1, 3, 0, 0, 1, 3, 3, 0, 1]  # combo 2 has no members
    if impl == "port":
        return _np([hal.mix_poly_coeffs(to_torch(combos), mix_pows,
                                        to_torch(inp), which, combo_count,
                                        block=2)])
    jnp, rhal = _jnp_hal()
    return _np([rhal.mix_poly_coeffs(jnp.asarray(combos),
                                     jnp.asarray(mix_pows), jnp.asarray(inp),
                                     which, combo_count)])


def _combos_inputs():
    m, n = 4, 1 << 6
    combos = _rand(15, (m, n, 4))
    zs = _rand(17, (2, m, 4))
    active = np.array([[1, 1, 0, 1], [0, 1, 0, 1]], bool)
    zs[~active] = 0
    zs[~active, 0] = 268435454  # Montgomery ONE for inactive rows
    return combos, _rand(16, (m, 3, 4)), zs, active, _rand(18, 4)


def case_combos(impl):
    combos, corr, zs, active, z_check = _combos_inputs()
    if impl == "port":
        head = hal.combos_subtract_head(to_torch(combos), corr)
        div, rems = hal.combos_divide(to_torch(combos), zs, active, z_check)
        total = hal.eltwise_sum_extelem(to_torch(combos))
    else:
        jnp, rhal = _jnp_hal()
        head = rhal.combos_subtract_head(jnp.asarray(combos),
                                         jnp.asarray(corr))
        div, rems = rhal.combos_divide(jnp.asarray(combos), jnp.asarray(zs),
                                       jnp.asarray(active),
                                       jnp.asarray(z_check))
        total = rhal.eltwise_sum_extelem(jnp.asarray(combos))
    return _np([head, div, rems, total])


def case_fri_fold(impl):
    planar = _rand(19, (4, 16 * 32))
    mix = _rand(20, 4)
    if impl == "port":
        return _np([hal.fri_fold(to_torch(planar), mix)])
    jnp, rhal = _jnp_hal()
    return _np([rhal.fri_fold(jnp.asarray(planar), jnp.asarray(mix))])


def case_make_coeffs_expand(impl):
    w = _rand(21, (3, 1 << 6))
    out = []
    for zk in (True, False):
        if impl == "port":
            c = hal.make_coeffs(to_torch(w), zk)
            out += [c, hal.expand_evaluate(c, 2)]
        else:
            jnp, rhal = _jnp_hal()
            c = rhal.make_coeffs(jnp.asarray(w), zk_shift=zk)
            out += [c, rhal.expand_evaluate(c, 2)]
    return _np(out)


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def _saved(name):
    with np.load(SAVED) as z:
        keys = sorted((k for k in z.files if k.split("/")[0] == name),
                      key=lambda k: int(k.split("/")[1]))
        return [z[k] for k in keys]


def _same(got, want):
    return len(got) == len(want) and all(
        g.shape == w.shape and np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_saved_jnp_output(name):
    assert _same(CASES[name]("port"), _saved(name))


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_live_jnp_hal(name):
    assert _same(CASES[name]("port"), CASES[name]("jax"))


def test_chunked_commit_equals_fused():
    w = _rand(2, (5, 1 << 6))
    fused = hal.commit_pipeline(w, encode=True)
    chunked = hal.commit_pipeline_chunked(w, encode=True, chunk_cols=2)
    assert all(torch.equal(a, b) for a, b in zip(fused[:2], chunked[:2]))
    assert all(torch.equal(a, b) for a, b in zip(fused[2], chunked[2]))


def test_large_groups_take_the_chunked_path(monkeypatch):
    calls = []
    orig = hal.commit_pipeline_chunked

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(hal, "commit_pipeline_chunked", spy)
    monkeypatch.setattr(hal, "COMMIT_CHUNK_BYTES", 1 << 10)
    hal.commit_pipeline(_rand(3, (2, 1 << 6)))  # 2 KiB evaluated
    assert calls == [1]


def test_commit_leaves_caller_witness_untouched():
    w = _rand(22, (2, 1 << 6))
    before = w.copy()
    hal.commit_pipeline(w, encode=True)
    assert np.array_equal(w, before)


def test_merkle_params():
    assert merkle_params(1 << 10, 50) == (10, 32)
    assert merkle_params(1 << 4, 50) == (4, 8)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = {f"{name}/{i}": a for name, fn in CASES.items()
           for i, a in enumerate(fn("jax"))}
    np.savez_compressed(SAVED, **out)
    print(f"wrote {len(out)} arrays to {SAVED}", file=sys.stderr)
