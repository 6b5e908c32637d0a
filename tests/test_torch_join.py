"""The port's join operators against the JAX operators they replace.

Every input is made with numpy from a seed and handed to both the JAX
function (``gpu_olap_tpu/ops/join.py``; its streaming join runs the Pallas
kernels in interpret mode) and its torch counterpart on the CPU.  All
outputs are integers or masks and must agree exactly.  Where both sides
define the element order (the build sort, the tagged co-sort of the
streaming join, match expansion), they must agree element for element;
where JAX leaves ties to an unstable sort (payloads riding
``probe_counts_sorted``), per-run multisets are compared instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_olap_tpu.ops import join as jj
from gpu_olap_tpu_torch.ops import join as tj

I32_MAX = (1 << 31) - 1


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _j(a):
    return jnp.asarray(a)


def _eq(got, exp, n=None):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    e = np.asarray(exp)
    if n is not None:
        g, e = g[:n], e[:n]
    assert g.shape == e.shape, (g.shape, e.shape)
    np.testing.assert_array_equal(g.astype(np.int64), e.astype(np.int64))


def _side(rng, n, lo, hi, dtype, null_p=0.05, invalid_p=0.05):
    """(codes, null flags, row validity): duplicate-heavy keys in [lo, hi)."""
    codes = rng.integers(lo, hi, n).astype(dtype)
    null = rng.random(n) < null_p
    valid = rng.random(n) >= invalid_p
    return codes, null, valid


# ---------------------------------------------------------------------------
# densify, build, probe
# ---------------------------------------------------------------------------

def test_densify_keys_matches_jax():
    rng = np.random.default_rng(1)
    l1, ln1, lv = _side(rng, 700, 0, 20, np.int64)
    l2 = rng.integers(-3, 3, 700).astype(np.float64)
    ln2 = rng.random(700) < 0.05
    r1, rn1, rv = _side(rng, 500, 5, 25, np.int64)
    r2 = rng.integers(-3, 3, 500).astype(np.float64)
    rn2 = rng.random(500) < 0.05
    exp = jj.densify_keys([(_j(l1), _j(ln1)), (_j(l2), _j(ln2))], _j(lv),
                          [(_j(r1), _j(rn1)), (_j(r2), _j(rn2))], _j(rv))
    got = tj.densify_keys([(_t(l1), _t(ln1)), (_t(l2), _t(ln2))], _t(lv),
                          [(_t(r1), _t(rn1)), (_t(r2), _t(rn2))], _t(rv))
    for g, e in zip(got, exp):
        _eq(g, e)


@pytest.mark.parametrize("presorted", [False, True])
def test_build_sorted_matches_jax(presorted):
    rng = np.random.default_rng(2)
    nb = 900
    code = rng.integers(-50, 50, nb).astype(np.int32)
    inv = rng.random(nb) < 0.1
    if presorted:  # sorted keys, invalid rows only at the tail
        code = np.sort(code)
        inv = np.arange(nb) >= nb - 37
    exp = jj.build_sorted(_j(code), _j(inv), presorted=presorted)
    got = tj.build_sorted(_t(code), _t(inv), presorted=presorted)
    for g, e in zip(got, exp):
        _eq(g, e)


# (build dtype, fold_range): the int32-fold, int64-fold and tag branches
PROBE_BRANCHES = {
    "i32_fold": (np.int32, (-40, 60)),
    "i64_fold": (np.int32, None),
    "tag": (np.int64, None),
}


def _probe_inputs(branch, seed):
    dtype, fold = PROBE_BRANCHES[branch]
    rng = np.random.default_rng(seed)
    bc, bn, bv = _side(rng, 800, -40, 50, dtype)
    pc, pn, pv = _side(rng, 1100, -30, 60, dtype)
    return bc, bn | ~bv, pc, pn | ~pv, fold


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_probe_counts_matches_jax(dtype):
    """The streamed join's binary-search probe: probe keys below, inside
    and above the build range, nulls and invalid rows on both sides."""
    rng = np.random.default_rng(21)
    bc, bn, bv = _side(rng, 600, -40, 50, dtype)
    pc, pn, pv = _side(rng, 900, -60, 70, dtype)
    bsk = jj.build_sorted(_j(bc), _j(bn | ~bv))
    tsk = tj.build_sorted(_t(bc), _t(bn | ~bv))
    exp = jj.probe_counts(bsk[0], bsk[2], _j(pc), _j(pn | ~pv))
    got = tj.probe_counts(tsk[0], tsk[2], _t(pc), _t(pn | ~pv))
    for g, e in zip(got, exp):
        _eq(g, e)
    assert int(got[1].sum()) > 0


@pytest.mark.parametrize("bounds", [(-40, 49), (-10, 20)])
def test_direct_probe_matches_jax(bounds):
    """The dense offset-table probe; the narrower ``bounds`` leave build
    keys outside the table, which never match."""
    kmin, kmax = bounds
    rng = np.random.default_rng(22)
    bc, bn, bv = _side(rng, 600, -40, 50, np.int64)
    pc, pn, pv = _side(rng, 900, -60, 70, np.int64)
    bsk = jj.build_sorted(_j(bc), _j(bn | ~bv))
    tsk = tj.build_sorted(_t(bc), _t(bn | ~bv))
    exp = jj.direct_probe(bsk[0], bsk[1], bsk[2], kmin, kmax, _j(pc),
                          _j(pn | ~pv))
    got = tj.direct_probe(tsk[0], tsk[2], kmin, kmax, _t(pc), _t(pn | ~pv))
    for g, e in zip(got, exp):
        _eq(g, e)
    assert int(got[1].sum()) > 0


@pytest.mark.parametrize("branch", sorted(PROBE_BRANCHES))
def test_probe_ranges_merge_matches_jax(branch):
    bc, binv, pc, pinv, fold = _probe_inputs(branch, 3)
    exp = jj.probe_ranges_merge(_j(bc), _j(binv), _j(pc), _j(pinv),
                                fold_range=fold)
    got = tj.probe_ranges_merge(_t(bc), _t(binv), _t(pc), _t(pinv),
                                fold_range=fold)
    for g, e in zip(got, exp):
        _eq(g, e)


@pytest.mark.parametrize("branch", sorted(PROBE_BRANCHES))
def test_probe_counts_sorted_matches_jax(branch):
    bc, binv, pc, pinv, fold = _probe_inputs(branch, 4)
    rng = np.random.default_rng(5)
    n = len(bc) + len(pc)
    pays = [rng.integers(-1000, 1000, n).astype(np.int32),
            rng.normal(size=n)]
    exp = jj.probe_counts_sorted(_j(bc), _j(binv), _j(pc), _j(pinv),
                                 fold_range=fold,
                                 payloads=tuple(_j(p) for p in pays))
    got = tj.probe_counts_sorted(_t(bc), _t(binv), _t(pc), _t(pinv),
                                 fold_range=fold,
                                 payloads=tuple(_t(p) for p in pays))
    # probe_ok, key_sorted, cnt_elem, build_ok, pcnt_elem: equal elements
    # share all five, so the unstable JAX sort leaves them element-equal
    for g, e in zip(got[:5], exp[:5]):
        _eq(g, e)
    key = np.asarray(exp[1]).astype(np.int64)
    pok, bok = np.asarray(exp[0]), np.asarray(exp[3])
    for g, e in zip(got[5], exp[5]):
        g, e = g.numpy(), np.asarray(e)
        og = np.lexsort((g, bok, pok, key))
        oe = np.lexsort((e, bok, pok, key))
        np.testing.assert_array_equal(g[og], e[oe])  # per-run multisets


@pytest.mark.parametrize("over", [False, True])
def test_expand_matches_matches_jax(over):
    bc, binv, pc, pinv, fold = _probe_inputs("i32_fold", 6)
    _sk, srow, _n = jj.build_sorted(_j(bc), _j(binv))
    lo, cnt = jj.probe_ranges_merge(_j(bc), _j(binv), _j(pc), _j(pinv),
                                    fold_range=fold)
    total = int(np.asarray(cnt).sum())
    cap = total // 2 if over else total + 100
    exp = jj.expand_matches(cnt, lo, srow, cap)
    got = tj.expand_matches(_t(np.asarray(cnt)), _t(np.asarray(lo)),
                            _t(np.asarray(srow)), cap)
    k = min(total, cap)
    for g, e in zip(got[:3], exp[:3]):
        _eq(g, e, k)
    assert int(got[3]) == int(exp[3]) == total
    assert bool(got[4]) == bool(exp[4]) == over


# ---------------------------------------------------------------------------
# dense lookup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("probe_dtype", [np.int32, np.int64])
def test_dense_lookup_matches_jax(probe_dtype):
    rng = np.random.default_rng(7)
    kmin, kmax = -20, 479
    bc = (rng.permutation(kmax - kmin + 1)[:300] + kmin).astype(np.int64)
    binv = rng.random(300) < 0.05
    pc = rng.integers(kmin - 30, kmax + 30, 2000).astype(probe_dtype)
    pinv = rng.random(2000) < 0.05
    args_j = (_j(bc), _j(binv), kmin, kmax, _j(pc), _j(pinv))
    args_t = (_t(bc), _t(binv), kmin, kmax, _t(pc), _t(pinv))
    for g, e in zip(tj.dense_probe(kmin, kmax, _t(pc), _t(pinv)),
                    jj.dense_probe(kmin, kmax, _j(pc), _j(pinv))):
        _eq(g, e)
    for g, e in zip(tj.lookup_slots(*args_t), jj.lookup_slots(*args_j)):
        _eq(g, e)
    for g, e in zip(tj.lookup_join(*args_t), jj.lookup_join(*args_j)):
        _eq(g, e)


def test_lookup_slots_duplicate_keys_take_first_row():
    """Outside the lookup join's unique-key contract both still agree: a
    repeated key's slot holds its smallest build row."""
    rng = np.random.default_rng(8)
    bc = rng.integers(0, 50, 400).astype(np.int32)
    binv = rng.random(400) < 0.1
    pc = rng.integers(0, 50, 100).astype(np.int32)
    pinv = np.zeros(100, bool)
    got = tj.lookup_slots(_t(bc), _t(binv), 0, 49, _t(pc), _t(pinv))
    exp = jj.lookup_slots(_j(bc), _j(binv), 0, 49, _j(pc), _j(pinv))
    for g, e in zip(got, exp):
        _eq(g, e)


# ---------------------------------------------------------------------------
# inner join, outer extension
# ---------------------------------------------------------------------------

def _join_inputs(kind, seed):
    """(left_keys, lrv, right_keys, rrv, fold, presorted) as numpy."""
    rng = np.random.default_rng(seed)
    if kind == "multi_key":
        l1, ln1, lv = _side(rng, 600, 0, 15, np.int64)
        l2, ln2, _ = _side(rng, 600, 0, 3, np.int64)
        r1, rn1, rv = _side(rng, 400, 5, 20, np.int64)
        r2, rn2, _ = _side(rng, 400, 0, 3, np.int64)
        return [(l1, ln1), (l2, ln2)], lv, [(r1, rn1), (r2, rn2)], rv, \
            None, False
    if kind == "presorted":
        lc, ln, lv = _side(rng, 700, 0, 60, np.int32)
        rc = np.sort(rng.integers(0, 60, 300)).astype(np.int32)
        return [(lc, ln)], lv, [(rc, np.zeros(300, bool))], None, \
            (0, 59), True
    lc, ln, lv = _side(rng, 700, 0, 60, np.int32)
    rc, rn, rv = _side(rng, 500, 10, 70, np.int32)
    return [(lc, ln)], lv, [(rc, rn)], rv, (0, 69), False


def _conv(keys, rv, f):
    return [(f(c), f(n)) for c, n in keys], None if rv is None else f(rv)


def _run_inner(kind, cap_of_total, seed=9):
    lkeys, lrv, rkeys, rrv, fold, pre = _join_inputs(kind, seed)
    jl, jlrv = _conv(lkeys, lrv, _j)
    jr, jrrv = _conv(rkeys, rrv, _j)
    tl, tlrv = _conv(lkeys, lrv, _t)
    tr, trrv = _conv(rkeys, rrv, _t)
    probe = jj.inner_join(jl, jlrv, jr, jrrv, 1, fold_range=fold,
                          build_presorted=pre)
    cap = cap_of_total(int(probe[3]))
    exp = jj.inner_join(jl, jlrv, jr, jrrv, cap, fold_range=fold,
                        build_presorted=pre)
    got = tj.inner_join(tl, tlrv, tr, trrv, cap, fold_range=fold,
                        build_presorted=pre)
    return got, exp, cap, (lrv, rrv, len(lkeys[0][0]), len(rkeys[0][0]))


@pytest.mark.parametrize("kind", ["single_fold", "multi_key", "presorted"])
def test_inner_join_matches_jax_element_for_element(kind):
    got, exp, cap, _ = _run_inner(kind, lambda total: total + 50)
    total = int(exp[3])
    assert int(got[3]) == total and total > 0
    assert bool(got[4]) == bool(exp[4]) is False
    for g, e in zip(got[:3], exp[:3]):  # li, ri, out_valid
        _eq(g, e, total)
    _eq(got[2], exp[2])  # out_valid over the whole buffer
    _eq(got[5], exp[5])  # per-probe-row match counts


@pytest.mark.parametrize("join_type", ["left", "right", "full"])
def test_outer_extend_matches_jax(join_type):
    got, exp, cap, (lrv, rrv, nl, nr) = _run_inner(
        "single_fold", lambda total: total + 50)
    ej = jj.outer_extend(join_type, exp[0], exp[1], exp[2], exp[3], exp[5],
                         _j(lrv), None if rrv is None else _j(rrv), nl, nr)
    et = tj.outer_extend(join_type, got[0], got[1], got[2], got[3], got[5],
                         _t(lrv), None if rrv is None else _t(rrv), nl, nr)
    valid = np.asarray(ej[2])
    _eq(et[2], ej[2])
    assert int(et[3]) == int(ej[3])
    for g, e in zip(et[:2], ej[:2]):  # li, ri on every valid slot
        np.testing.assert_array_equal(g.numpy()[valid], np.asarray(e)[valid])


def test_compact_rows_matches_jax():
    flag = np.random.default_rng(10).random(777) < 0.3
    for g, e in zip(tj._compact_rows(_t(flag)), jj._compact_rows(_j(flag))):
        _eq(g, e)


# ---------------------------------------------------------------------------
# the streaming join (stream_compact + expand_fill)
# ---------------------------------------------------------------------------

STREAM_CASES = {
    # (payloads, emit_key, need_ri, capacity = f(total))
    "payloads_key_ri": (2, True, True, lambda t: t + 777),
    "bare": (0, False, False, lambda t: t + 1),
    "overflow": (1, True, True, lambda t: t // 3),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_inner_join_stream_matches_jax_element_for_element(case):
    n_pay, emit_key, need_ri, cap_of = STREAM_CASES[case]
    rng = np.random.default_rng(11)
    lc, ln, lv = _side(rng, 2500, 0, 900, np.int32)
    rc, rn, rv = _side(rng, 3000, 100, 1000, np.int32)
    linv, rinv = ln | ~lv, rn | ~rv
    pays = [rng.integers(-(1 << 31), 1 << 31, 2500).astype(np.int32)
            for _ in range(n_pay)]
    fold = (0, 999)
    _lo, cnt = jj.probe_ranges_merge(_j(rc), _j(rinv), _j(lc), _j(linv),
                                     fold_range=fold)
    total = int(np.asarray(cnt).sum())
    cap = cap_of(total)
    exp = jj.inner_join_stream(_j(lc), _j(linv), _j(rc), _j(rinv), cap, fold,
                               probe_payloads=[_j(p) for p in pays],
                               emit_key=emit_key, need_ri=need_ri,
                               interpret=True)
    got = tj.inner_join_stream(_t(lc), _t(linv), _t(rc), _t(rinv), cap, fold,
                               probe_payloads=[_t(p) for p in pays],
                               emit_key=emit_key, need_ri=need_ri)
    assert int(got["total"]) == int(exp["total"]) == total
    assert bool(got["overflow"]) == bool(exp["overflow"]) == (total > cap)
    k = min(total, cap)
    assert got["li"].shape == (cap,)
    _eq(got["li"], exp["li"], k)
    _eq(got["out_valid"], exp["out_valid"], cap)
    for name in ("key", "ri"):
        assert (got[name] is None) == (exp[name] is None)
        if got[name] is not None:
            _eq(got[name], exp[name], k)
    assert len(got["payloads"]) == len(exp["payloads"]) == n_pay
    for g, e in zip(got["payloads"], exp["payloads"]):
        _eq(g, e, k)
