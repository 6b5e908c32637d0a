"""The port's operators against the JAX operators they replace.

Every input is made with numpy from a seed and handed to both the JAX
function and its torch counterpart (run on the CPU).  Integers, masks and
permutations must agree exactly; float aggregates within ``rtol=1e-12``
(sums are taken in another order) and ``atol=1e-12`` (for sums near zero).
A grouped float SUM or AVG that misses JAX's (which takes each group's sum
as a difference of one prefix sum over every group, and so turns a group
after an infinity into NaN) is held instead to ``math.fsum`` of each
group's own values within ``n_g * 2**-52 * sum(|x_g|)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus as corpus
from gpu_olap_tpu.ops import aggregate as jagg
from gpu_olap_tpu.ops import dtypes as jdt
from gpu_olap_tpu.ops import filter as jfilt
from gpu_olap_tpu.ops import sort as jsort
from gpu_olap_tpu_torch.ops import aggregate as tagg
from gpu_olap_tpu_torch.ops import dtypes as tdt
from gpu_olap_tpu_torch.ops import filter as tfilt
from gpu_olap_tpu_torch.ops import sort as tsort

CPU = torch.device("cpu")
RTOL = ATOL = 1e-12


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


def _same(got, exp):
    g, e = _np(got), _np(exp)
    assert g.shape == e.shape, (g.shape, e.shape)
    if g.dtype.kind == "f" or e.dtype.kind == "f":
        np.testing.assert_allclose(g.astype(np.float64), e.astype(np.float64),
                                   rtol=RTOL, atol=ATOL, equal_nan=True)
    else:
        np.testing.assert_array_equal(g.astype(np.int64), e.astype(np.int64))


def _floats(rng, n):
    f = rng.normal(size=n) * 100
    f[rng.random(n) < 0.1] = np.nan
    f[rng.random(n) < 0.1] = -0.0
    f[rng.random(n) < 0.1] = 0.0
    f[rng.random(n) < 0.05] = np.inf
    return f


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

def test_order_code_matches_jax():
    rng = np.random.default_rng(1)
    i64 = rng.integers(-1000, 1000, 500)
    i64[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).min + 1,
               np.iinfo(np.int64).max, np.iinfo(np.int64).max - 1]
    i32 = rng.integers(-1000, 1000, 500).astype(np.int32)
    i32[:4] = [np.iinfo(np.int32).min, np.iinfo(np.int32).min + 1,
               np.iinfo(np.int32).max, np.iinfo(np.int32).max - 1]
    for data, kind in ((i64, "i"), (i32, "i"), (_floats(rng, 500), "f")):
        got = tdt.order_code(torch.from_numpy(data), kind)
        exp = jdt.order_code(jnp.asarray(data), kind)
        assert got.numpy().dtype == np.asarray(exp).dtype
        _same(got, exp)  # int clip by 2 on both widths


@pytest.mark.parametrize("with_validity", [False, True])
def test_key_code_matches_jax(with_validity):
    rng = np.random.default_rng(2)
    f = _floats(rng, 400)
    i = rng.integers(-50, 50, 400)
    valid = rng.random(400) < 0.8 if with_validity else None
    for data, kind in ((f, "f"), (i, "i")):
        tv = None if valid is None else torch.from_numpy(valid)
        jv = None if valid is None else jnp.asarray(valid)
        gc, gn = tdt.key_code(torch.from_numpy(data), tv, kind)
        ec, en = jdt.key_code(jnp.asarray(data), jv, kind)
        _same(gn, en)
        # -0.0 == 0.0 and NaN is a null key: codes agree bit for bit
        np.testing.assert_array_equal(
            gc.numpy().view(np.int64), np.asarray(ec).view(np.int64))


def test_key_fill_top_and_masked_fill_match_jax():
    for t, n in ((torch.int32, np.int32), (torch.int64, np.int64),
                 (torch.float64, np.float64)):
        assert tdt.key_fill(t) == jdt.key_fill(n)
        assert tdt.key_top(t) == jdt.key_top(n)
    rng = np.random.default_rng(3)
    d = rng.integers(0, 9, 100)
    m = rng.random(100) < 0.5
    _same(tdt.masked_fill(torch.from_numpy(d), torch.from_numpy(m), -7),
          jdt.masked_fill(jnp.asarray(d), jnp.asarray(m), -7))


# ---------------------------------------------------------------------------
# filter
# ---------------------------------------------------------------------------

def test_filter_helpers_match_jax():
    rng = np.random.default_rng(4)
    n = 1000
    pred = rng.integers(0, 3, n)
    pv = rng.random(n) < 0.9
    rv = rng.random(n) < 0.7
    for row_valid, pvalid in ((None, None), (rv, None), (None, pv), (rv, pv)):
        got = tfilt.combine_mask(
            None if row_valid is None else torch.from_numpy(row_valid),
            torch.from_numpy(pred),
            None if pvalid is None else torch.from_numpy(pvalid))
        exp = jfilt.combine_mask(
            None if row_valid is None else jnp.asarray(row_valid),
            jnp.asarray(pred), None if pvalid is None else jnp.asarray(pvalid))
        _same(got, exp)
    gi, gc = tfilt.compaction_indices(torch.from_numpy(rv))
    ei, ec = jfilt.compaction_indices(jnp.asarray(rv))
    _same(gi, ei)  # stable: masked-in rows first, both halves in order
    assert int(gc) == int(ec)
    data = rng.normal(size=n)
    _same(tfilt.compact_column(torch.from_numpy(data), gi, gc),
          jfilt.compact_column(jnp.asarray(data), ei, ec))


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------

def _sort_keys(spec, n, rng):
    """Equivalent JAX and torch ORDER BY key lists from (kind, asc,
    nulls_last, nullable) tuples."""
    jk, tk = [], []
    for kind, asc, nulls_last, nullable in spec:
        if kind == "f":
            data = _floats(rng, n)
        elif kind == "i32":
            data = rng.integers(-5, 5, n).astype(np.int32)
        else:
            data = rng.integers(-5, 5, n)
        npk = "f" if kind == "f" else "i"
        nulls = (rng.random(n) < 0.2) if nullable else None
        jk.append({"codes": jdt.order_code(jnp.asarray(data), npk),
                   "nulls": None if nulls is None else jnp.asarray(nulls),
                   "ascending": asc, "nulls_last": nulls_last})
        tk.append({"codes": tdt.order_code(torch.from_numpy(data), npk),
                   "nulls": None if nulls is None else torch.from_numpy(nulls),
                   "ascending": asc, "nulls_last": nulls_last})
    return jk, tk


SORT_SPECS = {
    "float_asc_nan_negzero": [("f", True, True, False)],
    "float_desc_nan_negzero": [("f", False, True, False)],
    "int_desc_nulls_first": [("i64", False, False, True)],
    "multi_nulls_last": [("i32", True, True, True), ("f", False, True, True),
                         ("i64", True, False, False)],
    "multi_desc_nulls_first": [("i64", False, False, True),
                               ("f", True, False, True)],
}


@pytest.mark.parametrize("name", sorted(SORT_SPECS))
@pytest.mark.parametrize("masked", [False, True])
def test_order_by_permutation_matches_jax(name, masked):
    rng = np.random.default_rng(5)
    n = 600
    jk, tk = _sort_keys(SORT_SPECS[name], n, rng)
    rv = (rng.random(n) < 0.8) if masked else None
    got = tsort.order_by_permutation(
        tk, None if rv is None else torch.from_numpy(rv), n)
    exp = jsort.order_by_permutation(
        jk, None if rv is None else jnp.asarray(rv), n)
    _same(got, exp)  # ties keep input order on both sides


@pytest.mark.parametrize("name", ["int_desc_ties", "float_asc"])
def test_top_k_permutation_matches_jax(name):
    rng = np.random.default_rng(6)
    n = 500
    if name == "int_desc_ties":
        # one descending key, no nulls, no mask: the top-k branch; ties
        # keep input order as lax.top_k keeps them
        spec = [("i64", False, True, False)]
    else:
        spec = [("f", True, True, False)]
    jk, tk = _sort_keys(spec, n, rng)
    for k in (1, 37, n):
        _same(tsort.top_k_permutation(tk, None, n, k),
              jsort.top_k_permutation(jk, None, n, k))


LEXSORT_CASES = {
    # two int32 keys: the packed-int64 path (biased low word, negatives)
    "packed_i32_pair": ([("i32", -(1 << 31), (1 << 31) - 1),
                         ("i32", -(1 << 31), (1 << 31) - 1)], 0),
    "packed_pair_with_payload": ([("i32", -9, 9), ("i32", -3, 3)], 1),
    "mixed_widths_float": ([("i32", -4, 4), ("i64", -3, 3), ("f", 0, 0)], 1),
    "single_float": ([("f", 0, 0)], 0),
}


@pytest.mark.parametrize("name", sorted(LEXSORT_CASES))
def test_lexsort_matches_lax_sort(name):
    keys_spec, n_payload = LEXSORT_CASES[name]
    rng = np.random.default_rng(7)
    n = 3000
    ops = []
    for kind, lo, hi in keys_spec:
        if kind == "f":
            ops.append(_floats(rng, n))
        else:
            ops.append(rng.integers(lo, hi, n, endpoint=True).astype(
                np.int32 if kind == "i32" else np.int64))
    ops += [rng.normal(size=n) for _ in range(n_payload)]
    # the row index as the last key makes lax.sort's order total, so the
    # payloads must agree too
    full = ops[:len(keys_spec)] + [np.arange(n, dtype=np.int32)] \
        + ops[len(keys_spec):]
    exp = jax.lax.sort(tuple(jnp.asarray(o) for o in full),
                       num_keys=len(keys_spec) + 1)
    got = tsort.lexsort([torch.from_numpy(o) for o in ops], len(keys_spec))
    exp = list(exp[:len(keys_spec)]) + list(exp[len(keys_spec) + 1:])
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        _same(g, e)
    perm = tsort.lexsort_permutation([torch.from_numpy(o)
                                      for o in ops[:len(keys_spec)]])
    _same(perm, full[len(keys_spec)][np.asarray(
        jax.lax.sort(tuple(jnp.asarray(o) for o in full[:len(keys_spec) + 1]),
                     num_keys=len(keys_spec) + 1)[-1])])


# ---------------------------------------------------------------------------
# grouped and global aggregation
# ---------------------------------------------------------------------------

def _agg_inputs(case, rng):
    """Numpy description of one groupby_aggregate call:
    (keys [(code, null|None)], row_valid, specs, max_groups, prefix_rows)."""
    n = 8192
    if case in ("seg_ride", "seg_payload", "seg_count_only", "seg_overflow"):
        k = rng.integers(0, 700, n).astype(np.int32)
        v = rng.integers(-100_000, 100_000, n)
        keys = [(k, None)]
        if case == "seg_ride":
            specs = [("count", None, None, False), ("sum", v, None, False),
                     ("min", v, None, False), ("max", v, None, False),
                     ("avg", v, None, False)]
        elif case == "seg_payload":
            specs = [("sum", v, None, False), ("count", None, None, False)]
        else:
            specs = [("count", None, None, False)]
        mg = 300 if case == "seg_overflow" else 1024
        return keys, None, specs, mg, None
    if case == "general_nulls_mask":
        k1 = rng.integers(-30, 30, n)
        k1n = rng.random(n) < 0.05
        f = _floats(rng, n)
        fv = ~np.isnan(f) & (rng.random(n) < 0.9)
        w = rng.integers(0, 50, n)
        rv = rng.random(n) < 0.8
        specs = [("count", None, None, False), ("count", f, fv, False),
                 ("sum", f, fv, False), ("avg", f, fv, False),
                 ("min", w, None, False), ("max", f, fv, False),
                 ("count", w, None, True), ("sum", w, None, True),
                 ("avg", w, None, True)]
        return [(k1, k1n)], rv, specs, 128, None
    if case == "multi_key_prefix":
        a = rng.integers(0, 5, n)
        b = rng.integers(-3, 3, n).astype(np.int32)
        v = rng.integers(-9, 9, n)
        specs = [("sum", v, None, False), ("min", v, None, False),
                 ("count", None, None, False)]
        return [(a, None), (b, None)], None, specs, 64, n - 1000
    if case in MASKED_CASES:
        # three keys with null lanes, as a star join's dimension columns
        # carry them; every routing of an aggregate: COUNT(*), COUNT(x),
        # integer and float SUM, AVG, the primary MIN and what rides it, a
        # fallback MAX, COUNT and SUM DISTINCT
        k1 = rng.integers(-30, 30, n)
        k2 = rng.integers(0, 4, n).astype(np.int32)
        k3 = rng.choice([-1.5, 0.0, 2.25], n)
        i = rng.integers(-1000, 1000, n)
        iv = rng.random(n) < 0.8
        f = _floats(rng, n)
        fv = ~np.isnan(f) & (rng.random(n) < 0.9)
        w = rng.integers(0, 50, n)
        rv = rng.random(n) < MASKED_CASES[case]
        rv[n // 3] |= case == "masked_one_row"
        specs = [("count", None, None, False), ("count", f, fv, False),
                 ("sum", i, iv, False), ("sum", f, fv, False),
                 ("avg", f, fv, False), ("min", w, None, False),
                 ("avg", w, None, False), ("max", f, fv, False),
                 ("count", w, None, True), ("sum", i, iv, True)]
        keys = [(k1, rng.random(n) < 0.05), (k2, rng.random(n) < 0.1),
                (k3, rng.random(n) < 0.05)]
        return keys, rv, specs, 2048, None
    if case in ("seg_masked_sparse", "seg_masked_few"):
        # the seg_agg shape under a mask that keeps more (sparse) or fewer
        # (few) rows than the kernel's MIN_ROWS
        n = 65536 if case == "seg_masked_sparse" else n
        k = rng.integers(0, 700, n).astype(np.int32)
        v = rng.integers(-100_000, 100_000, n)
        rv = rng.random(n) < 0.05
        specs = [("sum", v, None, False), ("count", None, None, False)]
        return [(k, None)], rv, specs, 1024, None
    raise KeyError(case)


#: masked cases of the general path, each with the share of rows its mask
#: keeps at random (``masked_one_row`` keeps the one row ``n // 3``)
MASKED_CASES = {"masked_sparse": 0.005, "masked_no_row": 0.0,
                "masked_one_row": 0.0, "masked_dense": 0.99}


_ACC = {"count": np.dtype(np.int64), "avg": np.dtype(np.float64)}


def _specs_for(specs, to_arr, int32_ok):
    out = []
    for func, vals, valid, distinct in specs:
        if vals is None:
            out.append({"func": func, "values": None, "valid": None,
                        "distinct": distinct, "acc_dtype": _ACC["count"]})
            continue
        kind = "f" if vals.dtype.kind == "f" else "i"
        acc = _ACC.get(func, np.dtype(np.float64) if kind == "f"
                       else np.dtype(np.int64))
        out.append({"func": func, "values": to_arr(vals),
                    "valid": None if valid is None else to_arr(valid),
                    "distinct": distinct, "acc_dtype": acc, "np_kind": kind,
                    "int32_ok": int32_ok and kind == "i",
                    "arg_id": id(vals)})
    return out


def _run_both(case, allow_kernel):
    rng = np.random.default_rng(8)
    keys, rv, specs, mg, prefix = _agg_inputs(case, rng)
    n = len(keys[0][0])
    jout = jagg.groupby_aggregate(
        [(jnp.asarray(c), None if m is None else jnp.asarray(m))
         for c, m in keys],
        None if rv is None else jnp.asarray(rv),
        _specs_for(specs, jnp.asarray, True), mg, n_rows=n,
        prefix_rows=prefix, allow_pallas=allow_kernel)
    if prefix is not None:
        # the port has no prefix_rows: the same rows arrive as a plain mask
        rv = np.arange(n) < prefix
    tout = tagg.groupby_aggregate(
        [(torch.from_numpy(c), None if m is None else torch.from_numpy(m))
         for c, m in keys],
        None if rv is None else torch.from_numpy(rv),
        _specs_for(specs, torch.from_numpy, True), mg, n_rows=n,
        allow_kernel=allow_kernel, device=CPU)
    return jout, tout, mg


@pytest.mark.parametrize("case", ["seg_ride", "seg_payload", "seg_count_only",
                                  "seg_overflow", "general_nulls_mask",
                                  "multi_key_prefix", *MASKED_CASES,
                                  "seg_masked_sparse", "seg_masked_few"])
@pytest.mark.parametrize("allow_kernel", [True, False])
def test_groupby_aggregate_matches_jax(case, allow_kernel, interpret_mode):
    (jcodes, jres, jng, jovf), (tcodes, tres, tng, tovf), mg = \
        _run_both(case, allow_kernel)
    assert int(tng) == int(jng)
    assert bool(tovf) == bool(jovf)
    if bool(jovf):
        return  # the executor regrows; padded outputs are not read
    ng = int(jng)
    for (gc, gn), (ec, en) in zip(tcodes, jcodes):
        _same(gc[:ng], ec[:ng])
        assert (gn is None) == (en is None)
        if gn is not None:
            _same(gn[:ng], en[:ng])
    keys, rv, specs, _, _ = _agg_inputs(case, np.random.default_rng(8))
    for (gd, gv), (ed, ev), spec in zip(tres, jres, specs):
        assert (gv is None) == (ev is None)
        try:
            _same(gd[:ng], ed[:ng])
        except AssertionError as e:
            if spec[0] not in ("sum", "avg") or gd.dtype != torch.float64:
                raise
            # JAX's group sums are differences of one prefix sum, the
            # port's each group's own: hold the port to math.fsum
            _own_group_sums(gd[:ng], tcodes, keys, rv, spec,
                            f"JAX gave {_np(ed[:ng])!r}: {e}")
        if gv is not None:
            _same(gv[:ng], ev[:ng])


def _own_group_sums(got, codes, keys, rv, spec, jax_note):
    """Each group's float SUM/AVG within ``n_g * 2**-52 * sum(|x_g|)`` of
    ``math.fsum`` of its valid values (AVG: over their count), the groups
    read from the port's key outputs (held to JAX's separately)."""
    func, vals, valid, distinct = spec
    n = len(keys[0][0])
    ok = np.ones(n, bool) if rv is None else rv.copy()
    if valid is not None:
        ok &= valid
    for g, x in enumerate(_np(got)):
        rows = ok.copy()
        for (code, null), (kc, kn) in zip(keys, codes):
            # the raw codes of NULL keys still part their groups here
            rows &= code == _np(kc)[g]
            if null is not None:
                rows &= null == bool(kn[g])
        v = vals[rows].astype(np.float64)
        if distinct:
            v = np.unique(v)
        exp, bound = corpus.own_sum(v)
        if func == "avg":
            exp, bound = exp / max(len(v), 1), bound / max(len(v), 1)
        if np.isfinite(exp):
            assert abs(x - exp) <= bound, (g, x, exp, bound, jax_note)
        else:
            assert x == exp or (np.isnan(x) and np.isnan(exp)), (
                g, x, exp, jax_note)


def test_seg_agg_path_engages_on_hot_shapes():
    from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS

    for case in ("seg_ride", "seg_payload", "seg_count_only"):
        before = GLOBAL_METRICS.counters.get("torch_seg_agg_path", 0)
        rng = np.random.default_rng(8)
        keys, rv, specs, mg, prefix = _agg_inputs(case, rng)
        tagg.groupby_aggregate(
            [(torch.from_numpy(c), None) for c, _ in keys], None,
            _specs_for(specs, torch.from_numpy, True), mg, device=CPU)
        assert GLOBAL_METRICS.counters.get("torch_seg_agg_path", 0) > before


@pytest.mark.parametrize("case, seg_agg", [
    ("masked_sparse", 0), ("masked_no_row", 0), ("seg_masked_sparse", 1),
    ("seg_masked_few", 0), ("seg_ride", 1)])
def test_groupby_compaction_counts_rows(case, seg_agg):
    """A masked call counts itself, the rows it was handed and the rows its
    mask kept, and writes both on the open span; a call without a mask
    counts none of them.  The seg_agg path takes the kept rows alone."""
    from gpu_olap_tpu_torch.utils import tracing
    from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS

    names = ("torch_groupby_compact", "torch_groupby_rows_in",
             "torch_groupby_rows_kept", "torch_seg_agg_path")
    keys, rv, specs, mg, _ = _agg_inputs(case, np.random.default_rng(8))
    before = GLOBAL_METRICS.snapshot()
    with tracing.record() as rec:
        with tracing.span(tracing.get_logger(__name__), "aggregate"):
            tagg.groupby_aggregate(
                [(torch.from_numpy(c), None if m is None
                  else torch.from_numpy(m)) for c, m in keys],
                None if rv is None else torch.from_numpy(rv),
                _specs_for(specs, torch.from_numpy, True), mg, device=CPU)
    after = GLOBAL_METRICS.snapshot()
    got = [after.get(k, 0) - before.get(k, 0) for k in names]
    (span,) = rec.spans
    if rv is None:
        assert got == [0, 0, 0, seg_agg]
        assert "rows_in" not in span.fields
        return
    n, kept = len(rv), int(rv.sum())
    assert got == [1, n, kept, seg_agg]
    assert span.fields == {"rows_in": n, "rows_kept": kept}


@pytest.mark.parametrize("masked", [False, True])
def test_global_aggregate_matches_jax(masked):
    rng = np.random.default_rng(9)
    n = 5000
    f = _floats(rng, n)
    f[np.isinf(f)] = 1.5
    fv = ~np.isnan(f)
    i = rng.integers(-1000, 1000, n)
    iv = rng.random(n) < 0.7
    rv = (rng.random(n) < 0.6) if masked else None
    specs = [("count", None, None, False), ("count", i, iv, False),
             ("sum", i, iv, False), ("sum", f, fv, False),
             ("avg", f, fv, False), ("min", i, iv, False),
             ("max", f, fv, False), ("count", i, None, True),
             ("sum", i, iv, True), ("avg", f, fv, True)]
    _, jres, jng, _ = jagg._global_aggregate(
        _specs_for(specs, jnp.asarray, False),
        None if rv is None else jnp.asarray(rv), n)
    _, tres, tng, _ = tagg._global_aggregate(
        _specs_for(specs, torch.from_numpy, False),
        None if rv is None else torch.from_numpy(rv), n, CPU)
    assert int(tng) == int(jng) == 1
    for (gd, gv), (ed, ev) in zip(tres, jres):
        assert (gv is None) == (ev is None)
        _same(gd, ed)
        if gv is not None:
            _same(gv, ev)
