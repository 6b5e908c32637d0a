"""The port's kernels against the Pallas kernels they replace.

Inputs are made with numpy from a seed and go through both: the Pallas
kernel in interpret mode (as ``test_pallas_kernels.py`` runs it) and the
port's wrapper on CPU tensors, which runs the kernel's plain PyTorch
version.  Results are integers and must agree exactly.  The ``cuda``-marked
twins run the CUDA kernels against the plain versions on a GPU and skip
without one; they need no JAX, so on a GPU machine without it they run as
``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``.
"""

import zlib

import numpy as np
import pytest
import torch

from gpu_olap_tpu_torch.ops.kernels import _build
from gpu_olap_tpu_torch.ops.kernels import filter_agg as tfa
from gpu_olap_tpu_torch.ops.kernels import seg_agg as tsa

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


@pytest.fixture
def interpret_mode():
    """The JAX kernels' own test setting: Pallas in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# filter_agg
# ---------------------------------------------------------------------------

def _filter_case(name):
    """(filt, op, thr, cols, alias, n_valid, wants) as numpy; ``alias[i]``
    makes column i the filter column itself."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n = 70_000
    v = rng.integers(0, 1000, n).astype(np.int32)
    w = rng.integers(-50_000, 50_000, n).astype(np.int32)
    if name.startswith("op_"):
        return v, name[3:], 500, (v, w), (True, False), n, None
    if name == "alias_only":
        return v, "gt", 500, (v,), (True,), n, None
    if name == "n_valid_straddle":
        return v, "ge", 100, (v, w), (True, False), n - 4321, None
    if name == "empty_match":
        return v, "gt", 5000, (v, w), (True, False), n, None
    if name == "sum16":
        # |v| < 2^15: the shape where the TPU kernel takes its one-reduce sum
        s = rng.integers(-(1 << 15) + 1, 1 << 15, n).astype(np.int32)
        return s, "lt", 0, (s, w), (True, False), n, \
            ((True, True, True), (True, False, False))
    if name == "int32_extremes":
        e = rng.integers(I32_MIN, I32_MAX, n, endpoint=True).astype(np.int32)
        e[:500] = I32_MAX
        e[500:1000] = I32_MIN
        return e, "ne", 0, (e, w), (True, False), n, None
    if name == "wants_dropped":
        return w, "gt", 0, (v, w), (False, True), n, \
            ((True, False), (False, True))
    raise KeyError(name)


FILTER_CASES = ["op_gt", "op_ge", "op_lt", "op_le", "op_eq", "op_ne",
                "alias_only", "n_valid_straddle", "empty_match", "sum16",
                "int32_extremes", "wants_dropped"]


def _torch_filter(f, op, thr, cols, alias, n_valid, wants, device):
    ft = torch.from_numpy(f).to(device)
    ct = tuple(ft if a else torch.from_numpy(c).to(device)
               for c, a in zip(cols, alias))
    return tfa.filter_agg_i32(ft, op, thr, ct, n_valid, wants)


def _as_ints(out):
    count, per_col = out
    return int(count), [tuple(int(x) for x in t) for t in per_col]


@pytest.mark.parametrize("case", FILTER_CASES)
def test_filter_agg_plain_matches_pallas(case, interpret_mode):
    import jax

    from gpu_olap_tpu.ops.pallas import filter_agg as jfa

    f, op, thr, cols, alias, n_valid, wants = _filter_case(case)
    jf = jax.numpy.asarray(f)
    jcols = tuple(jf if a else jax.numpy.asarray(c)
                  for c, a in zip(cols, alias))
    exp = jfa.filter_agg_i32(jf, op, thr, jcols, len(cols), True, n_valid,
                             wants)
    got = _torch_filter(f, op, thr, cols, alias, n_valid, wants, "cpu")
    assert _as_ints(got) == _as_ints(exp)  # integers: exact


def test_filter_agg_plain_sentinels_when_nothing_matches():
    v = torch.arange(1000, dtype=torch.int32)
    count, ((s, mn, mx),) = tfa.filter_agg_i32(v, "lt", -5, (v,))
    assert (int(count), int(s), int(mn), int(mx)) == (0, 0, I32_MAX, I32_MIN)


def test_filter_agg_rejects_bad_inputs():
    v = torch.arange(10, dtype=torch.int32)
    launches = _build.launches["filter_agg"]
    with pytest.raises(ValueError):
        tfa.filter_agg_i32(v.to(torch.int64), "gt", 0, ())
    with pytest.raises(ValueError):
        tfa.filter_agg_i32(v, "between", 0, (v,))
    with pytest.raises(ValueError):
        tfa.filter_agg_i32(v, "gt", 0, (v[:5],))
    with pytest.raises(ValueError):
        tfa.filter_agg_i32(v, "gt", 0, (v,), n_valid=11)
    assert _build.launches["filter_agg"] == launches  # CPU tensors never launch


@pytest.mark.cuda
@pytest.mark.parametrize("case", FILTER_CASES)
def test_filter_agg_cuda_matches_plain(case):
    dev = _cuda_device()
    f, op, thr, cols, alias, n_valid, wants = _filter_case(case)
    got = _torch_filter(f, op, thr, cols, alias, n_valid, wants, dev)
    exp = _torch_filter(f, op, thr, cols, alias, n_valid, wants, "cpu")
    torch.cuda.synchronize()
    assert _as_ints(got) == _as_ints(exp)


@pytest.mark.cuda
def test_filter_agg_cuda_counts_only_real_launches():
    dev = _cuda_device()
    v = torch.arange(1000, dtype=torch.int32, device=dev)
    launches = _build.launches["filter_agg"]
    count, ((s, mn, mx),) = tfa.filter_agg_i32(v, "gt", 0, (v,), n_valid=0)
    assert (int(count), int(s), int(mn), int(mx)) == (0, 0, I32_MAX, I32_MIN)
    assert _build.launches["filter_agg"] == launches  # no row: no launch
    tfa.filter_agg_i32(v, "gt", 0, (v,))
    assert _build.launches["filter_agg"] == launches + 1


# the two public wrappers of B1, at test_pallas_kernels.py's shapes: (name,
# seed, n, value bound, threshold, rows cut off the end)
COUNT_SUM_CASES = [("filter_count_sum_i32", 0, 100_000, 1000, 500, 5000),
                   ("filter_count_sum_exact_i32", 1, 70_000, 1 << 30,
                    1 << 29, 0)]


def _count_sum_case(case):
    name, seed, n, high, thr, cut = case
    v = np.random.default_rng(seed).integers(0, high, n).astype(np.int32)
    return name, v, thr, n - cut


@pytest.mark.parametrize("case", COUNT_SUM_CASES, ids=lambda c: c[0])
def test_filter_count_sum_matches_pallas(case, interpret_mode):
    import jax

    from gpu_olap_tpu.ops.pallas import filter_agg as jfa

    name, v, thr, n_valid = _count_sum_case(case)
    jc, js = getattr(jfa, name)(jax.numpy.asarray(v), thr, n_valid)
    tc, ts = getattr(tfa, name)(torch.from_numpy(v), thr, n_valid)
    assert ts.dtype == (torch.float64 if name == "filter_count_sum_i32"
                        else torch.int64)
    assert (int(tc), ts.item()) == (int(jc), np.asarray(js).item())
    m = v[:n_valid] > thr
    assert (int(tc), int(ts)) == (int(m.sum()),
                                  int(v[:n_valid][m].astype(np.int64).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", COUNT_SUM_CASES, ids=lambda c: c[0])
def test_filter_count_sum_cuda_matches_plain(case):
    dev = _cuda_device()
    name, v, thr, n_valid = _count_sum_case(case)
    launches = _build.launches["filter_agg"]
    tc, ts = getattr(tfa, name)(torch.from_numpy(v).to(dev), thr, n_valid)
    pc, ps = getattr(tfa, name)(torch.from_numpy(v), thr, n_valid)
    torch.cuda.synchronize()
    assert _build.launches["filter_agg"] == launches + 1
    assert ts.dtype == ps.dtype
    assert (int(tc), ts.item()) == (int(pc), ps.item())


# ---------------------------------------------------------------------------
# seg_agg: the cases of test_pallas_kernels.py (co-sorted int32 lanes, a
# multiple of the TPU kernel's 2048-row superblock)
# ---------------------------------------------------------------------------

SB = 2048  # the TPU kernel's superblock (gpu_olap_tpu/ops/pallas/seg_agg.py SB)


def _co_sort(keys, vals):
    order = np.lexsort((vals, keys))
    return keys[order].astype(np.int32), vals[order].astype(np.int32)


def _seg_case(name):
    """(keys_sorted, vals_sorted, max_groups)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "basic_runs":
        keys = np.sort(rng.integers(0, SB // 16, SB))
        return (*_co_sort(keys, rng.integers(-1_000_000, 1_000_000, SB)), 200)
    if name == "superblock_boundary_carry":
        n = 2 * SB
        keys = np.empty(n, np.int64)
        half = n // 2 + SB // 2
        keys[:half] = 7
        keys[half:] = 100 + np.arange(n - half) // 3
        return (*_co_sort(keys, np.arange(n) % 4096), n)
    if name == "every_row_new_group":
        return (np.arange(SB, dtype=np.int32) * 3 - SB,
                np.full(SB, -5, np.int32), SB + 4)
    if name == "sentinel_padding":
        n, n_valid = 4 * SB, 4 * SB - 3000
        k, v = _co_sort(rng.integers(0, 500, n_valid),
                        rng.integers(0, 1000, n_valid))
        return (np.concatenate([k, np.full(n - n_valid, I32_MAX, np.int32)]),
                np.concatenate([v, np.zeros(n - n_valid, np.int32)]), 520)
    if name == "overflow_exact_count":
        return np.arange(SB, dtype=np.int32), np.ones(SB, np.int32), 64
    if name == "one_group_everywhere":
        return (np.full(3 * SB, -3, np.int32),
                np.sort(rng.integers(I32_MIN, I32_MAX, 3 * SB)).astype(np.int32),
                4)
    if name == "giant_group_extremes":
        n = 4 * SB
        keys = np.empty(n, np.int64)
        keys[:2047] = np.arange(2047)
        keys[2047:3 * SB] = 2047
        keys[3 * SB:] = 2048 + np.arange(n - 3 * SB) // 5
        vals = np.full(n, I32_MAX, np.int64)
        vals[::3] = I32_MIN
        return (*_co_sort(keys, vals), 2048 + n - 3 * SB)
    if name == "fuzz":
        n = 3 * SB
        ng = int(rng.integers(1, n + 1))
        keys = np.sort(rng.integers(-(1 << 28), 1 << 28, ng))[
            rng.integers(0, ng, n)]
        return (*_co_sort(keys, rng.integers(I32_MIN, I32_MAX, n,
                                             endpoint=True)), n + 8)
    raise KeyError(name)


SEG_CASES = ["basic_runs", "superblock_boundary_carry", "every_row_new_group",
             "sentinel_padding", "overflow_exact_count", "one_group_everywhere",
             "giant_group_extremes", "fuzz"]


def _np_outputs(outs):
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("case", SEG_CASES)
def test_seg_agg_plain_matches_pallas(case, interpret_mode):
    import jax

    from gpu_olap_tpu.ops.pallas import seg_agg as jsa

    assert jsa.SB == SB
    keys, vals, max_groups = _seg_case(case)
    exp = _np_outputs(jsa.seg_agg_sorted_i32(
        jax.numpy.asarray(keys), jax.numpy.asarray(vals), max_groups, True))
    got = _np_outputs(tsa.seg_agg_sorted_i32(
        torch.from_numpy(keys), torch.from_numpy(vals), max_groups))
    assert int(got[5]) == int(exp[5])  # exact n_groups, overflow included
    m = min(int(exp[5]), max_groups)
    for g, e in zip(got[:5], exp[:5]):
        assert g.shape == (max_groups,)
        np.testing.assert_array_equal(g[:m], e[:m])  # integers: exact


def test_seg_agg_rejects_bad_inputs():
    k = torch.arange(10, dtype=torch.int32)
    launches = _build.launches["seg_agg"]
    with pytest.raises(ValueError):
        tsa.seg_agg_sorted_i32(k.to(torch.int64), k.to(torch.int64), 4)
    with pytest.raises(ValueError):
        tsa.seg_agg_sorted_i32(k, k[:5], 4)
    with pytest.raises(ValueError):
        tsa.seg_agg_sorted_i32(k[:0], k[:0], 4)
    assert _build.launches["seg_agg"] == launches  # CPU tensors never launch


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEG_CASES)
def test_seg_agg_cuda_matches_plain(case):
    dev = _cuda_device()
    keys, vals, max_groups = _seg_case(case)
    got = tsa.seg_agg_sorted_i32(torch.from_numpy(keys).to(dev),
                                 torch.from_numpy(vals).to(dev), max_groups)
    exp = tsa.seg_agg_plain(torch.from_numpy(keys), torch.from_numpy(vals),
                            max_groups)
    torch.cuda.synchronize()
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.cpu().numpy(), e.numpy())


# ---------------------------------------------------------------------------
# edge cases of the one-pass seg_agg (4096-row tiles joined by a decoupled
# look-back) and of the specialised filter_agg (one kernel per operator and
# number of distinct streams, a last-block finish): kernel against its
# plain version on the same CUDA tensors
# ---------------------------------------------------------------------------

TILE = 4096  # rows per seg_agg tile (csrc/seg_agg.cu kTile)


def _seg_edge(name):
    """(keys, vals, max_groups) as numpy, and the view offset to apply."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "groups_span_many_tiles":
        sizes = rng.integers(1, 40 * TILE, 60)
        k = np.repeat(np.arange(len(sizes)) * 11 - 300, sizes)
        return (*_co_sort(k, rng.integers(-(1 << 30), 1 << 30, len(k))), 64), 0
    if name == "one_group_sum_past_2p31":
        n = 3_000_001
        return (np.full(n, 9, np.int32), np.full(n, (1 << 30) + 7, np.int32),
                2), 0
    if name == "every_row_many_tiles":
        n = 1_000_003
        return (np.arange(n, dtype=np.int32) - 500,
                -np.arange(n, dtype=np.int32), n), 0
    if name == "n_1":
        return (np.array([I32_MIN], np.int32), np.array([-7], np.int32), 3), 0
    if name == "n_1_max_groups_0":
        return (np.array([4], np.int32), np.array([5], np.int32), 0), 0
    if name == "ragged_last_tile":
        n = 7 * TILE + 1234
        k = np.sort(rng.integers(0, 900, n))
        return (*_co_sort(k, rng.integers(-1000, 1000, n)), 1000), 0
    if name in ("max_groups_cut_mid_tiles", "max_groups_0_many_tiles"):
        sizes = rng.integers(1, 3000, 4000)
        k = np.repeat(np.arange(len(sizes)) * 3, sizes)
        kv = _co_sort(k, rng.integers(I32_MIN, I32_MAX, len(k), endpoint=True))
        return (*kv, 1234 if name.startswith("max_groups_cut") else 0), 0
    if name in ("negative_and_sentinel", "unaligned_view"):
        n = 777_777
        k = np.sort(rng.integers(-(1 << 31), -1, n))
        k[-100_000:] = I32_MAX
        return ((*_co_sort(k, rng.integers(I32_MIN, 0, n)), n),
                1 if name == "unaligned_view" else 0)
    raise KeyError(name)


SEG_EDGE = ["groups_span_many_tiles", "one_group_sum_past_2p31",
            "every_row_many_tiles", "n_1", "n_1_max_groups_0",
            "ragged_last_tile", "max_groups_cut_mid_tiles",
            "max_groups_0_many_tiles", "negative_and_sentinel",
            "unaligned_view"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEG_EDGE)
def test_seg_agg_cuda_edge_cases(case):
    dev = _cuda_device()
    (keys, vals, max_groups), off = _seg_edge(case)
    k = torch.from_numpy(keys).to(dev)[off:]
    v = torch.from_numpy(vals).to(dev)[off:]
    got = tsa.seg_agg_sorted_i32(k, v, max_groups)
    exp = tsa.seg_agg_plain(k, v, max_groups)
    torch.cuda.synchronize()
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.cpu().numpy(), e.cpu().numpy())


def _filter_edge(name, dev):
    """(filt, op, thr, cols, n_valid, wants) as tensors on ``dev``."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n = 100_000

    def t(a):
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    v = t(rng.integers(0, 1000, n))
    w = t(rng.integers(-50, 50, n))
    cols8 = [t(rng.integers(-(1 << 30), 1 << 30, n)) for _ in range(8)]
    if name.split("_")[0] == "cols" and name.split("_")[1].isdigit():
        k = int(name.split("_")[1])
        if name.endswith("_alias"):
            return v, "lt", 600, (v,) + tuple(cols8[:max(k - 1, 0)]), None, None
        return v, "ge", 300, tuple(cols8[:k]), None, None
    if name.startswith("op_"):
        return v, name.split("_")[1], 500, (v, w) + tuple(cols8[:6]), None, None
    big = t(rng.integers(-1000, 1000, 5_000_003))
    return {
        "cols_repeated": (v, "ne", 7, (w, v, w, cols8[0], v), None, None),
        "unaligned_filter_aligned_cols": (v[3:], "gt", 100,
                                          (w[:n - 3], v[3:]), None, None),
        "unaligned_cols_5": (w[1:], "le", 20,
                             tuple(c[1:] for c in cols8[:5]), None, None),
        "n_valid_1": (v, "ge", 0, (v, w), 1, None),
        "n_valid_3": (w, "ne", 1000, (w,), 3, None),
        "n_valid_4097": (v, "gt", 10, (v, w), 4097, None),
        "no_match_8_cols": (v, "gt", I32_MAX, tuple(cols8), None, None),
        "lt_int32_min": (v, "lt", I32_MIN, (v,), None, None),
        "wants_none": (v, "gt", 100, (v, w), None,
                       ((False, False), (False, False))),
        "wants_mixed_alias": (v, "le", 500, (v, v, w), None,
                              ((True, False), (False, True), (True, True))),
        "many_blocks": (big, "gt", -5, (big, -big), None, None),
        "many_blocks_n_valid": (big, "eq", 3, (big,), 4_999_001, None),
    }[name]


FILTER_EDGE = ([f"cols_{k}" for k in range(9)]
               + [f"cols_{k}_alias" for k in range(1, 9)]
               + [f"op_{op}_8_cols" for op in tfa.OPS]
               + ["cols_repeated", "unaligned_filter_aligned_cols",
                  "unaligned_cols_5", "n_valid_1", "n_valid_3", "n_valid_4097",
                  "no_match_8_cols", "lt_int32_min", "wants_none",
                  "wants_mixed_alias", "many_blocks", "many_blocks_n_valid"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", FILTER_EDGE)
def test_filter_agg_cuda_edge_cases(case):
    dev = _cuda_device()
    f, op, thr, cols, n_valid, wants = _filter_edge(case, dev)
    got = tfa.filter_agg_i32(f, op, thr, cols, n_valid, wants)
    exp = tfa.filter_agg_plain(f, op, thr, cols, n_valid, wants)
    torch.cuda.synchronize()
    assert _as_ints(got) == _as_ints(exp)


@pytest.mark.parametrize("case", FILTER_EDGE)
def test_filter_agg_edge_cases_plain_matches_numpy(case):
    """The CUDA twins' inputs on the CPU: the plain version against numpy,
    so each case is known to be well formed before it reaches the card."""
    f, op, thr, cols, n_valid, wants = _filter_edge(case, "cpu")
    n = f.shape[0] if n_valid is None else n_valid
    fn = f.numpy()[:n].astype(np.int64)
    m = {"gt": fn > thr, "ge": fn >= thr, "lt": fn < thr, "le": fn <= thr,
         "eq": fn == thr, "ne": fn != thr}[op]
    wants = wants or ((True, True),) * len(cols)
    exp = []
    for c, (ws, wm) in zip(cols, wants):
        x = c.numpy()[:n][m].astype(np.int64)
        exp.append((int(x.sum()) if ws else 0,
                    int(x.min()) if wm and len(x) else I32_MAX,
                    int(x.max()) if wm and len(x) else I32_MIN))
    got = tfa.filter_agg_i32(f, op, thr, cols, n_valid, wants)
    assert _as_ints(got) == (int(m.sum()), exp)


@pytest.mark.parametrize("case", SEG_EDGE)
def test_seg_agg_edge_cases_plain_matches_numpy(case):
    """The CUDA twins' inputs on the CPU: the plain version against numpy."""
    (keys, vals, max_groups), off = _seg_edge(case)
    keys, vals = keys[off:], vals[off:]
    got = [o.numpy() for o in tsa.seg_agg_sorted_i32(
        torch.from_numpy(keys), torch.from_numpy(vals), max_groups)]
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    ends = np.r_[starts[1:], len(keys)] - 1
    m = min(len(starts), max_groups)
    sums = np.add.reduceat(vals.astype(np.int64), starts)
    assert int(got[5]) == len(starts)
    for out, exp in zip(got[:5], (keys[starts], ends - starts + 1, sums,
                                  vals[starts], vals[ends])):
        assert out.shape == (max_groups,)
        np.testing.assert_array_equal(out[:m], exp[:m])
        assert not out[m:].any()


def test_ptxas_report_reads_registers_and_spills(tmp_path):
    log = tmp_path / "ptxas.log"
    log.write_text(
        "== seg_agg.cu\n"
        "ptxas info    : Compiling entry function '_Z3fooPi' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPi\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 1028 bytes smem,"
        " 400 bytes cmem[0]\n"
        "== filter_agg.cu\n"
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 48 registers, used 1 barriers\n")
    rows = _build.ptxas_report(str(log))
    assert [(r["source"], r["registers"], r["spill_stores"], r["spill_loads"],
             r["smem_bytes"]) for r in rows] == [
        ("seg_agg.cu", 40, 8, 12, 1028), ("filter_agg.cu", 48, 0, 0, 0)]


# ---------------------------------------------------------------------------
# stream_compact and expand_fill: the cases of test_pallas_kernels.py
# (the JAX kernels take inputs padded to their 2048-element step; the
# port's take exact lengths)
# ---------------------------------------------------------------------------

from gpu_olap_tpu_torch.ops.kernels import join_stream as tjs  # noqa: E402


def _pad(x, fill):
    return np.concatenate([x, np.full((-len(x)) % SB, fill, x.dtype)])


def _compact_case(name):
    """(mask bool, [streams int32], cap)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "random_extremes":
        n = 6 * SB + 123
        mask = rng.random(n) < 0.3
        a = rng.integers(I32_MIN, I32_MAX, n, endpoint=True).astype(np.int32)
        b = rng.integers(I32_MIN, I32_MAX, n, endpoint=True).astype(np.int32)
        a[:3] = [I32_MIN, I32_MAX, 0]
        mask[:3] = True
        return mask, [a, b], int(mask.sum()) + 8
    n = 4 * SB
    a = np.arange(n, dtype=np.int32)
    if name == "all_set":
        return np.ones(n, bool), [a], n
    if name == "none_set":
        return np.zeros(n, bool), [a], 16
    if name == "alternating":
        return np.arange(n) % 2 == 0, [a, -a], n // 2
    if name == "count_over_cap":
        mask = rng.random(n) < 0.6
        return mask, [a, a * 3], int(mask.sum()) // 2
    raise KeyError(name)


COMPACT_CASES = ["random_extremes", "all_set", "none_set", "alternating",
                 "count_over_cap"]


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_stream_compact_plain_matches_pallas(case):
    import jax

    from gpu_olap_tpu.ops.pallas import join_stream as js

    assert js.SB == SB
    mask, streams, cap = _compact_case(case)
    jouts, jcnt = js.stream_compact_i32(
        jax.numpy.asarray(_pad(mask, False)),
        [jax.numpy.asarray(_pad(s, 0)) for s in streams], cap, True)
    outs, cnt = tjs.stream_compact_i32(
        torch.from_numpy(mask), [torch.from_numpy(s) for s in streams], cap)
    assert int(cnt) == int(jcnt) == int(mask.sum())  # exact past cap too
    k = min(int(cnt), cap)
    for o, jo in zip(outs, jouts):
        assert o.shape == (cap,) and o.dtype == torch.int32
        np.testing.assert_array_equal(o.numpy()[:k], np.asarray(jo)[:k])
        assert not o.numpy()[k:].any()  # slots past the count are zero


def _expand_case(name):
    """(starts int32, [streams int32], cap, total): live records first, then
    INT32_MAX pads."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "run_lengths_1_5":
        cnts = rng.integers(1, 6, 3000)
    elif name == "long_runs_block_spans":
        cnts = np.array([5000, 1, 1, 7000, 2048, 2, 4096])
    elif name == "one_giant_run":
        cnts = np.array([3 * SB + 17])
    elif name == "no_records":
        cnts = np.zeros(0, np.int64)
    else:
        raise KeyError(name)
    m = len(cnts)
    starts = np.concatenate([[0], np.cumsum(cnts)[:-1]]).astype(np.int32) \
        if m else np.zeros(0, np.int32)
    total = int(cnts.sum())
    va = rng.integers(I32_MIN, I32_MAX, m, endpoint=True).astype(np.int32)
    vb = rng.integers(0, 1 << 30, m).astype(np.int32)
    n_pad = 37  # pad records, as a caller masks records past its count
    starts = np.concatenate([starts, np.full(n_pad, I32_MAX, np.int32)])
    streams = [np.concatenate([v, rng.integers(-9, 9, n_pad).astype(np.int32)])
               for v in (va, vb)]
    return starts, streams, total + 1000, total


EXPAND_CASES = ["run_lengths_1_5", "long_runs_block_spans", "one_giant_run",
                "no_records"]


@pytest.mark.parametrize("case", EXPAND_CASES)
def test_expand_fill_plain_matches_pallas(case):
    import jax

    from gpu_olap_tpu.ops.pallas import join_stream as js

    starts, streams, cap, total = _expand_case(case)
    # the JAX kernel wants 2048-multiples and 2304 pad records of headroom
    m_pad = -(-(len(starts) + 2304) // SB) * SB
    jstarts = np.concatenate([starts, np.full(m_pad - len(starts), I32_MAX,
                                              np.int32)])
    jstreams = [np.concatenate([s, np.zeros(m_pad - len(s), np.int32)])
                for s in streams]
    jcap = -(-cap // SB) * SB
    exp = js.expand_fill_i32(jax.numpy.asarray(jstarts),
                             [jax.numpy.asarray(s) for s in jstreams], jcap,
                             True)
    got = tjs.expand_fill_i32(torch.from_numpy(starts),
                              [torch.from_numpy(s) for s in streams], cap)
    assert len(got) == len(streams) + 1
    for g, e in zip(got, exp):
        assert g.shape == (cap,) and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy()[:total], np.asarray(e)[:total])
    # past the total: the last live record is replicated
    if total:
        last = int(np.flatnonzero(starts != I32_MAX)[-1])
        tail = slice(total, cap)
        np.testing.assert_array_equal(
            got[0].numpy()[tail], np.arange(total, cap) - starts[last])
        for g, s in zip(got[1:], streams):
            assert (g.numpy()[tail] == s[last]).all()


def test_join_stream_kernels_reject_bad_inputs():
    s = torch.tensor([0, 3, 3, I32_MAX], dtype=torch.int32)
    v = torch.arange(4, dtype=torch.int32)
    launches = (_build.launches["stream_compact"],
                _build.launches["expand_fill"])
    with pytest.raises(ValueError):  # starts must increase strictly
        tjs.expand_fill_i32(s, [v], 8)
    with pytest.raises(ValueError):  # pads only at the end
        tjs.expand_fill_i32(torch.tensor([0, I32_MAX, 5], dtype=torch.int32),
                            [v[:3]], 8)
    with pytest.raises(ValueError):
        tjs.expand_fill_i32(s.to(torch.int64), [v], 8)
    with pytest.raises(ValueError):
        tjs.stream_compact_i32(v > 1, [v.to(torch.int64)], 4)
    with pytest.raises(ValueError):
        tjs.stream_compact_i32(v.to(torch.float32), [v], 4)
    with pytest.raises(ValueError):  # the mask is bool only
        tjs.stream_compact_i32(v, [v], 4)
    with pytest.raises(ValueError):
        tjs.stream_compact_i32(v > 1, [v[:3]], 4)
    assert (_build.launches["stream_compact"],
            _build.launches["expand_fill"]) == launches  # CPU never launches


@pytest.mark.cuda
@pytest.mark.parametrize("case", COMPACT_CASES)
def test_stream_compact_cuda_matches_plain(case):
    dev = _cuda_device()
    mask, streams, cap = _compact_case(case)
    tm = torch.from_numpy(mask)
    ts = [torch.from_numpy(s) for s in streams]
    launches = _build.launches["stream_compact"]
    outs, cnt = tjs.stream_compact_i32(tm.to(dev), [s.to(dev) for s in ts],
                                       cap)
    eouts, ecnt = tjs.stream_compact_plain(tm, ts, cap)
    torch.cuda.synchronize()
    assert _build.launches["stream_compact"] == launches + 1
    assert int(cnt) == int(ecnt)
    for o, e in zip(outs, eouts):
        np.testing.assert_array_equal(o.cpu().numpy(), e.numpy())


@pytest.mark.cuda
def test_stream_compact_cuda_many_streams():
    """More streams than one launch carries: the scatter runs per group."""
    dev = _cuda_device()
    rng = np.random.default_rng(5)
    n = 100_003
    mask = torch.from_numpy(rng.random(n) < 0.4)
    streams = [torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.int32))
               for _ in range(11)]
    outs, cnt = tjs.stream_compact_i32(mask.to(dev),
                                       [s.to(dev) for s in streams], n)
    eouts, ecnt = tjs.stream_compact_plain(mask, streams, n)
    torch.cuda.synchronize()
    assert int(cnt) == int(ecnt)
    for o, e in zip(outs, eouts):
        np.testing.assert_array_equal(o.cpu().numpy(), e.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", EXPAND_CASES)
def test_expand_fill_cuda_matches_plain(case):
    dev = _cuda_device()
    starts, streams, cap, _total = _expand_case(case)
    ts = torch.from_numpy(starts)
    tstreams = [torch.from_numpy(s) for s in streams]
    launches = _build.launches["expand_fill"]
    got = tjs.expand_fill_i32(ts.to(dev), [s.to(dev) for s in tstreams], cap)
    exp = tjs.expand_fill_plain(ts, tstreams, cap)
    torch.cuda.synchronize()
    assert _build.launches["expand_fill"] == launches + 1
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.cpu().numpy(), e.numpy())


@pytest.mark.cuda
def test_expand_fill_cuda_many_streams_and_late_first_start():
    """Eleven streams (two fill launches) and a first record that starts
    past slot 0: the slots before it get off = slot and zeros."""
    dev = _cuda_device()
    rng = np.random.default_rng(6)
    cnts = rng.integers(1, 40, 5000)
    starts = (100 + np.concatenate([[0], np.cumsum(cnts)[:-1]])).astype(np.int32)
    streams = [torch.from_numpy(rng.integers(-9, 9, 5000).astype(np.int32))
               for _ in range(11)]
    cap = int(starts[-1]) + 5000
    got = tjs.expand_fill_i32(torch.from_numpy(starts).to(dev),
                              [s.to(dev) for s in streams], cap)
    exp = tjs.expand_fill_plain(torch.from_numpy(starts), streams, cap)
    torch.cuda.synchronize()
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.cpu().numpy(), e.numpy())


# ---------------------------------------------------------------------------
# radix_hist (B5)
# ---------------------------------------------------------------------------

def _radix_cuda_cases(dev):
    """(name, keys on ``dev``): edge lengths, one bin, negative keys, and
    the packed-counter kernel's own edges: one bin over four flushes of
    every block of a full wave, every thread's counter at exactly the
    flush limit in all 256 bins, views at offsets 1-3 of lengths 1-7."""
    rng = np.random.default_rng(6)
    cases = [(f"random_{n}", torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)).to(dev))
        for n in (0, 1, 16383, 16385, 1_000_003)]
    cases.append(("one_bin", torch.full((300_001,), 7, dtype=torch.int32,
                                        device=dev)))
    cases.append(("eight_bins", torch.arange(200_000, dtype=torch.int32,
                                             device=dev) % 8))
    # keys a full wave counts between two flushes of every thread
    flush_keys = _build.load().olap_radix_hist_wave_flush_keys()
    cases.append(("one_bin_four_flushes", torch.full(
        (flush_keys * 4 + 5,), 7, dtype=torch.int32, device=dev)))
    # thread t of a block loads the 16-byte words j with j % 256 == t % 256
    # (blocks are whole groups of 256 threads): keys (index // 4) % 256 put
    # all of a thread's keys in bin t % 256
    cases.append(("all_bins_at_flush_limit", (torch.arange(
        flush_keys * 2 + 3, device=dev) // 4 % 256).to(torch.int32)))
    base = cases[4][1]
    for off in (1, 2, 3):
        cases.append((f"view_{off}", base[off:]))
        cases += [(f"view_{off}_len_{n}", base[off:off + n])
                  for n in range(1, 8)]
    return cases


@pytest.mark.cuda
def test_cuda_radix_histogram_matches_plain():
    """The CUDA kernel against its plain version, exactly, at every shift
    the edge cases use: each case twice on the current stream (the block
    counter resets) and once on a second stream.  (The plain version
    against the Pallas kernel: ``test_torch_parallel.py``.)"""
    from gpu_olap_tpu_torch.ops.kernels import partition as tpart
    from gpu_olap_tpu_torch.parallel import skew as tskew

    dev = _cuda_device()
    cases = _radix_cuda_cases(dev)
    side = torch.cuda.Stream(dev)
    before = _build.launches["radix_hist"]
    for name, k in cases:
        for shift in (0, 8, 16, 24, 31):
            exp = tpart.radix_histogram_plain(k, shift).cpu()
            got = [tpart.radix_histogram_i32(k, shift),
                   tpart.radix_histogram_i32(k, shift)]
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                got.append(tpart.radix_histogram_i32(k, shift))
            torch.cuda.synchronize()
            for g in got:
                torch.testing.assert_close(g.cpu(), exp, rtol=0, atol=0,
                                           msg=f"{name} shift {shift}")
    # an empty input launches nothing
    launched = 3 * 5 * (len(cases) - 1)
    assert _build.launches["radix_hist"] - before == launched
    rng = np.random.default_rng(7)
    hist = tskew.partition_histogram(torch.from_numpy(
        rng.integers(0, 1 << 40, 100_000)).to(dev), 8)
    assert _build.launches["radix_hist"] - before == launched + 1
    assert int(hist.sum()) == 100_000
