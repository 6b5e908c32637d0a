"""The port's distributed steps over a ``torch.distributed`` process group.

Every collective and every ``make_*`` step runs on a mesh of 8 shards spread
over W = 2 and W = 4 ranks of a gloo group on the CPU (one process per
rank, joined through a file store in a temporary directory), and each rank's
shards are held, element for element, against JAX's ``make_*`` on the
8-device virtual mesh and against the port's own single-process
``["cpu"] * 8`` mesh.  The inputs are global host arrays made with numpy
from a seed (``dist_arrays.py``, shared with ``test_torch_parallel.py``
and free of JAX, so the ``cuda``-marked twin runs where JAX is not
installed, under ``--noconftest``): every rank
reads the same arrays and uploads only its shards, as JAX's ``device_put``
under ``row_sharding`` does.  Integers and shuffled rows must agree
exactly, float sums within ``rtol=1e-12`` (summed in another order by JAX).

The ranks are this file run as a script: their imports are numpy, torch and
the port (no JAX, no ``gpu_olap_tpu``; each asserts it at its end).  One
spawn per world size runs every case and writes each rank's outputs to an
``.npz``; every rank has a 60 s deadline and all are killed when one fails,
so a deadlocked collective fails the test instead of hanging the suite.
The ``cuda``-marked twin runs one NCCL rank on the card.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gpu_olap_tpu_torch.parallel import collectives as tcoll
from gpu_olap_tpu_torch.parallel import dist_ops as tdo
from gpu_olap_tpu_torch.parallel import mesh as tmesh
from gpu_olap_tpu_torch.parallel import shuffle as tshuffle

from dist_arrays import NDEV, skew_arrays, step_arrays

RANK_DEADLINE_S = 60
STEP = dict(capacity=2048, join_capacity=65536, max_groups=256,
            agg_funcs=("sum", "count"))
GROUPBY_SPECS = [{"func": "sum", "acc_dtype": np.int64},
                 {"func": "count", "acc_dtype": np.int64}]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# every case, run by the ranks and by the single-process mesh alike
# ---------------------------------------------------------------------------

def _port_cases(mesh, inp) -> dict:
    """Every case on ``mesh``: this process's shards as ``case/field/shard``
    and replicated values as ``case/field``, in numpy."""
    out = {}

    def put(case, **fields):
        for name, value in fields.items():
            if isinstance(value, (list, tuple)):
                for i, t in zip(mesh.local_indices, value):
                    out[f"{case}/{name}/{i}"] = t.cpu().numpy()
            else:
                out[f"{case}/{name}"] = value.cpu().numpy()

    def rows(name):
        return tmesh.shard_rows(mesh, inp[name])

    def per_shard(name):
        return tmesh.shards_from_numpy(mesh, list(inp[name]))

    put("coll", a2a_i64=tcoll.all_to_all(mesh, per_shard("coll_i64")),
        a2a_f64=tcoll.all_to_all(mesh, per_shard("coll_f64")),
        a2a_bool=tcoll.all_to_all(mesh, per_shard("coll_bool")),
        gather=tcoll.all_gather(mesh, per_shard("coll_parts")),
        gather_bool=tcoll.all_gather(mesh, per_shard("coll_bool")),
        psum=tcoll.psum(mesh, per_shard("coll_vals")),
        pmin=tcoll.pmin(mesh, per_shard("coll_vals")),
        pmax=tcoll.pmax(mesh, per_shard("coll_vals")),
        pany=tcoll.pany(mesh, per_shard("coll_flags")),
        pany_none=tcoll.pany(mesh, per_shard("coll_no_flags")))

    rk, rp, rv, of = tshuffle.make_shuffle(mesh, 1, 256)(
        rows("sh_k"), rows("sh_valid"), rows("sh_v"))
    put("shuffle", k=rk, v=rp, valid=rv, of=of)
    *_, of = tshuffle.make_shuffle(mesh, 0, 64)(
        rows("zero_k"), rows("zero_valid"))
    put("shuffle_overflow", of=of)

    gk, (s, c), gv, n = tdo.make_dist_groupby(mesh, GROUPBY_SPECS, 1024, 512)(
        rows("gb_k"), rows("gb_valid"), rows("gb_v"), rows("gb_v"))
    put("groupby", gk=gk, sum=s, count=c, gvalid=gv, n=n)

    key, (lv,), (rv,), valid, tot = tdo.make_dist_join(mesh, 1024, 8192, 1, 1)(
        rows("j_lk"), rows("j_lvalid"), rows("j_rk"), rows("j_rvalid"),
        rows("j_lv"), rows("j_rv"))
    put("join", key=key, lv=lv, rv=rv, valid=valid, total=tot)

    for case in ("step_int", "step_float", "step_zipf"):
        args = [rows(f"{case}_{i}") for i in range(6)]
        gk, (s, c), gv, of = tdo.make_dist_join_groupby(mesh, **STEP)(*args)
        put(case, gk=gk, sum=s, count=c, gvalid=gv, of=of)

    shuf, local = tdo.make_dist_join_groupby_stages(mesh, **STEP)
    *lanes, sof = shuf(*[rows(f"step_int_{i}") for i in range(6)])
    put("stages", **dict(zip(("slk", "slval", "slv", "srk", "srval", "srv"),
                             lanes)), sof=sof)
    gk, (s, c), gv, lof = local(*lanes)
    put("stages", gk=gk, sum=s, count=c, gvalid=gv, lof=lof)

    args = [rows(f"step_zipf_{i}") for i in range(6)]
    for case, cap in (("skew", 64), ("skew_cap1", 1)):
        gk, (s, c), gv, of = tdo.make_dist_join_groupby_skew(
            mesh, **STEP, heavy_keys=inp["heavy"], heavy_build_cap=cap)(*args)
        put(case, gk=gk, sum=s, count=c, gvalid=gv, of=of)

    ones, valid = rows("zero_one"), rows("zero_valid")
    of = tdo.make_dist_join_groupby(
        mesh, capacity=64, join_capacity=4096, max_groups=64,
        agg_funcs=("sum",))(rows("zero_k"), valid, ones, rows("zero_k"),
                             valid, ones)[3]
    put("step_overflow", of=of)
    return out


def _rank_main(d: str, rank: int, world: int, device: str) -> None:
    """One rank: join the group, run every case, write ``out{rank}.npz``."""
    import torch.distributed as dist

    from gpu_olap_tpu_torch.parallel.dist_executor import DistributedExecutor

    torch.set_num_threads(1)
    group = tmesh.initialize_distributed(f"file://{d}/store", world, rank,
                                         device=device)
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    per = NDEV // world
    count = torch.cuda.device_count() if device == "cuda" else 0
    devices = [f"cuda:{(i // per) % count}" if count else "cpu"
               for i in range(NDEV)]
    mesh = tmesh.make_mesh(NDEV, devices, group=group)
    assert mesh.local_indices == range(rank * per, (rank + 1) * per)
    out = _port_cases(mesh, inp)
    refused = []
    try:
        DistributedExecutor(None, None, None, mesh)
    except ValueError as e:
        refused.append(str(e))
    out["refused"] = np.array(refused)
    out["backend"] = np.array(dist.get_backend(group))
    dist.destroy_process_group()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "gpu_olap_tpu"))
    assert not loaded, loaded
    np.savez(os.path.join(d, f"out{rank}.npz"), **out)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the parent: inputs, ranks, references
# ---------------------------------------------------------------------------

def _inputs() -> dict:
    rng = np.random.default_rng(11)
    inp = {"coll_i64": rng.integers(-10**12, 10**12, (NDEV, NDEV * 3)),
           "coll_f64": rng.normal(0, 1, (NDEV, NDEV * 3)),
           "coll_bool": rng.random((NDEV, NDEV * 3)) < 0.5,
           "coll_parts": rng.integers(-100, 100, (NDEV, 5)),
           "coll_vals": rng.integers(-50, 50, NDEV),
           "coll_flags": np.arange(NDEV) == 5,
           "coll_no_flags": np.zeros(NDEV, bool)}
    # test_torch_parallel's shuffle, groupby and join inputs
    rng = np.random.default_rng(0)
    n = NDEV * 512
    inp.update(sh_k=rng.integers(0, 1000, n), sh_v=rng.integers(0, 10**9, n),
               sh_valid=rng.random(n) < 0.9, zero_k=np.zeros(n, np.int64),
               zero_valid=np.ones(n, bool), zero_one=np.ones(n, np.int64))
    rng = np.random.default_rng(1)
    n = NDEV * 1024
    inp.update(gb_k=rng.integers(0, 200, n), gb_v=rng.integers(-100, 100, n),
               gb_valid=np.ones(n, bool))
    rng = np.random.default_rng(2)
    nl, nr = NDEV * 512, NDEV * 256
    inp.update(j_lk=rng.integers(0, 300, nl), j_rk=rng.integers(100, 400, nr),
               j_lv=np.arange(nl), j_rv=np.arange(nr) + 10**6,
               j_lvalid=np.ones(nl, bool), j_rvalid=np.ones(nr, bool))
    skew, heavy = skew_arrays()
    for case, arrays in (("step_int", step_arrays("int")),
                         ("step_float", step_arrays("float")),
                         ("step_zipf", skew)):
        inp.update({f"{case}_{i}": a for i, a in enumerate(arrays)})
    inp["heavy"] = heavy
    return {k: (v.astype(np.int64) if v.dtype.kind == "i" else v)
            for k, v in inp.items()}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _spawn(d, world: int, device: str) -> list:
    """Run ``world`` ranks of this file on the inputs in ``d``; each rank's
    outputs.  A rank that fails or outlives its deadline fails the test,
    with every rank killed."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(os.path.join(d, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(d), str(r),
                 str(world), device], cwd=d, env=env, stdout=log,
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + RANK_DEADLINE_S
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        text = "\n".join(open(os.path.join(d, f"rank{r}.log")).read()[-3000:]
                         for r in range(world))
        pytest.fail(f"ranks exited {codes} (killed past {RANK_DEADLINE_S} s "
                    f"or after another failed):\n{text}")
    return [dict(np.load(os.path.join(d, f"out{r}.npz")))
            for r in range(world)]


def _merge(outs: list) -> dict:
    """The ranks' outputs as one dict; a replicated value must be equal on
    every rank."""
    merged = {}
    for o in outs:
        for k, v in o.items():
            if k in merged:
                np.testing.assert_array_equal(v, merged[k], err_msg=k)
            merged[k] = v
    return merged


@pytest.fixture(scope="module", params=[2, 4], ids=["w2", "w4"])
def ranks(request, inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"ranks{request.param}")
    np.savez(d / "inputs.npz", **inputs)
    outs = _spawn(d, request.param, "cpu")
    per = NDEV // request.param
    for r, o in enumerate(outs):  # each rank wrote its own shards only
        assert {int(k.rsplit("/", 1)[1]) for k in o if k.count("/") == 2} \
            == set(range(r * per, (r + 1) * per))
    return request.param, _merge(outs)


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-process mesh of eight CPU shards."""
    return _port_cases(tmesh.make_mesh(NDEV, ["cpu"] * NDEV), inputs)


@pytest.fixture(scope="module")
def jaxo(inputs):
    """JAX's steps on the 8-device virtual mesh, in the same key scheme."""
    import jax

    from gpu_olap_tpu.parallel import dist_ops as jdo
    from gpu_olap_tpu.parallel import mesh as jmesh
    from gpu_olap_tpu.parallel import shuffle as jshuffle

    jm = jmesh.make_mesh(NDEV)
    out = {}

    def put(case, **fields):
        for name, value in fields.items():
            a = np.asarray(value)
            if a.ndim == 0:
                out[f"{case}/{name}"] = a
            else:
                for i, block in enumerate(a.reshape(NDEV, -1)):
                    out[f"{case}/{name}/{i}"] = block

    def rows(name):
        return jax.device_put(inputs[name], jmesh.row_sharding(jm))

    rk, rp, rv, of = jshuffle.make_shuffle(jm, 1, 256)(
        rows("sh_k"), rows("sh_valid"), rows("sh_v"))
    put("shuffle", k=rk, v=rp, valid=rv, of=np.asarray(of).max())
    *_, of = jshuffle.make_shuffle(jm, 0, 64)(rows("zero_k"),
                                               rows("zero_valid"))
    put("shuffle_overflow", of=np.asarray(of).max())
    gk, (s, c), gv, n = jdo.make_dist_groupby(jm, GROUPBY_SPECS, 1024, 512)(
        rows("gb_k"), rows("gb_valid"), rows("gb_v"), rows("gb_v"))
    put("groupby", gk=gk, sum=s, count=c, gvalid=gv, n=n)
    key, (lv,), (rv,), valid, tot = jdo.make_dist_join(jm, 1024, 8192, 1, 1)(
        rows("j_lk"), rows("j_lvalid"), rows("j_rk"), rows("j_rvalid"),
        rows("j_lv"), rows("j_rv"))
    put("join", key=key, lv=lv, rv=rv, valid=valid, total=tot)
    for case in ("step_int", "step_float", "step_zipf"):
        args = [rows(f"{case}_{i}") for i in range(6)]
        gk, (s, c), gv, of = jdo.make_dist_join_groupby(jm, **STEP)(*args)
        put(case, gk=gk, sum=s, count=c, gvalid=gv, of=of)
    shuf, local = jdo.make_dist_join_groupby_stages(jm, **STEP)
    *lanes, sof = shuf(*[rows(f"step_int_{i}") for i in range(6)])
    put("stages", **dict(zip(("slk", "slval", "slv", "srk", "srval", "srv"),
                             lanes)), sof=sof)
    gk, (s, c), gv, lof = local(*lanes)
    put("stages", gk=gk, sum=s, count=c, gvalid=gv, lof=lof)
    for case, cap in (("skew", 64), ("skew_cap1", 1)):
        gk, (s, c), gv, of = jdo.make_dist_join_groupby_skew(
            jm, **STEP, heavy_keys=inputs["heavy"], heavy_build_cap=cap)(
            *[rows(f"step_zipf_{i}") for i in range(6)])
        put(case, gk=gk, sum=s, count=c, gvalid=gv, of=of)
    return out


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _equal(got, exp, what):
    if exp.dtype.kind == "f":
        np.testing.assert_allclose(got, exp, rtol=1e-12, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(got, exp, err_msg=what)


def _same_shards(got: dict, exp: dict, case: str, fields, what: str):
    """Each shard's ``fields`` equal, element for element."""
    for f in fields:
        for d in range(NDEV):
            _equal(got[f"{case}/{f}/{d}"], exp[f"{case}/{f}/{d}"],
                   f"{what}: {case}/{f} shard {d}")


def _same_valid_rows(got, exp, case, valid, fields, what):
    """The same valid slots per shard, and the same values in them, in
    order."""
    for d in range(NDEV):
        v = exp[f"{case}/{valid}/{d}"]
        np.testing.assert_array_equal(got[f"{case}/{valid}/{d}"], v,
                                      err_msg=f"{what}: {case} shard {d}")
        for f in fields:
            _equal(got[f"{case}/{f}/{d}"][v], exp[f"{case}/{f}/{d}"][v],
                   f"{what}: {case}/{f} shard {d}")


def _same_groups(got, exp, case, what):
    """Per shard, the valid groups' (key, sum, count) rows sorted by key."""
    for d in range(NDEV):
        rows = []
        for out in (got, exp):
            v = out[f"{case}/gvalid/{d}"]
            cols = [out[f"{case}/{f}/{d}"][v] for f in ("gk", "sum", "count")]
            order = np.argsort(cols[0], kind="stable")
            rows.append([c[order] for c in cols])
        for j, (g, e) in enumerate(zip(*rows)):
            _equal(g, e, f"{what}: {case} shard {d} col {j}")


def _flag(out, case, field="of"):
    return bool(np.asarray(out[f"{case}/{field}"]).max())


# ---------------------------------------------------------------------------
# the cases at W = 2 and W = 4
# ---------------------------------------------------------------------------

def test_collectives_cross_ranks(ranks, single, inputs):
    _, got = ranks
    coll = inputs["coll_i64"]
    for d in range(NDEV):  # shard d: block d of every source, in source order
        exp = np.concatenate([coll[s, 3 * d:3 * d + 3] for s in range(NDEV)])
        np.testing.assert_array_equal(got[f"coll/a2a_i64/{d}"], exp)
        np.testing.assert_array_equal(got[f"coll/gather/{d}"],
                                      inputs["coll_parts"].reshape(-1))
        np.testing.assert_array_equal(got[f"coll/gather_bool/{d}"],
                                      inputs["coll_bool"].reshape(-1))
    _same_shards(got, single, "coll", ("a2a_i64", "a2a_f64", "a2a_bool",
                                       "gather", "gather_bool"), "collectives")
    vals = inputs["coll_vals"]
    assert [got[f"coll/{op}"].item() for op in ("psum", "pmin", "pmax")] == \
        [vals.sum(), vals.min(), vals.max()]
    assert got["coll/pany"].item() and not got["coll/pany_none"].item()
    assert got["coll/pany"].dtype == np.bool_
    for k in ("psum", "pmin", "pmax", "pany", "pany_none"):
        np.testing.assert_array_equal(got[f"coll/{k}"], single[f"coll/{k}"])


def test_shuffle_matches_jax_per_shard(ranks, single, jaxo):
    _, got = ranks
    for exp, what in ((jaxo, "jax"), (single, "single-process")):
        _same_valid_rows(got, exp, "shuffle", "valid", ("k", "v"), what)
        assert _flag(got, "shuffle") == _flag(exp, "shuffle") is False


def test_shuffle_overflow_flag(ranks, single, jaxo):
    _, got = ranks
    assert _flag(got, "shuffle_overflow") is True
    assert _flag(jaxo, "shuffle_overflow") and _flag(single, "shuffle_overflow")


def test_dist_groupby_matches_jax(ranks, single, jaxo):
    _, got = ranks
    for exp, what in ((jaxo, "jax"), (single, "single-process")):
        _same_shards(got, exp, "groupby", ("n",), what)
        _same_groups(got, exp, "groupby", what)


def test_dist_join_matches_jax(ranks, single, jaxo):
    _, got = ranks
    for exp, what in ((jaxo, "jax"), (single, "single-process")):
        _same_shards(got, exp, "join", ("total",), what)
        for d in range(NDEV):
            pairs = []
            for out in (got, exp):
                v = out[f"join/valid/{d}"]
                pairs.append(sorted(zip(*(out[f"join/{f}/{d}"][v]
                                          for f in ("key", "lv", "rv")))))
            assert pairs[0] == pairs[1], f"{what}: join shard {d}"


@pytest.mark.parametrize("case", ["step_int", "step_float", "step_zipf"])
def test_dist_join_groupby_matches_jax(ranks, single, jaxo, case):
    _, got = ranks
    assert not _flag(got, case)
    for exp, what in ((jaxo, "jax"), (single, "single-process")):
        assert not _flag(exp, case)
        _same_groups(got, exp, case, what)


def test_dist_join_groupby_stages_match_jax(ranks, single, jaxo):
    _, got = ranks
    assert not _flag(got, "stages", "sof") and not _flag(got, "stages", "lof")
    for exp, what in ((jaxo, "jax"), (single, "single-process")):
        _same_valid_rows(got, exp, "stages", "slv", ("slk", "slval"), what)
        _same_valid_rows(got, exp, "stages", "srv", ("srk", "srval"), what)
        _same_groups(got, exp, "stages", what)
    _same_groups(got, single, "step_int", "stages vs fused")


def test_dist_join_groupby_skew_matches_jax(ranks, single, jaxo):
    _, got = ranks
    assert not _flag(got, "skew") and not _flag(jaxo, "skew")
    for exp, what in ((jaxo, "jax"), (single, "single-process")):
        _same_groups(got, exp, "skew", what)


def test_skew_step_flags_heavy_build_rows_past_cap(ranks, single, jaxo):
    """One shard holds key 7's 4 build rows, past a cap of 1: every rank
    raises the flag, as the single-process port does; JAX's step drops the
    rows without flagging them (ROADMAP C)."""
    _, got = ranks
    assert _flag(got, "skew_cap1") and _flag(single, "skew_cap1")
    assert not _flag(jaxo, "skew_cap1")


def test_dist_step_overflow_flag_reports(ranks, single):
    _, got = ranks
    assert _flag(got, "step_overflow") and _flag(single, "step_overflow")


def test_ranks_refuse_the_engine_and_import_no_jax(ranks):
    """Each rank formed a gloo group, ``DistributedExecutor`` refused its
    mesh, and the ranks loaded neither JAX nor ``gpu_olap_tpu`` (asserted in
    each rank before it wrote its outputs)."""
    world, got = ranks
    assert str(got["backend"]) == "gloo"
    (msg,) = got["refused"]
    assert "single-process" in msg and f"spans {world} process" in msg


# ---------------------------------------------------------------------------
# refusals in this process, and one NCCL rank on the card
# ---------------------------------------------------------------------------

def test_initialize_distributed_single_process_is_a_noop():
    assert tmesh.initialize_distributed() is None
    assert tmesh.initialize_distributed(None, 1, 0) is None
    assert tmesh.initialize_distributed(None, 1, 0, device="cpu") is None
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        tmesh.initialize_distributed(None, 2, 0)
    with pytest.raises(ValueError, match="not a rank"):
        tmesh.initialize_distributed("localhost:1", 2, 2, device="cpu")


def test_initialize_distributed_cuda_never_takes_gloo(tmp_path):
    """The default device is CUDA: without a card it raises before it joins
    any group, and no gloo group is formed in its place."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs none")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.initialize_distributed(f"file://{tmp_path}/store", 1, 0)
    assert not torch.distributed.is_initialized()
    assert not os.path.exists(tmp_path / "store")


def test_make_mesh_over_a_group_needs_the_global_list():
    with pytest.raises(ValueError, match="global device list"):
        tmesh.make_mesh(NDEV, None, group=object())


@pytest.mark.cuda
def test_one_nccl_rank_on_the_card(inputs, single, tmp_path):
    """One NCCL rank holding all eight shards on its card: the same answers
    as the single-process CPU mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    np.savez(tmp_path / "inputs.npz", **inputs)
    (got,) = _spawn(tmp_path, 1, "cuda")
    assert str(got["backend"]) == "nccl"
    _same_shards(got, single, "coll", ("a2a_i64", "a2a_bool", "gather"),
                 "nccl")
    for case in ("step_int", "step_float", "step_zipf", "skew", "stages",
                 "groupby"):
        _same_groups(got, single, case, "nccl")
    _same_valid_rows(got, single, "shuffle", "valid", ("k", "v"), "nccl")
