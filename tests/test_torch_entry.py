"""The port's entry points (``gpu_olap_tpu_torch.entry``) against
``__graft_entry__.py``.

``entry(device="cpu")``'s step runs on the same seed-0 arguments as JAX's
jitted ``entry()`` step: group keys, sums, counts and ``n_groups`` must be
exact.  ``dryrun_multichip(8, devices=["cpu"] * 8)`` runs on eight logical
CPU shards; its first step's groups must equal JAX's
``make_dist_join_groupby`` on the 8-device virtual mesh of ``conftest.py``
for the same arrays, and its overflow-retry and skew checks must pass.
Without ``devices`` it takes the visible CUDA devices, which this machine
does not have, so it raises.
"""

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as jentry
from gpu_olap_tpu.parallel import dist_ops as jdo
from gpu_olap_tpu.parallel import mesh as jmesh
from gpu_olap_tpu_torch import entry as tentry


@pytest.fixture(scope="module")
def jax_step_out():
    fn, args = jentry.entry()
    return [np.asarray(o) for o in jax.jit(fn)(*args)], args


@pytest.mark.parametrize("threshold", ["int", "tensor"])
def test_entry_step_matches_jax(jax_step_out, threshold):
    (jk, js, jc, jn), jargs = jax_step_out
    fn, (keys, values, thr) = tentry.entry("cpu")
    np.testing.assert_array_equal(keys.numpy(), jargs[0])
    np.testing.assert_array_equal(values.numpy(), jargs[1])
    assert thr == int(jargs[2])
    if threshold == "tensor":  # a 0-d tensor on the keys' device
        thr = torch.tensor(thr, device=keys.device)
    gk, s, c, n = fn(keys, values, thr)
    n = int(n)
    assert n == int(jn) == 128
    for got, exp in ((gk, jk), (s, js), (c, jc)):
        assert got.shape == exp.shape == (tentry.MAX_GROUPS,)
        np.testing.assert_array_equal(got[:n].numpy(), exp[:n])
    # and against numpy
    k, v = jargs[0], jargs[1]
    m = v > 500
    np.testing.assert_array_equal(gk[:n].numpy(), np.unique(k[m]))
    np.testing.assert_array_equal(s[:n].numpy(), np.bincount(
        k[m], weights=v[m], minlength=128).astype(np.int64))
    np.testing.assert_array_equal(c[:n].numpy(),
                                  np.bincount(k[m], minlength=128))


def test_entry_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: entry() runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry()


def _jax_first_step_groups():
    """``__graft_entry__.dryrun_multichip``'s first step on JAX's 8-device
    virtual mesh, as key -> (sum, count)."""
    n_dev, rows_per_dev = 8, 64
    mesh = jmesh.make_mesh(n_dev)
    sharding = jmesh.row_sharding(mesh)
    rng = np.random.default_rng(0)
    nl = nr = n_dev * rows_per_dev

    def shard(a):
        return jax.device_put(a, sharding)

    lk = shard(rng.integers(0, 32, nl).astype(np.int64))
    lv = shard(rng.integers(1, 10, nl).astype(np.int64))
    rk = shard(rng.integers(0, 32, nr).astype(np.int64))
    rv = shard(rng.integers(1, 10, nr).astype(np.int64))
    valid = shard(np.ones(nl, dtype=bool))
    step = jdo.make_dist_join_groupby(
        mesh, capacity=rows_per_dev * 4, join_capacity=rows_per_dev * 64,
        max_groups=64, agg_funcs=("sum", "count"))
    gk, (s, c), gvalid, overflow = step(lk, valid, lv, rk, valid, rv)
    assert not bool(np.asarray(overflow))
    gk, s, c, gvalid = map(np.asarray, (gk, s, c, gvalid))
    return {int(k): (int(sv), int(cv))
            for k, sv, cv in zip(gk[gvalid], s[gvalid], c[gvalid])}


def test_dryrun_multichip_on_cpu_shards_matches_jax(capsys):
    out = tentry.dryrun_multichip(8, devices=["cpu"] * 8)
    assert out["groups"] > 0 and out["groups"] == len(out["group_map"])
    assert 1 <= out["retries"] <= 8
    assert out["final_join_cap"] == 4 * 4 ** out["retries"]
    assert out["skew_groups"] > 0
    assert out["shuffle_ms"] > 0 and out["local_ms"] > 0
    assert out["group_map"] == _jax_first_step_groups()
    printed = capsys.readouterr().out
    assert f"dryrun_multichip(8): OK — {out['groups']} groups" in printed


def test_dryrun_multichip_group_map_is_the_join_groupby():
    """The first step's groups as numpy computes them: per key, the sum of
    ``l.v * r.v`` over the key's pairs and the number of pairs."""
    out = tentry.dryrun_multichip(4, devices=["cpu"] * 4)
    rng = np.random.default_rng(0)
    n = 4 * 64
    lk, lv = rng.integers(0, 32, n), rng.integers(1, 10, n)
    rk, rv = rng.integers(0, 32, n), rng.integers(1, 10, n)
    ls = np.bincount(lk, weights=lv, minlength=32)
    rs = np.bincount(rk, weights=rv, minlength=32)
    lc, rc = np.bincount(lk, minlength=32), np.bincount(rk, minlength=32)
    exp = {k: (int(ls[k] * rs[k]), int(lc[k] * rc[k]))
           for k in range(32) if lc[k] and rc[k]}
    assert out["group_map"] == exp


def test_dryrun_multichip_needs_cuda_devices():
    if torch.cuda.device_count() >= 8:
        pytest.skip("eight GPUs are present")
    with pytest.raises(ValueError, match="need 8 devices"):
        tentry.dryrun_multichip(8)
    with pytest.raises(ValueError, match="need 8 devices"):
        tentry.dryrun_multichip(8, devices=["cpu"] * 3)


def test_entry_module_main(capsys):
    assert tentry.main(["--device", "cpu",
                        "--mesh-devices", ",".join(["cpu"] * 8)]) == 0
    printed = capsys.readouterr().out
    assert "entry(): OK — 128 groups" in printed
    assert "dryrun_multichip(8): OK" in printed
