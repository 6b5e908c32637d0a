"""Global host arrays of the distributed steps' tests, made with numpy from
a seed: shared by ``test_torch_parallel.py`` (one process, against JAX) and
``test_torch_multiprocess.py`` (ranks of a process group, whose workers and
whose ``cuda``-marked twin import no JAX)."""

import numpy as np

from gpu_olap_tpu_torch.parallel import skew as tskew

NDEV = 8


def step_arrays(kind, seed=3):
    """The fused step's global host arrays: (lkeys, lvalid, lval, rkeys,
    rvalid, rval)."""
    rng = np.random.default_rng(seed)
    nl, nr = NDEV * 512, NDEV * 128
    lk = rng.integers(0, 64, nl).astype(np.int64)
    rk = np.arange(64, dtype=np.int64).repeat(16)
    if kind == "float":
        lv, rv = rng.normal(0, 10, nl), rng.normal(5, 3, nr)
    else:
        lv = rng.integers(1, 10, nl).astype(np.int64)
        rv = rng.integers(1, 5, nr).astype(np.int64)
    return lk, np.ones(nl, bool), lv, rk, np.ones(nr, bool), rv


def skew_arrays():
    """Zipf-like global host arrays (key 7 on 60 % of the probe rows) and
    their heavy keys."""
    rng = np.random.default_rng(9)
    n = NDEV * 1024
    lk = np.where(rng.random(n) < 0.6, 7, rng.integers(0, 64, n)).astype(
        np.int64)
    lv = rng.integers(1, 10, n).astype(np.int64)
    rk = np.resize(np.arange(64, dtype=np.int64).repeat(4), NDEV * 32)
    rv = rng.integers(1, 5, rk.shape[0]).astype(np.int64)
    heavy = tskew.detect_heavy_keys(lk, row_threshold=n // 10)
    return (lk, np.ones(n, bool), lv, rk, np.ones(rk.shape[0], bool),
            rv), heavy
