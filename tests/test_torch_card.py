"""The port on an NVIDIA GPU, without JAX.

Every test here is ``cuda``-marked and skips without a GPU; the file
imports neither JAX nor the JAX package, so it runs on a machine that has
neither:

    python -m pytest --noconftest tests/test_torch_card.py -m cuda

- ``CARD_QUERIES`` (the parity corpus with the UNIONs, the kernels'
  shapes and the edge values) and the fuzz queries of
  ``tests/torch_corpus.py`` on ``TorchOlapEngine(device="cuda")``, each on
  ``torch-cuda`` and equal to the port's NumPy oracle (rows as multisets;
  integers and strings exactly, floats within ``rtol = atol = 1e-12``).
  The port's oracle is held to the JAX package's oracle on these same
  queries and tables by ``tests/test_torch_corpus.py``
  (``test_oracles_agree_on_part_a`` and ``_part_b``), on the CPU.
  ``chip_smoke.py``'s ``engine_corpus`` phase runs the same corpora and
  the path fuzzers at scale.
- The pinned-buffer feeder on its copy stream against the CPU feeder.
- The float SUM/AVG probes of ``tests/test_torch_float_sums.py`` on
  ``torch-cuda``, every group within its own summation bound of
  ``math.fsum``, and the segmented sum twice bit-equal with no host sync.
"""

import numpy as np
import pytest
import torch

import torch_corpus as corpus
from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine
from gpu_olap_tpu_torch.mem.arena import BufferArena
from gpu_olap_tpu_torch.mem.feeder import DeviceFeeder


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _oracle(eng):
    oracle = TorchOlapEngine(EngineConfig(backend="cpu"), device="cpu")
    oracle.catalog = eng.catalog
    return oracle


@pytest.mark.cuda
def test_cuda_port_matches_oracle_on_corpus():
    """The parity corpus and the fuzz queries on the GPU: every query must
    run on the card (``torch-cuda``) and equal the oracle."""
    _need_gpu()
    port = TorchOlapEngine(EngineConfig(), device="cuda")
    corpus.populate(port, np.random.default_rng(123))
    corpus.edge_tables(port, np.random.default_rng(5))
    oracle = _oracle(port)
    for sql in corpus.CARD_QUERIES:
        got = port.query(sql)
        assert got.metrics["backend"] == "torch-cuda", sql
        corpus.assert_same_result(got, oracle.query(sql), sql, sql)
    for seed in range(corpus.N_QUERIES):
        t1, t2, sql = corpus.fuzz_case(seed)
        port.register("t1", t1)
        port.register("t2", t2)
        got = port.query(sql)
        assert got.metrics["backend"] == "torch-cuda", sql
        corpus.assert_same_result(got, oracle.query(sql), sql,
                                  f"seed {seed}: {sql}")


@pytest.mark.cuda
def test_pinned_feeder_on_cuda_matches_cpu_feeder():
    """Pinned staging buffers uploaded on the feeder's copy stream give the
    CPU feeder's chunks, each buffer refilled only after the step that read
    its upload finished."""
    _need_gpu()
    dev = torch.device("cuda", 0)
    arena = BufferArena(pinned=True)
    rng = np.random.default_rng(3)
    host = [rng.integers(-1000, 1000, 1 << 20).astype(np.int32)
            for _ in range(12)]
    staged = []

    def staged_chunks():
        for h in host:
            buf = arena.acquire(h.size, np.int32)
            buf[:h.size] = h
            staged.append(buf)
            yield (buf[:h.size], {"n": h.size})

    sums, pending = [], []
    for dev_chunk in DeviceFeeder(num_buffers=3, device=dev).feed(
            staged_chunks()):
        arr, meta = dev_chunk
        assert arr.device == dev and meta["n"] == arr.numel()
        sums.append(arr.to(torch.int64).sum())
        done = torch.cuda.Event()
        done.record()
        pending.append((staged.pop(0), done))
        if len(pending) > 3:
            buf, ev = pending.pop(0)
            ev.synchronize()
            arena.release(buf)
    cpu = [int(c[0].to(torch.int64).sum()) for c in
           DeviceFeeder(num_buffers=3).feed((h, {"n": h.size}) for h in host)]
    assert [int(s) for s in sums] == cpu == [int(h.sum()) for h in host]


@pytest.mark.cuda
def test_cuda_float_group_sums_hold_their_own_bounds():
    _need_gpu()
    from gpu_olap_tpu_torch.ops import aggregate as A

    for name in corpus.FLOAT_SUM_PROBES:
        table = corpus.float_sum_table(name)
        port = TorchOlapEngine(EngineConfig(enable_cache=False),
                               device="cuda")
        port.register("t", table)
        k = table.column("k").to_numpy()
        v = table.column("v").to_numpy(zero_copy_only=False)
        for agg in ("", "DISTINCT "):
            sql = (f"SELECT k, SUM({agg}v) AS s, AVG({agg}v) AS a FROM t "
                   "GROUP BY k ORDER BY k")
            got = port.query(sql)
            assert got.metrics["backend"] == "torch-cuda", sql
            got = got.to_pydict()
            for i, g in enumerate(got["k"]):
                x = v[(k == g) & ~np.isnan(v)]
                x = np.unique(x) if agg else x
                exp, bound = corpus.own_sum(x)
                assert abs(got["s"][i] - exp) <= bound, (sql, g)
                assert abs(got["a"][i] - exp / len(x)) <= bound / len(x)
    # the operator alone: deterministic, and no host sync
    kk, vv = corpus.float_sum_probe("large_first")
    flags = torch.from_numpy(np.r_[True, kk[1:] != kk[:-1]]).cuda()
    starts, ends, _ = A._dense_boundaries(
        flags, flags.sum(dtype=torch.int64), len(kk), 8)
    x = torch.from_numpy(vv).cuda()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = A._sum_by_boundary(x, starts, ends)
        b = A._sum_by_boundary(x, starts, ends)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    assert a[:3].tolist() == [1e17, 3.0, 17500.0]
