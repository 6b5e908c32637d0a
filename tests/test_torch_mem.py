"""The port's staging arena and device feeder against the JAX package's.

Twins of ``tests/test_mem.py``: each runs the same calls on
``gpu_olap_tpu.mem`` and ``gpu_olap_tpu_torch.mem`` and checks both give
the same buffers, counts and chunks.  The reduction twin runs a torch step
through the port's ``stream_reduce``.  The pinned-buffer feeder on its
copy stream is held against the CPU feeder in ``tests/test_torch_card.py``,
which imports no JAX and so runs on a GPU machine without it.
"""

import numpy as np
import pytest
import torch

from gpu_olap_tpu.mem import arena as jarena
from gpu_olap_tpu.mem import feeder as jfeeder
from gpu_olap_tpu_torch.mem.arena import BufferArena, size_class
from gpu_olap_tpu_torch.mem.feeder import DeviceFeeder, pad_chunk, stream_reduce


def test_size_class_selection():
    for n in (1, 1024, 1025, 3000, 1 << 20, 1_000_000):
        assert size_class(n) == jarena.size_class(n)
    assert size_class(1) == 1024
    assert size_class(1025) == 2048
    assert size_class(3000) == 4096


def test_arena_reuse():
    for arena in (BufferArena(max_bytes=1 << 20),
                  jarena.BufferArena(max_bytes=1 << 20)):
        a = arena.acquire(1000, np.int64)
        assert a.shape[0] == 1024
        arena.release(a)
        b = arena.acquire(900, np.int64)
        assert b is a  # pooled buffer reused (O(1) pop)
        assert arena.stats()["allocated_bytes"] == 1024 * 8


def test_arena_limit():
    for arena in (BufferArena(max_bytes=1024 * 8),
                  jarena.BufferArena(max_bytes=1024 * 8)):
        arena.acquire(1024, np.int64)
        with pytest.raises(MemoryError):
            arena.acquire(1024, np.int64)


def test_arena_pool_cap():
    stats = []
    for arena in (BufferArena(max_bytes=1 << 30, max_buffers_per_class=1),
                  jarena.BufferArena(max_bytes=1 << 30,
                                     max_buffers_per_class=1)):
        a = arena.acquire(10, np.int64)
        b = arena.acquire(10, np.int64)
        arena.release(a)
        arena.release(b)  # pool full -> dropped and deallocated
        stats.append(arena.stats())
    assert stats[0] == stats[1]
    assert stats[0]["allocated_bytes"] == 1024 * 8


def test_feeder_yields_all_chunks_in_order():
    chunks = [np.full(4, i) for i in range(7)]
    got = list(DeviceFeeder(num_buffers=2).feed(iter(chunks)))
    exp = list(jfeeder.DeviceFeeder(num_buffers=2).feed(iter(chunks)))
    assert len(got) == len(exp) == 7
    for i, (g, e) in enumerate(zip(got, exp)):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        assert int(g[0]) == i


def test_feeder_single_buffer():
    got = list(DeviceFeeder(num_buffers=1).feed(iter([np.zeros(2)])))
    exp = list(jfeeder.DeviceFeeder(num_buffers=1).feed(iter([np.zeros(2)])))
    assert len(got) == len(exp) == 1
    with pytest.raises(ValueError):
        DeviceFeeder(num_buffers=0)


def test_pad_chunk():
    for n in (5, 8):
        got = pad_chunk(np.arange(n), 8)
        exp = jfeeder.pad_chunk(np.arange(n), 8)
        assert got.shape == (8,)
        np.testing.assert_array_equal(got, exp)


def test_stream_reduce_out_of_core_sum():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def jstep(state, chunk):
        return state + jnp.sum(chunk)

    def tstep(state, chunk):
        return state + chunk.sum()

    def chunks():
        return (np.full(100, i, dtype=np.int64) for i in range(10))

    exp = jfeeder.stream_reduce(chunks(), jstep, jnp.asarray(0, jnp.int64),
                                num_buffers=3)
    got = stream_reduce(chunks(), tstep, torch.tensor(0, dtype=torch.int64),
                        num_buffers=3)
    assert int(got) == int(exp) == sum(100 * i for i in range(10))
