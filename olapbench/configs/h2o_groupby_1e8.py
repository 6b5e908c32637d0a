"""The db-benchmark group-by table ``x``, made on the device from the seed.

Columns as ``groupby-datagen.R`` makes them (``h2o_groupby_1e8.json``
states each); ``v3`` is ``k / 1e6`` for an integer ``k``, and ``k`` is kept
as the extra table ``x_exact`` that the reference alone reads.
"""

from __future__ import annotations

import torch

from olapbench.core.tables import Tables

def domains(cfg) -> dict:
    return {}

def generate(cfg, seed: int, device, scale: float = 1.0) -> Tables:
    n = max(1, int(round(cfg["x"]["rows"] * scale)))
    k = cfg["K"]
    nk = max(1, n // k)
    t = Tables({"x": {c: w for c, (_, w) in cfg["x"]["columns"].items()},
                "x_exact": {"v3_micro": 8}})
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def randint(lo, hi, dtype=torch.int32):  # uniform over [lo, hi]
        return torch.randint(lo, hi + 1, (n,), generator=g, device=device,
                             dtype=dtype).cpu().numpy()

    small = [f"id{i:03d}" for i in range(1, k + 1)]
    t.add("x", "id1", randint(0, k - 1), small)
    t.add("x", "id2", randint(0, k - 1), small)
    t.add("x", "id3", randint(0, nk - 1),
          [f"id{i:010d}" for i in range(1, nk + 1)])
    t.add("x", "id4", randint(1, k))
    t.add("x", "id5", randint(1, k))
    t.add("x", "id6", randint(1, nk))
    t.add("x", "v1", randint(1, 5))
    t.add("x", "v2", randint(1, 15))
    micro = randint(0, 10**8 - 1, torch.int64)
    t.add("x", "v3", micro / 1e6)
    t.add("x_exact", "v3_micro", micro)
    return t
