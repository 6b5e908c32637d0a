"""The run's surroundings: cache directories inside the checkout, the card's
name, power limit and memory rate, and the modules a run may not load."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
from typing import List

#: top-level module names the measured process may never hold: JAX and the
#: JAX package this port was made from (compared whole: the port's own
#: name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_olap_tpu")

#: device-memory rate (bytes/s) by ``torch.cuda.get_device_name``, from
#: NVIDIA's data sheet: the card every cell runs on
MEMORY_RATE = {"NVIDIA H100 80GB HBM3": 3.35e12}   # H100 SXM5


def use_checkout_caches(root: pathlib.Path) -> None:
    """Point every build and kernel cache at fixed directories inside the
    checkout, so that the first run there builds and later runs hit."""
    base = root / ".olapbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def forbidden_loaded() -> List[str]:
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def memory_rate(card: str) -> float:
    """The card's rate; a card outside the table fails the traced run
    rather than lose the metrics read against it."""
    if card not in MEMORY_RATE:
        raise RuntimeError(f"no memory rate for {card!r} in "
                           f"olapbench/core/env.py: {sorted(MEMORY_RATE)}")
    return MEMORY_RATE[card]


def power_limit() -> str:
    """The first card's power limit as ``nvidia-smi`` prints it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({type(e).__name__})"
    return out.stdout.strip() or f"unknown (rc {out.returncode})"
