"""The one general traffic generator: passes over a mix's queries, each with
its constants drawn from the mix's domains.

A mix file (``mixes/<config>/<traffic>.json``) names its queries and, for
each, how each constant is drawn, in order (a later constant may depend on
an earlier one):

- ``{"int": [lo, hi]}``: uniform over ``lo..hi``;
- ``{"among": [values]}`` or ``{"among": "<domain>"}``: uniform over the
  list, or over the configuration's domain of that name (``domains()`` of
  ``configs/<config>.py``); with ``"of": "<constant>"`` the domain is a
  mapping and the list is the one under that constant's value; with
  ``"distinct": k``, ``k`` distinct values;
- ``{"add": ["<constant>", k]}``: that constant plus ``k``.

A pass runs every query of the mix once, in a permutation drawn from the
seed.  The same seed gives the same queries with the same constants.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, Tuple


def draw(spec: Dict[str, dict], rng: random.Random, domains: dict) -> dict:
    out: dict = {}
    for name, d in spec.items():
        if "int" in d:
            lo, hi = d["int"]
            out[name] = rng.randint(lo, hi)
        elif "add" in d:
            ref, k = d["add"]
            out[name] = out[ref] + k
        elif "among" in d:
            pool = d["among"]
            if isinstance(pool, str):
                pool = domains[pool]
                if "of" in d:
                    pool = pool[str(out[d["of"]])]
            pool = list(pool)
            out[name] = (rng.sample(pool, d["distinct"]) if "distinct" in d
                         else rng.choice(pool))
        else:
            raise ValueError(f"constant {name!r}: unknown draw {d}")
    return out


def stream(mix: dict, seed: int, domains: dict,
           purpose: str = "traffic") -> Iterator[Tuple[str, dict]]:
    """Endless (query, constants) pairs, pass after pass."""
    rng = random.Random(f"{seed}/{purpose}")
    queries = list(mix["queries"])
    params = mix.get("params", {})
    while True:
        for q in rng.sample(queries, len(queries)):
            yield q, draw(params.get(q, {}), rng, domains)
