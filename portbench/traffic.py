"""The one traffic generator. A traffic mix is a JSON file of parameters
under ``workloads/``; this module turns it and a seed into the inputs of
a closed loop with one caller: each sweep's band of wavenumbers and, where
the mix asks for it, each sweep's plane-wave direction. No size and no
count of work depends on the seed: every seed draws the same grids in
other offsets and other directions.

Parameters read here:

- ``lanes``: wavenumbers per sweep; ``band``: [low, high]. Sweep i's band
  is the uniform grid low + (j + u_i) (high - low) / lanes, j = 0 ..
  lanes - 1, u_i uniform in [0, 1): every sweep the same count and spacing,
  shifted by its own offset, sorted ascending.
- ``incidence``: "sphere" draws each sweep's plane-wave direction uniformly
  on the unit sphere.
- ``check``: {"sweeps": S, "lanes": L}: the sample that the correctness
  check compares, S finished sweeps (the last always among them) and L
  lanes of each, drawn from the seed.
"""

from __future__ import annotations

import numpy as np

_WARM = 1 << 40  # sweep indices of the warm-up inputs, never used in a window


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


class Traffic:
    def __init__(self, params: dict, seed: int):
        self.params = params
        self.seed = int(seed)

    def sweep(self, i: int) -> dict:
        """Inputs of sweep i: ``ks`` (lanes,) float64 and, with incidence,
        ``direction`` (3,)."""
        p = self.params
        rng = _rng(self.seed, 1, i)
        lo, hi = p["band"]
        lanes = int(p["lanes"])
        ks = lo + (np.arange(lanes) + rng.random()) * (hi - lo) / lanes
        out = {"ks": ks}
        if p.get("incidence") == "sphere":
            d = rng.standard_normal(3)
            out["direction"] = d / np.linalg.norm(d)
        return out

    def warm(self, j: int) -> dict:
        """Inputs of the j-th warm-up sweep: the window's shapes."""
        return self.sweep(_WARM + j)

    def check_sample(self, finished: int):
        """[(sweep index, sorted lane indices)] to compare, the last
        finished sweep first."""
        c = self.params["check"]
        rng = _rng(self.seed, 2)
        others = rng.permutation(max(finished - 1, 0))[: max(int(c["sweeps"]) - 1, 0)]
        sweeps = [finished - 1, *sorted(int(s) for s in others)]
        lanes = int(self.params["lanes"])
        take = min(int(c["lanes"]), lanes)
        return [(s, sorted(int(x) for x in rng.choice(lanes, take, replace=False)))
                for s in sweeps]

