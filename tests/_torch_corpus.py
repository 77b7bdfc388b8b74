"""The room-config corpus (``configs/*.json``) clamped to smoke-test size,
for the port-vs-reference corpus tests (test_torch_config_corpus_*.py).

``smoke_clamp`` is tests/test_config_corpus.py's ``_smoke_clamp`` over
either package's classes: each side loads the file with its own
``RoomConfig`` and clamps it with its own ``SurfaceSpec``, so the two
configs agree field for field without one package's objects reaching the
other.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"
CONFIGS = sorted(CONFIG_DIR.glob("*.json"))
SPL_TOL_DB = 1e-6  # dB, per frequency and listening position (measured <= 5.7e-14 on one host)


def smoke_clamp(cfg, mesh_resolution: int, surface_spec):
    """2 frequencies up to 120 Hz, the given mesh resolution, GMRES tol at
    least 1e-7 and at most 400 iterations, no slices; an all-rigid room gets
    absorption 0.1 on every wall (the undamped operator is singular at the
    room's resonances)."""
    cfg.frequencies.num_points = 2
    cfg.frequencies.max_freq = min(cfg.frequencies.max_freq, 120.0)
    cfg.solver.mesh_resolution = mesh_resolution
    cfg.solver.gmres.tolerance = max(cfg.solver.gmres.tolerance, 1e-7)
    cfg.solver.gmres.max_iter = min(cfg.solver.gmres.max_iter, 400)
    cfg.visualization.generate_slices = False
    b = cfg.boundaries
    if all(s.kind == "rigid" for s in b.wall_specs().values()):
        damp = surface_spec("absorption", coefficient=0.1)
        b.floor = b.ceiling = b.walls = damp
        b.front_wall = b.back_wall = b.left_wall = b.right_wall = None
    return cfg


def bem_clamp(cfg, surface_spec):
    """The BEM smoke's clamp: resolution 1, or 2 for rooms under 20 m^3
    (which have too few elements at 1)."""
    cfg = smoke_clamp(cfg, 1, surface_spec)
    w, d, h = cfg.to_simulation().geometry.dimensions()
    if w * d * h < 20.0:
        cfg.solver.mesh_resolution = 2
    return cfg


def spl_matrix(results) -> np.ndarray:
    """(frequencies, listening positions) SPL in dB of a SimulationResults."""
    return np.array([r.spl_db for r in results.results], dtype=float)


def key_paths(value, prefix=()):
    """Every key path of a JSON-like value: through dicts, and through the
    first element of each list (the lists of one output are uniform)."""
    out = set()
    if isinstance(value, dict):
        for k, v in value.items():
            out.add(prefix + (k,))
            out |= key_paths(v, prefix + (k,))
    elif isinstance(value, (list, tuple)) and value:
        out |= key_paths(value[0], prefix + ("[]",))
    return out
