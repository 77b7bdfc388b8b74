"""Built-in hull test geometries (counterpart of
mathaudio_tpu/hull/testdata.py; math-convex-hull/src/testdata.rs), from the
same seeded numpy streams."""

from __future__ import annotations

import numpy as np


def cube_points(extra_interior: int = 0, seed: int = 0) -> np.ndarray:
    corners = np.array(
        [[x, y, z] for x in (0.0, 1.0) for y in (0.0, 1.0) for z in (0.0, 1.0)]
    )
    if extra_interior:
        rng = np.random.default_rng(seed)
        inner = 0.2 + 0.6 * rng.random((extra_interior, 3))
        return np.vstack([corners, inner])
    return corners


def sphere_points(n: int = 100, radius: float = 1.0, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3))
    return radius * v / np.linalg.norm(v, axis=1, keepdims=True)


def random_points(n: int = 50, seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).random((n, 3))


def fibonacci_sphere_points(n: int = 180, radius: float = 1.0) -> np.ndarray:
    """Deterministic near-uniform sphere sampling (golden-angle spiral) —
    stand-in for the reference's t-design OBJ fixtures
    (math-convex-hull testdata: every point is extreme, so every point
    must be a hull vertex)."""
    i = np.arange(n)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    z = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return radius * np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def icosahedron_points(radius: float = 1.0) -> np.ndarray:
    """12 icosahedron vertices (testdata.rs icosahedron)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    pts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=float,
    )
    return radius * pts / np.linalg.norm(pts[0])
