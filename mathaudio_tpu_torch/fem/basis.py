"""P1 Lagrange shape functions tabulated at quadrature points
(counterpart of mathaudio_tpu/fem/basis.py, TRIANGLE and TET only).

Shape values and gradients stay small numpy tables; the assembly turns
them into device tensors of the caller's dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from mathaudio_tpu_torch.fem.mesh import TET, TRIANGLE
from mathaudio_tpu_torch.fem.quadrature import tet_rule, triangle_rule


def shape_functions(element_type: str, pts: np.ndarray):
    """phi (nq, nv) and grad (nq, nv, dim) at reference points."""
    pts = np.atleast_2d(np.asarray(pts, float))
    nq = pts.shape[0]
    if element_type == TRIANGLE:
        x, y = pts[:, 0], pts[:, 1]
        phi = np.stack([1 - x - y, x, y], axis=1)
        grad = np.broadcast_to(
            np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]), (nq, 3, 2)
        ).copy()
    elif element_type == TET:
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        phi = np.stack([1 - x - y - z, x, y, z], axis=1)
        grad = np.broadcast_to(
            np.array(
                [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
            ),
            (nq, 4, 3),
        ).copy()
    else:
        raise ValueError(f"element type {element_type!r} is not ported (P1 only)")
    return phi, grad


class ElementTable(NamedTuple):
    """Quadrature + tabulated shapes for one element type."""

    element_type: str
    dim: int
    nv: int
    points: np.ndarray  # (nq, dim)
    weights: np.ndarray  # (nq,)
    phi: np.ndarray  # (nq, nv)
    grad: np.ndarray  # (nq, nv, dim)


_RULES = {
    TRIANGLE: (triangle_rule, 3, 2),
    TET: (tet_rule, 4, 3),
}


def element_tables(element_type: str, order: int = 2) -> ElementTable:
    if element_type not in _RULES:
        raise ValueError(f"element type {element_type!r} is not ported (P1 only)")
    rule_fn, nv, dim = _RULES[element_type]
    pts, w = rule_fn(order)
    phi, grad = shape_functions(element_type, pts)
    return ElementTable(element_type, dim, nv, pts, w, phi, grad)
