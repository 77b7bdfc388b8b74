"""Lagrange shape functions tabulated at quadrature points (counterpart
of mathaudio_tpu/fem/basis.py): P1 triangles and tets, bilinear quads,
trilinear hexes, and the P2 (triangle6, tet10) and P3 (triangle10, tet20)
simplices whose node orders ``fem/refinement.py``'s ``to_p2``/``to_p3``
fix.

Shape values and gradients stay small numpy tables; the assembly turns
them into device tensors of the caller's dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from mathaudio_tpu_torch.fem.mesh import HEX, QUAD, TET, TRIANGLE
from mathaudio_tpu_torch.fem.quadrature import (
    hex_rule,
    quad_rule,
    tet_rule,
    tet_rule_duffy,
    triangle_rule,
    triangle_rule_order,
)


TRIANGLE6 = "triangle6"
TET10 = "tet10"
TRIANGLE10 = "triangle10"  # cubic P3
TET20 = "tet20"  # cubic P3, 20 nodes


def shape_functions(element_type: str, pts: np.ndarray):
    """phi (nq, nv) and grad (nq, nv, dim) at reference points."""
    pts = np.atleast_2d(np.asarray(pts, float))
    nq = pts.shape[0]
    if element_type == TRIANGLE6:
        x, y = pts[:, 0], pts[:, 1]
        l0, l1, l2 = 1 - x - y, x, y
        # node order: v0 v1 v2, m01 m12 m20
        phi = np.stack(
            [
                l0 * (2 * l0 - 1), l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
                4 * l0 * l1, 4 * l1 * l2, 4 * l2 * l0,
            ],
            axis=1,
        )
        g0 = np.array([-1.0, -1.0])
        g1 = np.array([1.0, 0.0])
        g2 = np.array([0.0, 1.0])
        grad = np.stack(
            [
                (4 * l0 - 1)[:, None] * g0,
                (4 * l1 - 1)[:, None] * g1,
                (4 * l2 - 1)[:, None] * g2,
                4 * (l1[:, None] * g0 + l0[:, None] * g1),
                4 * (l2[:, None] * g1 + l1[:, None] * g2),
                4 * (l0[:, None] * g2 + l2[:, None] * g0),
            ],
            axis=1,
        )
        return phi, grad
    if element_type == TRIANGLE10:
        # cubic Lagrange on the triangle; node order: 3 vertices, then two
        # nodes per edge (at 1/3, 2/3 along 01, 12, 20), then the centroid
        x, y = pts[:, 0], pts[:, 1]
        l0, l1, l2 = 1 - x - y, x, y
        g = [np.array([-1.0, -1.0]), np.array([1.0, 0.0]), np.array([0.0, 1.0])]
        ls = [l0, l1, l2]

        def vert(i):
            li = ls[i]
            phi = 0.5 * li * (3 * li - 1) * (3 * li - 2)
            dphi = 0.5 * (27 * li**2 - 18 * li + 2)
            return phi, dphi[:, None] * g[i]

        def edge(i, j, near):
            li, lj = ls[i], ls[j]
            # node at distance 1/3 from vertex `near` along edge i->j
            if near == i:
                phi = 4.5 * li * lj * (3 * li - 1)
                dphi = (
                    4.5 * ((6 * li - 1) * lj)[:, None] * g[i]
                    + 4.5 * (li * (3 * li - 1))[:, None] * g[j]
                )
            else:
                phi = 4.5 * li * lj * (3 * lj - 1)
                dphi = (
                    4.5 * (lj * (3 * lj - 1))[:, None] * g[i]
                    + 4.5 * ((6 * lj - 1) * li)[:, None] * g[j]
                )
            return phi, dphi

        def center():
            phi = 27 * l0 * l1 * l2
            dphi = 27 * (
                (l1 * l2)[:, None] * g[0]
                + (l0 * l2)[:, None] * g[1]
                + (l0 * l1)[:, None] * g[2]
            )
            return phi, dphi

        cols = [vert(0), vert(1), vert(2),
                edge(0, 1, 0), edge(0, 1, 1),
                edge(1, 2, 1), edge(1, 2, 2),
                edge(2, 0, 2), edge(2, 0, 0),
                center()]
        phi = np.stack([c[0] for c in cols], axis=1)
        grad = np.stack([c[1] for c in cols], axis=1)
        return phi, grad
    if element_type == TET20:
        # cubic Lagrange on the tetrahedron; node order: 4 vertices, then
        # per edge (01 02 03 12 13 23) the 1/3-from-a and 1/3-from-b
        # nodes, then the 4 face bubbles (012 013 023 123)
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        ls = [1 - x - y - z, x, y, z]
        gs = [
            np.array([-1.0, -1.0, -1.0]),
            np.array([1.0, 0.0, 0.0]),
            np.array([0.0, 1.0, 0.0]),
            np.array([0.0, 0.0, 1.0]),
        ]

        def vert(i):
            li = ls[i]
            phi = 0.5 * li * (3 * li - 1) * (3 * li - 2)
            return phi, (0.5 * (27 * li**2 - 18 * li + 2))[:, None] * gs[i]

        def edge(a, b, near):
            la, lb = ls[a], ls[b]
            if near == a:
                phi = 4.5 * la * lb * (3 * la - 1)
                dphi = (
                    4.5 * (lb * (6 * la - 1))[:, None] * gs[a]
                    + 4.5 * (la * (3 * la - 1))[:, None] * gs[b]
                )
            else:
                phi = 4.5 * la * lb * (3 * lb - 1)
                dphi = (
                    4.5 * (lb * (3 * lb - 1))[:, None] * gs[a]
                    + 4.5 * (la * (6 * lb - 1))[:, None] * gs[b]
                )
            return phi, dphi

        def face(a, b, c):
            la, lb, lc = ls[a], ls[b], ls[c]
            phi = 27 * la * lb * lc
            dphi = 27 * (
                (lb * lc)[:, None] * gs[a]
                + (la * lc)[:, None] * gs[b]
                + (la * lb)[:, None] * gs[c]
            )
            return phi, dphi

        cols = [vert(i) for i in range(4)]
        for a, b in [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]:
            cols.append(edge(a, b, a))
            cols.append(edge(a, b, b))
        for a, b, c in [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]:
            cols.append(face(a, b, c))
        phi = np.stack([cphi for cphi, _ in cols], axis=1)
        grad = np.stack([cgrad for _, cgrad in cols], axis=1)
        return phi, grad
    if element_type == TET10:
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        l0, l1, l2, l3 = 1 - x - y - z, x, y, z
        ls = [l0, l1, l2, l3]
        gs = [
            np.array([-1.0, -1.0, -1.0]),
            np.array([1.0, 0.0, 0.0]),
            np.array([0.0, 1.0, 0.0]),
            np.array([0.0, 0.0, 1.0]),
        ]
        # node order: v0..v3, then edges 01 02 03 12 13 23
        edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
        phi_cols = [ls[i] * (2 * ls[i] - 1) for i in range(4)] + [
            4 * ls[a] * ls[b] for a, b in edges
        ]
        grad_cols = [(4 * ls[i] - 1)[:, None] * gs[i] for i in range(4)] + [
            4 * (ls[b][:, None] * gs[a] + ls[a][:, None] * gs[b]) for a, b in edges
        ]
        return np.stack(phi_cols, axis=1), np.stack(grad_cols, axis=1)
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
    elif element_type == QUAD:
        x, y = pts[:, 0], pts[:, 1]
        phi = 0.25 * np.stack(
            [(1 - x) * (1 - y), (1 + x) * (1 - y), (1 + x) * (1 + y), (1 - x) * (1 + y)],
            axis=1,
        )
        grad = 0.25 * np.stack(
            [
                np.stack([-(1 - y), -(1 - x)], axis=1),
                np.stack([(1 - y), -(1 + x)], axis=1),
                np.stack([(1 + y), (1 + x)], axis=1),
                np.stack([-(1 + y), (1 - x)], axis=1),
            ],
            axis=1,
        )
    elif element_type == HEX:
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        signs = np.array(
            [
                [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
            ],
            float,
        )
        phi = np.stack(
            [
                0.125 * (1 + sx * x) * (1 + sy * y) * (1 + sz * z)
                for sx, sy, sz in signs
            ],
            axis=1,
        )
        grad = np.stack(
            [
                np.stack(
                    [
                        0.125 * sx * (1 + sy * y) * (1 + sz * z),
                        0.125 * sy * (1 + sx * x) * (1 + sz * z),
                        0.125 * sz * (1 + sx * x) * (1 + sy * y),
                    ],
                    axis=1,
                )
                for sx, sy, sz in signs
            ],
            axis=1,
        )
    else:
        raise ValueError(element_type)
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


# element type -> (rule of the quadrature order, default order, nv, dim);
# the P2/P3 rules are fixed by the degree of their mass integrands
_RULES = {
    TRIANGLE: (triangle_rule, 2, 3, 2),
    TET: (tet_rule, 2, 4, 3),
    QUAD: (quad_rule, 2, 4, 2),
    HEX: (hex_rule, 2, 8, 3),
    TRIANGLE6: (lambda order: triangle_rule_order(max(order * 2, 4)), 2, 6, 2),
    TET10: (lambda order: tet_rule_duffy(4), 2, 10, 3),
    TRIANGLE10: (lambda order: triangle_rule_order(6), 2, 10, 2),
    TET20: (lambda order: tet_rule_duffy(5), 2, 20, 3),
}


def element_tables(element_type: str, order: int = 2) -> ElementTable:
    rule_fn, _, nv, dim = _RULES[element_type]
    pts, w = rule_fn(order)
    phi, grad = shape_functions(element_type, pts)
    return ElementTable(element_type, dim, nv, pts, w, phi, grad)
