"""Quadrature rules (counterpart of mathaudio_tpu/fem/quadrature.py; pure
numpy).

Reference-element conventions:
- triangle: vertices (0,0), (1,0), (0,1); weights sum to area 1/2
- tet:      vertices (0,0,0), (1,0,0), (0,1,0), (0,0,1); weights sum 1/6
- quad/hex: [-1, 1]^d tensor Gauss-Legendre
- segment:  [0, 1]
"""

from __future__ import annotations

import numpy as np

_GAUSS_1D = {
    1: ([0.0], [2.0]),
    2: ([-1 / np.sqrt(3), 1 / np.sqrt(3)], [1.0, 1.0]),
    3: ([-np.sqrt(3 / 5), 0.0, np.sqrt(3 / 5)], [5 / 9, 8 / 9, 5 / 9]),
    4: (
        [-0.8611363115940526, -0.3399810435848563, 0.3399810435848563, 0.8611363115940526],
        [0.3478548451374538, 0.6521451548625461, 0.6521451548625461, 0.3478548451374538],
    ),
    5: (
        [-0.9061798459386640, -0.5384693101056831, 0.0, 0.5384693101056831, 0.9061798459386640],
        [0.2369268850561891, 0.4786286704993665, 0.5688888888888889, 0.4786286704993665,
         0.2369268850561891],
    ),
}


def gauss_1d(n: int):
    if n in _GAUSS_1D:
        x, w = _GAUSS_1D[n]
        return np.asarray(x, float), np.asarray(w, float)
    return np.polynomial.legendre.leggauss(n)


def triangle_rule(order: int):
    """(points (nq,2), weights) exact to degree ``order`` (1/3/4/7-point)."""
    if order <= 1:
        pts = np.array([[1 / 3, 1 / 3]])
        w = np.array([0.5])
    elif order == 2:
        pts = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
        w = np.array([1 / 6, 1 / 6, 1 / 6])
    elif order == 3:
        pts = np.array([[1 / 3, 1 / 3], [0.2, 0.2], [0.6, 0.2], [0.2, 0.6]])
        w = np.array([-27 / 96, 25 / 96, 25 / 96, 25 / 96])
    else:  # 7-point, degree 5
        a = 0.0597158717
        b = 0.4701420641
        c = 0.7974269853
        d = 0.1012865073
        pts = np.array(
            [
                [1 / 3, 1 / 3],
                [a, b], [b, a], [b, b],
                [c, d], [d, c], [d, d],
            ]
        )
        w = 0.5 * np.array(
            [0.225, 0.1323941527, 0.1323941527, 0.1323941527, 0.1259391805, 0.1259391805, 0.1259391805]
        )
    return pts, w


def tet_rule(order: int):
    """(points (nq,3), weights) for the reference tet."""
    if order <= 1:
        pts = np.array([[0.25, 0.25, 0.25]])
        w = np.array([1 / 6])
    elif order == 2:
        a = (5.0 + 3.0 * np.sqrt(5.0)) / 20.0
        b = (5.0 - np.sqrt(5.0)) / 20.0
        pts = np.array([[b, b, b], [a, b, b], [b, a, b], [b, b, a]])
        w = np.full(4, 1 / 24)
    else:  # degree 3, 5-point
        pts = np.array(
            [
                [0.25, 0.25, 0.25],
                [0.5, 1 / 6, 1 / 6],
                [1 / 6, 0.5, 1 / 6],
                [1 / 6, 1 / 6, 0.5],
                [1 / 6, 1 / 6, 1 / 6],
            ]
        )
        w = np.array([-4 / 30, 9 / 120, 9 / 120, 9 / 120, 9 / 120])
    return pts, w


def tet_rule_duffy(n: int = 4):
    """Collapsed (Duffy) tensor rule on the reference tet, exact for
    polynomials up to degree ~2n-3: the P2/P3 mass matrices, where the
    low-order rules run out. Cube (a, b, c) -> tet (a, b(1-a), c(1-a)(1-b))."""
    x, w = gauss_1d(n)
    x = (x + 1.0) / 2.0
    w = w / 2.0
    a, b, c = np.meshgrid(x, x, x, indexing="ij")
    wa, wb, wc = np.meshgrid(w, w, w, indexing="ij")
    pts = np.stack([a, b * (1 - a), c * (1 - a) * (1 - b)], axis=-1).reshape(-1, 3)
    ws = wa * wb * wc * ((1 - a) ** 2 * (1 - b))
    return pts, ws.reshape(-1)


def triangle_rule_order(order: int):
    """Triangle rule exact to degree ``order``: the 7-point rule up to 5, a
    collapsed tensor rule beyond."""
    if order <= 5:
        return triangle_rule(4)
    n = (order + 3) // 2 + 1
    x, w = gauss_1d(n)
    x = (x + 1.0) / 2.0
    w = w / 2.0
    a, b = np.meshgrid(x, x, indexing="ij")
    wa, wb = np.meshgrid(w, w, indexing="ij")
    pts = np.stack([a, b * (1 - a)], axis=-1).reshape(-1, 2)
    return pts, (wa * wb * (1 - a)).reshape(-1)


def quad_rule(n: int = 2):
    """Tensor Gauss rule on [-1, 1]^2 (first coordinate slowest)."""
    x, w = gauss_1d(n)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    return np.stack([xx.reshape(-1), yy.reshape(-1)], axis=1), np.outer(w, w).reshape(-1)


def hex_rule(n: int = 2):
    """Tensor Gauss rule on [-1, 1]^3 (first coordinate slowest)."""
    x, w = gauss_1d(n)
    xx, yy, zz = np.meshgrid(x, x, x, indexing="ij")
    ww = np.einsum("i,j,k->ijk", w, w, w)
    return np.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)], axis=1), ww.reshape(-1)


def segment_rule(n: int = 2):
    """Rule on [0, 1] for boundary edges."""
    x, w = gauss_1d(n)
    return (x + 1.0) / 2.0, w / 2.0
