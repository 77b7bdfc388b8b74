"""Quadrature rules used by P1 assembly (counterpart of
mathaudio_tpu/fem/quadrature.py: the tet, triangle and segment rules).

Reference-element conventions:
- triangle: vertices (0,0), (1,0), (0,1); weights sum to area 1/2
- tet:      vertices (0,0,0), (1,0,0), (0,1,0), (0,0,1); weights sum 1/6
- segment:  [0, 1]
"""

from __future__ import annotations

import numpy as np

_GAUSS_1D = {
    1: ([0.0], [2.0]),
    2: ([-1 / np.sqrt(3), 1 / np.sqrt(3)], [1.0, 1.0]),
    3: ([-np.sqrt(3 / 5), 0.0, np.sqrt(3 / 5)], [5 / 9, 8 / 9, 5 / 9]),
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


def segment_rule(n: int = 2):
    """Rule on [0, 1] for boundary edges."""
    x, w = gauss_1d(n)
    return (x + 1.0) / 2.0, w / 2.0
