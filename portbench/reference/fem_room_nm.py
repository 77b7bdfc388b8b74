"""Plain reference of the FEM room sweep: the P1 Helmholtz system of a
unit-cube room, built and solved in float64 with torch and numpy alone.

The room is the box [0, 1]^3 cut into n^3 cubes of six Kuhn tetrahedra
each, nodes numbered x fastest, then y, then z. Every wall absorbs with
the same coefficient alpha, so the system at wavenumber k is

    (K - k^2 M - i alpha k B) p = b,

K the stiffness, M the mass, B the mass of the boundary faces, all with
their exact P1 element matrices, and b the load of a Gaussian monopole of
width sigma integrated by the four-point degree-2 rule on each
tetrahedron. The solve is a Jacobi-preconditioned conjugate orthogonal
conjugate gradient (the system is complex symmetric), run until the true
float64 residual is below ``tol`` of ||b||; the answer at a listener is
the pressure of the node nearest to it.

``round_operands`` emulates a lower precision: when given, it is applied
to the operator's values and to the vector of every matrix-vector product
and the iteration runs in float32, as a tensor-core product in TF32 would.
Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Kuhn cut of the cube into six tetrahedra sharing the diagonal 000-111;
# corners as (dx, dy, dz).
_KUHN = (
    ((0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)),
    ((0, 0, 0), (1, 1, 0), (0, 1, 0), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 1), (0, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (1, 0, 1), (1, 0, 0), (1, 1, 1)),
)

# Degree-2 rule on the reference tetrahedron (weights sum to 1/6).
_A = (5.0 + 3.0 * math.sqrt(5.0)) / 20.0
_B = (5.0 - math.sqrt(5.0)) / 20.0
TET_POINTS = np.array([[_B, _B, _B], [_A, _B, _B], [_B, _A, _B], [_B, _B, _A]])
TET_WEIGHTS = np.full(4, 1.0 / 24.0)


def box_mesh(n: int):
    """(nodes (N, 3), tets (6 n^3, 4)) of the unit cube."""
    xs = np.linspace(0.0, 1.0, n + 1)
    z, y, x = np.meshgrid(xs, xs, xs, indexing="ij")
    nodes = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    i, j, k = (a.ravel() for a in np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                                              indexing="ij"))

    def nid(dx, dy, dz):
        return (k + dz) * (n + 1) ** 2 + (j + dy) * (n + 1) + (i + dx)

    tets = np.concatenate([np.stack([nid(*c) for c in tet], axis=1) for tet in _KUHN])
    return nodes, tets


def boundary_faces(tets: np.ndarray) -> np.ndarray:
    """Faces (M, 3) that belong to exactly one tetrahedron."""
    faces = np.concatenate([tets[:, [0, 1, 2]], tets[:, [0, 1, 3]], tets[:, [0, 2, 3]],
                            tets[:, [1, 2, 3]]])
    key = np.sort(faces, axis=1)
    _, first, counts = np.unique(key, axis=0, return_index=True, return_counts=True)
    return faces[first[counts == 1]]


def gaussian_load(nodes, tets, source, sigma: float) -> np.ndarray:
    """b_i = int f phi_i of f = exp(-|x - s|^2 / (2 sigma^2)) / (2 pi sigma^2)^(3/2)."""
    pts = nodes[tets]  # (E, 4, 3)
    lam = np.concatenate([1.0 - TET_POINTS.sum(axis=1, keepdims=True), TET_POINTS], axis=1)
    xq = np.einsum("qv,evd->eqd", lam, pts)
    f = np.exp(-np.sum((xq - np.asarray(source)) ** 2, axis=-1) / (2.0 * sigma**2))
    f /= (2.0 * math.pi * sigma**2) ** 1.5
    det = np.abs(np.linalg.det(pts[:, 1:] - pts[:, :1]))  # 6 |volume|
    contrib = np.einsum("q,e,eq,qv->ev", TET_WEIGHTS, det, f, lam)
    b = np.zeros(len(nodes))
    np.add.at(b, tets.ravel(), contrib.ravel())
    return b


def element_matrices(nodes, tets, faces):
    """COO (rows, cols, K, M, B) of the exact P1 element matrices."""
    pts = nodes[tets]
    jac = pts[:, 1:] - pts[:, :1]  # (E, 3, 3), rows are edge vectors
    vol = np.abs(np.linalg.det(jac)) / 6.0
    grads_ref = np.array([[-1.0, -1.0, -1.0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    g = np.einsum("vk,edk->evd", grads_ref, np.linalg.inv(jac))  # d phi_v / d x_d
    ke = vol[:, None, None] * np.einsum("evd,ewd->evw", g, g)
    me = vol[:, None, None] / 20.0 * (np.ones((4, 4)) + np.eye(4))
    fp = nodes[faces]
    area = 0.5 * np.linalg.norm(np.cross(fp[:, 1] - fp[:, 0], fp[:, 2] - fp[:, 0]), axis=1)
    be = area[:, None, None] / 12.0 * (np.ones((3, 3)) + np.eye(3))
    rows = np.concatenate([np.repeat(tets, 4, axis=1).ravel(), np.repeat(faces, 3, axis=1).ravel()])
    cols = np.concatenate([np.tile(tets, (1, 4)).ravel(), np.tile(faces, (1, 3)).ravel()])
    zeros_v, zeros_f = np.zeros(ke.size), np.zeros(be.size)
    k = np.concatenate([ke.ravel(), zeros_f])
    m = np.concatenate([me.ravel(), zeros_f])
    b = np.concatenate([zeros_v, be.ravel()])
    return rows, cols, k, m, b


def ell_tables(n_nodes, rows, cols, *values):
    """Sum duplicate (row, col) entries and lay each row out as a fixed
    width: (cols (N, W) int64, [values (N, W)] float64); padding points at
    the row's own node with value 0."""
    key = rows.astype(np.int64) * n_nodes + cols
    uniq, inv = np.unique(key, return_inverse=True)
    summed = [np.bincount(inv, weights=v, minlength=len(uniq)) for v in values]
    r, c = uniq // n_nodes, uniq % n_nodes
    counts = np.bincount(r, minlength=n_nodes)
    width = int(counts.max())
    pos = np.arange(len(uniq)) - np.repeat(np.cumsum(counts) - counts, counts)
    col_tab = np.repeat(np.arange(n_nodes)[:, None], width, axis=1)
    col_tab[r, pos] = c
    tabs = []
    for s in summed:
        t = np.zeros((n_nodes, width))
        t[r, pos] = s
        tabs.append(t)
    return col_tab, tabs


class RoomSystem:
    """The room's float64 operator pieces on ``device``."""

    def __init__(self, n: int, absorption: float, source, sigma: float, listeners, device):
        nodes, tets = box_mesh(n)
        faces = boundary_faces(tets)
        rows, cols, k, m, b = element_matrices(nodes, tets, faces)
        col_tab, (kt, mt, bt) = ell_tables(len(nodes), rows, cols, k, m, b)
        self.device = torch.device(device)

        def as_t(a, dt=torch.float64):
            return torch.as_tensor(a, dtype=dt, device=self.device)

        self.cols = as_t(col_tab, torch.int64)
        self.k, self.m, self.b = as_t(kt), as_t(mt), as_t(bt)
        self.alpha = float(absorption)
        self.rhs = as_t(gaussian_load(nodes, tets, source, sigma))
        lp = np.asarray(listeners, np.float64)
        self.listen_idx = as_t(np.argmin(((nodes[None] - lp[:, None]) ** 2).sum(-1), axis=1),
                               torch.int64)
        self.num_nodes = len(nodes)

    def values(self, ks: torch.Tensor) -> torch.Tensor:
        """(N, W, L) complex128 entries of K - k^2 M - i alpha k B per lane."""
        k = ks.to(torch.complex128)[None, None, :]
        return (self.k[..., None] - k * k * self.m[..., None]
                - 1j * self.alpha * k * self.b[..., None])

    def solve(self, ks, tol: float = 1e-11, max_iter: int = 20000, round_operands=None):
        """(listener pressures (L, n_listeners) complex128, iterations,
        true relative residual (L,) in float64)."""
        ks = torch.as_tensor(ks, dtype=torch.float64, device=self.device)
        vals = self.values(ks)
        cols = self.cols
        if round_operands is None:
            work = torch.complex128
            vals_w = vals
            rnd = lambda v: v  # noqa: E731
        else:
            work = torch.complex64
            vals_w = round_operands(vals.to(work))
            rnd = round_operands

        def matvec(x, v=vals_w, r=rnd):
            return torch.sum(v * r(x)[cols], dim=1)

        b = self.rhs.to(work)[:, None].expand(-1, len(ks)).contiguous()
        inv_d = 1.0 / _diagonal(vals_w, cols)
        x = torch.zeros_like(b)
        r = b.clone()
        z = inv_d * r
        p = z.clone()
        rho = torch.sum(r * z, dim=0)
        b_norm = torch.linalg.vector_norm(b, dim=0)
        best_x, best_res = x.clone(), b_norm.clone()
        it, stalled = 0, 0
        while it < max_iter and stalled < 8:
            for _ in range(25):
                q = matvec(p)
                alpha = rho / torch.sum(p * q, dim=0)
                x = x + alpha * p
                r = r - alpha * q
                z = inv_d * r
                rho_new = torch.sum(r * z, dim=0)
                p = z + (rho_new / rho) * p
                rho = rho_new
            it += 25
            res = torch.linalg.vector_norm(r, dim=0)
            better = torch.isfinite(res) & (res < 0.9 * best_res)
            best_x = torch.where(better[None, :], x, best_x)
            best_res = torch.where(better, res, best_res)
            # a lower precision stalls far above tol: stop after 200 steps
            # that gained less than 10% on any lane
            stalled = 0 if bool(better.any()) else stalled + 1
            if bool((best_res <= tol * b_norm).all()):
                break
        x64 = best_x.to(torch.complex128)
        true_r = self.rhs[:, None] - torch.sum(vals * x64[cols], dim=1)
        rel = torch.linalg.vector_norm(true_r, dim=0) / torch.linalg.vector_norm(self.rhs)
        return x64[self.listen_idx].T, it, rel


def _diagonal(vals, cols):
    """(N, L) main diagonal from the ELL layout."""
    n = cols.shape[0]
    own = cols == torch.arange(n, device=cols.device)[:, None]
    # padding also points at the row's own node but carries zeros
    return torch.sum(vals * own[..., None], dim=1)
