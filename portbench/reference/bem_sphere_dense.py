"""Plain reference of the dense BEM scattering sweep: the collocation
system of a rigid sphere under a plane wave, built in float64 with torch
and numpy alone, and the relative residual of a given surface pressure in
that system.

The surface is the icosphere (20 * 4^s flat triangles, vertices on the
unit sphere, normals outward), one constant element per triangle,
collocated at the centroids. With G = e^{ikr} / (4 pi r) and every pair
(i, j) integrated by the four-point degree-3 triangle rule:

    CBIE  A = 1/2 I - D                 b = p_inc
    BM    A = 1/2 I - D + beta T        b = p_inc - beta dp_inc/dn

D the double layer (dG/dn_y), T the hypersingular operator
(n_x . grad_x of dG/dn_y), beta = 4i / (k + 1/h), h the square root of the
mean element area. The singular diagonal keeps the exact static row sums
(sum_j D_0[i, j] = -1/2, sum_j T_0[i, j] = 0 for the k = 0 kernels) and
the analytic radial integral of T_k - T_0 over the element's own
triangle, (1/4 pi) sum_phi w_phi (ik - (e^{ikR} - 1) / R), R(phi) the
centroid-to-edge distance (twelve Gauss points in each vertex sector).

Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI4 = 4.0 * math.pi
# Degree-3 rule on the reference triangle (0,0), (1,0), (0,1).
TRI_POINTS = np.array([[1 / 3, 1 / 3], [0.2, 0.2], [0.6, 0.2], [0.2, 0.6]])
TRI_WEIGHTS = np.array([-27 / 96, 25 / 96, 25 / 96, 25 / 96])
SECTOR_POINTS = 12


def icosphere(subdivisions: int):
    """(vertices (V, 3), triangles (N, 3)) with outward winding."""
    phi = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                      [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                      [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]], float)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                      [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                      [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                      [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdivisions):
        mid, out, vl = {}, [], list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = vl[a] + vl[b]
                mid[key] = len(vl)
                vl.append(m / np.linalg.norm(m))
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            out += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts, faces = np.asarray(vl), np.asarray(out, np.int64)
    pts = verts[faces]
    normal = np.cross(pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 0])
    inward = np.einsum("nd,nd->n", pts.mean(axis=1), normal) < 0
    faces[inward] = faces[inward][:, [0, 2, 1]]
    return verts, faces


def sector_rule(pts, centers, normals):
    """(R (N, 3 * 12), w (N, 3 * 12)): per vertex sector of each triangle,
    Gauss points in angle about the centroid and the distance to the
    opposite edge along each."""
    e1 = pts[:, 0] - centers
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(normals, e1)
    rel = pts - centers[:, None, :]
    v2 = np.stack([np.einsum("nd,nvd->nv", e1, rel), np.einsum("nd,nvd->nv", e2, rel)], -1)
    gx, gw = np.polynomial.legendre.leggauss(SECTOR_POINTS)
    radii, weights = [], []
    for e in range(3):
        a, b = v2[:, e], v2[:, (e + 1) % 3]
        phi_a = np.arctan2(a[:, 1], a[:, 0])
        dphi = np.mod(np.arctan2(b[:, 1], b[:, 0]) - phi_a, 2 * np.pi)
        t = b - a
        n_e = np.stack([t[:, 1], -t[:, 0]], axis=1)
        n_e /= np.linalg.norm(n_e, axis=1, keepdims=True)
        h = np.einsum("nd,nd->n", n_e, a)
        n_e[h < 0] *= -1.0
        h = np.abs(h)
        for q in range(SECTOR_POINTS):
            ang = phi_a + (gx[q] + 1.0) / 2.0 * dphi
            d = np.stack([np.cos(ang), np.sin(ang)], axis=1)
            radii.append(h / np.maximum(np.einsum("nd,nd->n", n_e, d), 1e-12))
            weights.append(gw[q] / 2.0 * dphi)
    return np.stack(radii, axis=1), np.stack(weights, axis=1)


class SphereSystem:
    """The sphere's float64 geometry and static row sums on ``device``."""

    def __init__(self, subdivisions: int, device, rows: int = 256):
        verts, faces = icosphere(subdivisions)
        pts = verts[faces]
        cross = np.cross(pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 0])
        twice_area = np.linalg.norm(cross, axis=1)
        normals = cross / twice_area[:, None]
        centers = pts.mean(axis=1)
        lam = np.concatenate([1.0 - TRI_POINTS.sum(axis=1, keepdims=True), TRI_POINTS], axis=1)
        qp = np.einsum("qv,nvd->nqd", lam, pts)
        qw = twice_area[:, None] * TRI_WEIGHTS[None, :]
        sr, sw = sector_rule(pts, centers, normals)
        self.h = float(np.sqrt((0.5 * twice_area).mean()))
        self.device = torch.device(device)
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=self.device)  # noqa: E731
        self.centers, self.normals, self.qp, self.qw = t(centers), t(normals), t(qp), t(qw)
        self.sr, self.sw = t(sr), t(sw)
        self.n = len(faces)
        self.rows = rows
        d0, t0 = [], []
        for r0 in range(0, self.n, rows):
            d, hy = self._static_rows(r0, min(self.n, r0 + rows))
            d0.append(d)
            t0.append(hy)
        self.d0_sum, self.t0_sum = torch.cat(d0), torch.cat(t0)

    def _pairs(self, r0, r1, q):
        x, nx = self.centers[r0:r1, None, :], self.normals[r0:r1, None, :]
        rv = self.qp[None, :, q, :] - x
        r = torch.sqrt(torch.sum(rv * rv, dim=-1))
        own = torch.arange(r0, r1, device=self.device)
        r[own - r0, own] = 1.0  # the singular self pair, replaced below
        rn_y = torch.sum(rv * self.normals[None], dim=-1)
        rn_x = torch.sum(rv * nx, dim=-1)
        nn = torch.sum(nx * self.normals[None], dim=-1)
        return r, rn_x, rn_y, nn, own

    def _static_rows(self, r0, r1):
        """Row sums over j != i of D_0 and T_0 for rows r0..r1-1."""
        d_sum = torch.zeros(r1 - r0, dtype=torch.float64, device=self.device)
        t_sum = torch.zeros_like(d_sum)
        for q in range(self.qp.shape[1]):
            r, rn_x, rn_y, nn, own = self._pairs(r0, r1, q)
            g0 = 1.0 / (PI4 * r)
            w = self.qw[None, :, q]
            d0 = -g0 * rn_y / r**2 * w
            t0 = -g0 * (3.0 * rn_x * rn_y / r**4 - nn / r**2) * w
            d0[own - r0, own] = 0.0
            t0[own - r0, own] = 0.0
            d_sum += d0.sum(dim=1)
            t_sum += t0.sum(dim=1)
        return d_sum, t_sum

    def beta(self, k: float, burton_miller: bool) -> complex:
        return 4j / (k + 1.0 / self.h) if burton_miller else 0j

    def rows_block(self, k: float, burton_miller: bool, r0: int, r1: int):
        """(r1 - r0, N) complex128 rows of A at wavenumber k."""
        ik = 1j * k
        beta = self.beta(k, burton_miller)
        a = torch.zeros((r1 - r0, self.n), dtype=torch.complex128, device=self.device)
        for q in range(self.qp.shape[1]):
            r, rn_x, rn_y, nn, own = self._pairs(r0, r1, q)
            w = self.qw[None, :, q]
            g = torch.exp(ik * r) / (PI4 * r)
            a -= (ik - 1.0 / r) * g * (rn_y / r) * w
            if burton_miller:
                coef = ik * ik - 3.0 * ik / r + 3.0 / r**2
                hyper = -(coef * rn_x * rn_y / r**2 + (ik - 1.0 / r) * nn / r) * g
                a += beta * hyper * w
        own = torch.arange(r0, r1, device=self.device)
        diag = (1.0 + self.d0_sum[r0:r1]).to(torch.complex128)  # 1/2 - (-1/2 - sum D_0)
        if burton_miller:
            rr = self.sr[r0:r1].to(torch.complex128)
            t_self = torch.sum(self.sw[r0:r1] * (ik - (torch.exp(ik * rr) - 1.0) / rr), dim=1) / PI4
            diag = diag + beta * (t_self - self.t0_sum[r0:r1])
        a[own - r0, own] = diag
        return a

    def rhs(self, k: float, direction, burton_miller: bool):
        """(N,) complex128 right-hand side of a unit plane wave along ``direction``."""
        d = torch.as_tensor(np.asarray(direction, np.float64), device=self.device)
        phase = torch.exp(1j * k * (self.centers @ d))
        if not burton_miller:
            return phase
        return phase - self.beta(k, True) * (1j * k * (self.normals @ d)) * phase

    def matvec(self, k: float, burton_miller: bool, p: torch.Tensor, round_operands=None):
        """A p for p (N,) or (N, m); with ``round_operands`` the product of
        the rounded operands in complex64."""
        p = p.to(self.device)
        out = []
        for r0 in range(0, self.n, self.rows):
            block = self.rows_block(k, burton_miller, r0, min(self.n, r0 + self.rows))
            if round_operands is None:
                out.append(block @ p.to(torch.complex128))
            else:
                out.append(round_operands(block.to(torch.complex64)) @ round_operands(
                    p.to(torch.complex64)))
        return torch.cat(out)

    def residual(self, k: float, burton_miller: bool, direction, p) -> float:
        """||A p - b|| / ||b|| in float64."""
        b = self.rhs(k, direction, burton_miller)
        res = self.matvec(k, burton_miller, p) - b
        return float(torch.linalg.vector_norm(res) / torch.linalg.vector_norm(b))

    def matrix(self, k: float, burton_miller: bool) -> torch.Tensor:
        """The whole (N, N) complex128 matrix."""
        return torch.cat([self.rows_block(k, burton_miller, r0, min(self.n, r0 + self.rows))
                          for r0 in range(0, self.n, self.rows)])


def gmres(matvec, b, tol: float, restart: int = 30, max_restarts: int = 20,
          precondition=None):
    """Right-preconditioned restarted GMRES (modified Gram-Schmidt) for one
    vector, in b's dtype. Returns x."""
    m_inv = precondition or (lambda v: v)
    x = torch.zeros_like(b)
    b_norm = float(torch.linalg.vector_norm(b))
    for _ in range(max_restarts):
        r = b - matvec(x)
        beta = float(torch.linalg.vector_norm(r))
        if beta <= tol * b_norm:
            break
        basis = [r / beta]
        z_basis = []
        h = torch.zeros((restart + 1, restart), dtype=b.dtype, device=b.device)
        steps = 0
        for j in range(restart):
            z = m_inv(basis[j])
            z_basis.append(z)
            w = matvec(z)
            for i in range(j + 1):
                h[i, j] = torch.sum(basis[i].conj() * w)
                w = w - h[i, j] * basis[i]
            h[j + 1, j] = torch.linalg.vector_norm(w)
            steps = j + 1
            if float(h[j + 1, j].abs()) < 1e-30:
                break
            basis.append(w / h[j + 1, j])
        e1 = torch.zeros(steps + 1, dtype=b.dtype, device=b.device)
        e1[0] = beta
        y = torch.linalg.lstsq(h[:steps + 1, :steps], e1[:, None]).solution[:, 0]
        x = x + sum(y[i] * z_basis[i] for i in range(steps))
    return x
