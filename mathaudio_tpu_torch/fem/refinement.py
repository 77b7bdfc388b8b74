"""h-refinement and the P2/P3 upgrades (counterpart of
mathaudio_tpu/fem/refinement.py; host numpy): edge-midpoint element
splitting, uniform refinement, adaptive refinement with Dörfler marking, a
residual error indicator, and ``to_p2``/``to_p3``, whose node orders (and
those of the boundary faces) are the ones fem/basis.py and
fem/assembly.py's face tables read.
"""

from __future__ import annotations

import numpy as np
import torch

from mathaudio_tpu_torch.fem.mesh import TET, TRIANGLE, Mesh


def _edge_midpoints(nodes: np.ndarray, elements: np.ndarray, edge_local):
    """Unique edge midpoints; returns (new_nodes, edge->node-id map)."""
    edges = elements[:, edge_local].reshape(-1, 2)
    key = np.sort(edges, axis=1)
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    mids = 0.5 * (nodes[uniq[:, 0]] + nodes[uniq[:, 1]])
    mid_ids = len(nodes) + np.arange(len(uniq))
    all_nodes = np.vstack([nodes, mids])
    per_elem_mid = mid_ids[inverse].reshape(len(elements), len(edge_local))
    return all_nodes, per_elem_mid


_TRI_EDGES = [[0, 1], [1, 2], [2, 0]]
_TET_EDGES = [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]]


def uniform_refine(mesh: Mesh) -> Mesh:
    """One sweep of red refinement: tri -> 4 tris, tet -> 8 tets."""
    nodes, children = _red_refine(mesh)
    return Mesh(mesh.dim, nodes, children, mesh.element_type).detect_boundaries()


def _red_refine(mesh: Mesh):
    """(nodes, children) of one red refinement, boundaries not detected."""
    if mesh.element_type == TRIANGLE:
        nodes, m = _edge_midpoints(mesh.nodes, mesh.elements, _TRI_EDGES)
        e = mesh.elements
        m01, m12, m20 = m[:, 0], m[:, 1], m[:, 2]
        children = np.concatenate(
            [
                np.stack([e[:, 0], m01, m20], axis=1),
                np.stack([m01, e[:, 1], m12], axis=1),
                np.stack([m20, m12, e[:, 2]], axis=1),
                np.stack([m01, m12, m20], axis=1),
            ],
            axis=0,
        )
        return nodes, children.astype(np.int64)
    if mesh.element_type == TET:
        nodes, m = _edge_midpoints(mesh.nodes, mesh.elements, _TET_EDGES)
        e = mesh.elements
        m01, m02, m03, m12, m13, m23 = (m[:, i] for i in range(6))
        # 4 corner tets + 4 interior tets (standard octahedron split
        # along the m01-m23 diagonal)
        children = np.concatenate(
            [
                np.stack([e[:, 0], m01, m02, m03], axis=1),
                np.stack([e[:, 1], m01, m12, m13], axis=1),
                np.stack([e[:, 2], m02, m12, m23], axis=1),
                np.stack([e[:, 3], m03, m13, m23], axis=1),
                np.stack([m01, m02, m03, m23], axis=1),
                np.stack([m01, m02, m12, m23], axis=1),
                np.stack([m01, m03, m13, m23], axis=1),
                np.stack([m01, m12, m13, m23], axis=1),
            ],
            axis=0,
        )
        return nodes, children.astype(np.int64)
    raise ValueError(mesh.element_type)


def dorfler_mark(indicators: np.ndarray, theta: float = 0.5) -> np.ndarray:
    """Dörfler (bulk) marking: the smallest element set carrying a
    theta-fraction of the total error. Returns a boolean mask over
    elements."""
    eta = np.asarray(indicators)
    order = np.argsort(eta)[::-1]
    csum = np.cumsum(eta[order])
    cut = np.searchsorted(csum, theta * csum[-1]) + 1
    mask = np.zeros(len(eta), bool)
    mask[order[:cut]] = True
    return mask


def adaptive_refine(mesh: Mesh, indicators: np.ndarray, theta: float = 0.5) -> Mesh:
    """Refine the Dörfler-marked set.

    Marked elements are red-refined; to keep the mesh conforming,
    neighbors sharing a refined edge are also refined (closure by
    iterating the marking until stable) — i.e. effectively refining the
    edge-connected closure of the marked set.
    """
    if mesh.element_type == TRIANGLE:
        edge_local = _TRI_EDGES
    elif mesh.element_type == TET:
        edge_local = _TET_EDGES
    else:
        raise ValueError(mesh.element_type)

    marked = dorfler_mark(indicators, theta)
    # closure: any element sharing an edge with a marked element whose
    # edge is split must be refined too; simplest conforming strategy for
    # simplices: grow marks through shared edges until stable.
    elements = mesh.elements
    edges = np.sort(elements[:, edge_local].reshape(len(elements), -1, 2), axis=2)
    flat = edges.reshape(-1, 2)
    uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
    elem_edges = inverse.reshape(len(elements), -1)

    while True:
        split_edges = np.zeros(len(uniq), bool)
        split_edges[elem_edges[marked].reshape(-1)] = True
        touch = split_edges[elem_edges].any(axis=1)
        new_marked = marked | touch
        if (new_marked == marked).all():
            break
        marked = new_marked

    sub = Mesh(mesh.dim, mesh.nodes, elements[marked], mesh.element_type)
    nodes, children = _red_refine(sub)
    keep = elements[~marked]
    all_elements = np.vstack([keep, children])
    out = Mesh(mesh.dim, nodes, all_elements.astype(np.int64), mesh.element_type)
    return out.detect_boundaries()


def residual_indicator(mesh: Mesh, u, k: float) -> np.ndarray:
    """Cheap element error indicator: h^2 * ||k^2 u + f||-style residual
    proxy using the element-mean solution magnitude. ``u`` may be a tensor
    on any device; the indicator is host numpy."""
    if isinstance(u, torch.Tensor):
        u = u.detach().cpu().numpy()
    u = np.asarray(u)
    h2 = mesh.element_measures() ** (2.0 / mesh.dim)
    u_elem = np.abs(u[mesh.elements]).mean(axis=1)
    return h2 * (k**2) * u_elem


def to_p2(mesh: Mesh) -> Mesh:
    """Upgrade a P1 simplex mesh to quadratic elements by appending edge
    midpoint nodes. Boundary faces gain their midpoint nodes; markers are
    preserved."""
    if mesh.element_type == TRIANGLE:
        edge_local = _TRI_EDGES
        new_type = "triangle6"
    elif mesh.element_type == TET:
        edge_local = _TET_EDGES
        new_type = "tet10"
    else:
        raise ValueError(mesh.element_type)

    nodes, per_elem_mid = _edge_midpoints(mesh.nodes, mesh.elements, edge_local)
    elements = np.hstack([mesh.elements, per_elem_mid]).astype(np.int64)
    out = Mesh(mesh.dim, nodes, elements, new_type)

    if mesh.boundary_faces is not None:
        # boundary faces: append edge-midpoint node(s). For 2D edges: one
        # midpoint; for 3D tri faces: three midpoints.
        faces = mesh.boundary_faces
        if mesh.element_type == TRIANGLE:
            mids = _lookup_midpoints(mesh, nodes, faces[:, [0, 1]])
            out.boundary_faces = np.hstack([faces, mids[:, None]])
        else:
            m01 = _lookup_midpoints(mesh, nodes, faces[:, [0, 1]])
            m12 = _lookup_midpoints(mesh, nodes, faces[:, [1, 2]])
            m20 = _lookup_midpoints(mesh, nodes, faces[:, [2, 0]])
            out.boundary_faces = np.hstack(
                [faces, m01[:, None], m12[:, None], m20[:, None]]
            )
        out.boundary_markers = mesh.boundary_markers.copy()
    return out


def _lookup_midpoints(mesh: Mesh, all_nodes: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Node ids of the midpoints of the given (F, 2) edges (they exist in
    all_nodes by construction of _edge_midpoints)."""
    mids = 0.5 * (mesh.nodes[edges[:, 0]] + mesh.nodes[edges[:, 1]])
    n_old = mesh.num_nodes
    new_nodes = all_nodes[n_old:]
    key = {tuple(np.round(p, 12)): n_old + i for i, p in enumerate(new_nodes)}
    return np.asarray([key[tuple(np.round(m, 12))] for m in mids], np.int64)


def to_p3(mesh: Mesh) -> Mesh:
    """Upgrade a P1 simplex mesh to cubic elements: two nodes per edge at
    1/3 and 2/3, plus bubble nodes (the triangle centroid, or the tet's
    four face centroids: 20 nodes)."""
    if mesh.element_type == TET:
        return _to_p3_tet(mesh)
    if mesh.element_type != TRIANGLE:
        raise ValueError(mesh.element_type)
    e = mesh.elements
    p = mesh.nodes
    v0, v1, v2 = p[e[:, 0]], p[e[:, 1]], p[e[:, 2]]
    # per-element candidate nodes in basis order (after the 3 vertices)
    cand = np.stack(
        [
            (2 * v0 + v1) / 3, (v0 + 2 * v1) / 3,
            (2 * v1 + v2) / 3, (v1 + 2 * v2) / 3,
            (2 * v2 + v0) / 3, (v2 + 2 * v0) / 3,
            (v0 + v1 + v2) / 3,
        ],
        axis=1,
    )  # (E, 7, dim)
    flat = cand.reshape(-1, mesh.dim)
    key = np.round(flat / 1e-9).astype(np.int64)
    _, idx, inverse = np.unique(key, axis=0, return_index=True, return_inverse=True)
    nodes = np.vstack([p, flat[np.sort(idx)]])
    # np.unique sorts; remap inverse to the first-occurrence order
    order = np.argsort(idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    new_ids = mesh.num_nodes + rank[inverse].reshape(len(e), 7)
    elements = np.hstack([e, new_ids]).astype(np.int64)
    out = Mesh(mesh.dim, nodes, elements, "triangle10")
    if mesh.boundary_faces is not None:
        out.boundary_faces = mesh.boundary_faces.copy()
        out.boundary_markers = mesh.boundary_markers.copy()
        # boundary edge nodes: the 1/3 and 2/3 points on boundary edges
        bf = mesh.boundary_faces
        extra = np.stack(
            [(2 * p[bf[:, 0]] + p[bf[:, 1]]) / 3, (p[bf[:, 0]] + 2 * p[bf[:, 1]]) / 3],
            axis=1,
        ).reshape(-1, mesh.dim)
        keymap = {tuple(r): mesh.num_nodes + i for i, r in enumerate(
            np.round(flat[np.sort(idx)] / 1e-9).astype(np.int64))}
        ids = np.asarray(
            [keymap[tuple(r)] for r in np.round(extra / 1e-9).astype(np.int64)],
            np.int64,
        ).reshape(len(bf), 2)
        out.boundary_faces = np.hstack([bf, ids])
    return out


def _to_p3_tet(mesh: Mesh) -> Mesh:
    """Tet P1 -> tet20: per basis order (fem/basis.py TET20), 4 vertices,
    then per edge (01 02 03 12 13 23) the 1/3-from-a and 1/3-from-b
    nodes, then the 4 face centroids (012 013 023 123)."""
    e = mesh.elements
    p = mesh.nodes
    v = [p[e[:, i]] for i in range(4)]
    cand = []
    for a, b in _TET_EDGES:
        cand.append((2 * v[a] + v[b]) / 3)
        cand.append((v[a] + 2 * v[b]) / 3)
    for a, b, c in [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]:
        cand.append((v[a] + v[b] + v[c]) / 3)
    cand = np.stack(cand, axis=1)  # (E, 16, 3)
    flat = cand.reshape(-1, 3)
    key = np.round(flat / 1e-9).astype(np.int64)
    _, idx, inverse = np.unique(key, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    new_ids = mesh.num_nodes + rank[inverse].reshape(len(e), 16)
    nodes = np.vstack([p, flat[np.sort(idx)]])
    elements = np.hstack([e, new_ids]).astype(np.int64)
    out = Mesh(mesh.dim, nodes, elements, "tet20")
    if mesh.boundary_faces is not None:
        # boundary tri faces gain 6 edge nodes + centroid in the
        # triangle10 basis order (v0 v1 v2; per edge 01 12 20 the
        # near-first then near-second node; centroid)
        bf = mesh.boundary_faces
        fa, fb, fc = p[bf[:, 0]], p[bf[:, 1]], p[bf[:, 2]]
        extra = np.stack(
            [
                (2 * fa + fb) / 3, (fa + 2 * fb) / 3,
                (2 * fb + fc) / 3, (fb + 2 * fc) / 3,
                (2 * fc + fa) / 3, (fc + 2 * fa) / 3,
                (fa + fb + fc) / 3,
            ],
            axis=1,
        ).reshape(-1, 3)
        keymap = {
            tuple(r): mesh.num_nodes + i
            for i, r in enumerate(np.round(nodes[mesh.num_nodes:] / 1e-9).astype(np.int64))
        }
        ids = np.asarray(
            [keymap[tuple(r)] for r in np.round(extra / 1e-9).astype(np.int64)],
            np.int64,
        ).reshape(len(bf), 7)
        out.boundary_faces = np.hstack([bf, ids])
        out.boundary_markers = mesh.boundary_markers.copy()
    return out
