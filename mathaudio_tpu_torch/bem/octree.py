"""Octree clustering for the FMM (counterpart of mathaudio_tpu/bem/octree.py;
math-bem/src/core/mesh/octree.rs:11-327).

Host-side numpy: AABB root, recursive 8-way split down to
max-per-leaf/max-depth, leaf clusters, and interaction lists via a
separation ratio. Leaves are then padded to a uniform size for the
batched device FMM (bem/fmm.py ``_pack_clusters``). Leaves and
interaction lists are the reference's, index for index."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class OctreeNode:
    center: np.ndarray
    half: float
    indices: np.ndarray
    children: Optional[List["OctreeNode"]] = None
    depth: int = 0

    @property
    def is_leaf(self) -> bool:
        return self.children is None


@dataclasses.dataclass
class Octree:
    root: OctreeNode
    leaves: List[OctreeNode]
    points: np.ndarray

    @classmethod
    def build(cls, points: np.ndarray, max_per_leaf: int = 64, max_depth: int = 8) -> "Octree":
        """octree.rs:189 build."""
        points = np.asarray(points, float)
        if points.shape[0] == 0:
            # octree.rs test_octree_empty: an empty cloud is a single
            # empty leaf at the origin, not a crash.
            root = OctreeNode(
                center=np.zeros(3), half=1e-12, indices=np.arange(0)
            )
            return cls(root, [root], points.reshape(0, 3))
        lo = points.min(axis=0)
        hi = points.max(axis=0)
        center = 0.5 * (lo + hi)
        half = float(0.5 * (hi - lo).max()) * 1.0001 + 1e-12

        leaves: List[OctreeNode] = []

        def split(node: OctreeNode):
            if len(node.indices) <= max_per_leaf or node.depth >= max_depth:
                leaves.append(node)
                return
            node.children = []
            pts = points[node.indices]
            octant = (
                (pts[:, 0] > node.center[0]).astype(int)
                + 2 * (pts[:, 1] > node.center[1]).astype(int)
                + 4 * (pts[:, 2] > node.center[2]).astype(int)
            )
            for o in range(8):
                sel = node.indices[octant == o]
                if len(sel) == 0:
                    continue
                off = np.array([(o & 1), (o >> 1) & 1, (o >> 2) & 1]) * 2 - 1
                child = OctreeNode(
                    center=node.center + off * node.half / 2,
                    half=node.half / 2,
                    indices=sel,
                    depth=node.depth + 1,
                )
                node.children.append(child)
                split(child)

        root = OctreeNode(center=center, half=half, indices=np.arange(len(points)))
        split(root)
        return cls(root, leaves, points)

    def levels(self) -> List[List[OctreeNode]]:
        """Nodes grouped by depth (octree.rs levels)."""
        out: List[List[OctreeNode]] = []

        def walk(node):
            while len(out) <= node.depth:
                out.append([])
            out[node.depth].append(node)
            if node.children:
                for c in node.children:
                    walk(c)

        walk(self.root)
        return out

    def interaction_lists(self, separation_ratio: float = 2.0):
        """(near_pairs, far_pairs) between leaves (octree.rs:327):
        far iff center distance > separation_ratio * (r_a + r_b)."""
        centers = np.array([lf.indices_center(self.points) for lf in self.leaves])
        radii = np.array([lf.radius(self.points) for lf in self.leaves])
        # Squared-distance Gram form in float32 with in-place updates: one
        # (C, C) GEMM instead of a (C, C, 3) broadcast + norm. The float32
        # rounding decides borderline pairs, so it stays as the reference
        # has it: the lists must be the reference's.
        c32 = centers.astype(np.float32)
        sq = np.einsum("cd,cd->c", c32, c32)
        d2 = c32 @ c32.T
        d2 *= -2.0
        d2 += sq[:, None]
        d2 += sq[None, :]
        far = d2 > (separation_ratio * (radii[:, None] + radii[None, :])).astype(
            np.float32
        ) ** 2
        # BLAS GEMM is not bit-symmetric; make the classification
        # deterministic and symmetric on the cheap boolean matrix
        # (a pair is far only if both directions agree), and pin
        # self-pairs near (gram[ii] != sq[i] by an ulp, which would
        # otherwise far-list tiny-radius leaves against themselves).
        far &= far.T
        np.fill_diagonal(far, False)
        def pairs(mask):
            b, a = np.nonzero(mask)
            # direct column writes (np.column_stack copies through a
            # strided transpose, slow for multi-million-pair lists)
            out = np.empty((len(b), 2), b.dtype)
            out[:, 0] = b
            out[:, 1] = a
            return out

        return pairs(~far), pairs(far)


def _indices_center(self, points):
    return points[self.indices].mean(axis=0)


def _radius(self, points):
    c = _indices_center(self, points)
    return float(np.linalg.norm(points[self.indices] - c, axis=1).max()) + 1e-12


OctreeNode.indices_center = _indices_center
OctreeNode.radius = _radius
