"""Port vs reference: host build of the node-major room sweep.

Mesh, K/M/B values, CSR slot maps, transfer stencils, the source RHS,
the listening nodes and the anchored coarse inverses of
mathaudio_tpu_torch equal mathaudio_tpu's in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mathaudio_tpu.fem import basis as jbasis
from mathaudio_tpu.fem import quadrature as jquad
from mathaudio_tpu.fem.multigrid import GeometricMultigrid as JaxMultigrid
from mathaudio_tpu.fem.multigrid import box_hierarchy as jax_box_hierarchy
from mathaudio_tpu.fem.multigrid import build_coarse_inv_chain as jax_coarse_chain
from mathaudio_tpu.models import RoomSweepModel as JaxRoomModel
from mathaudio_tpu_torch.fem import basis, quadrature
from mathaudio_tpu_torch.fem.multigrid import GeometricMultigrid, box_hierarchy, build_coarse_inv_chain
from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel

WALLS = (1, 2, 3, 4, 5, 6)
ROOM = dict(wall_tags=WALLS, absorption=0.15,
            listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)))
TOL = 1e-12


@pytest.fixture(scope="module")
def builds():
    jm = jax_box_hierarchy(4, 3)
    jmg = JaxMultigrid(jm, robin_tags=WALLS)
    jmodel = JaxRoomModel(jm[0], assembler=jmg.assemblers[0], **ROOM)
    tm = box_hierarchy(4, 3)
    tmg = GeometricMultigrid(tm, robin_tags=WALLS, dtype=torch.float64, device="cpu")
    tmodel = RoomSweepModel(tm[0], assembler=tmg.assemblers[0], **ROOM)
    return jmg, jmodel, tmg, tmodel


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    scale = max(1.0, float(np.max(np.abs(b)))) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_mesh_matches(builds, level):
    jmg, _, tmg, _ = builds
    jm, tm = jmg.meshes[level], tmg.meshes[level]
    np.testing.assert_array_equal(tm.nodes, jm.nodes)
    np.testing.assert_array_equal(tm.elements, jm.elements)
    np.testing.assert_array_equal(tm.boundary_faces, jm.boundary_faces)
    np.testing.assert_array_equal(tm.boundary_markers, jm.boundary_markers)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_assembly_values_and_slots_match(builds, level):
    jmg, _, tmg, _ = builds
    ja, ta = jmg.assemblers[level], tmg.assemblers[level]
    np.testing.assert_array_equal(_np(ta.row_of_slot), _np(ja.row_of_slot))
    np.testing.assert_array_equal(_np(ta.col_of_slot), _np(ja.col_of_slot))
    np.testing.assert_array_equal(ta.csr.indptr, ja.csr.indptr)
    assert ta.num_nodes == ja.num_nodes
    assert ta.k_vals.dtype == torch.float64
    _close(ta.k_vals, ja.k_vals)
    _close(ta.m_vals, ja.m_vals)
    assert set(ta.b_vals) == set(ja.b_vals)
    for tag in WALLS:
        _close(ta.b_vals[tag], ja.b_vals[tag])


@pytest.mark.parametrize("level", [0, 1])
def test_transfer_stencils_match(builds, level):
    jmg, _, tmg, _ = builds
    jl, tl = jmg.builder.levels[level], tmg.builder.levels[level]
    np.testing.assert_array_equal(_np(tl.p_idx), _np(jl.p_idx))
    np.testing.assert_array_equal(_np(tl.r_idx), _np(jl.r_idx))
    _close(tl.p_w, jl.p_w)
    _close(tl.r_w, jl.r_w)
    _close(tl.b_sum, jl.b_sum)


def test_rhs_and_listen_idx_match(builds):
    _, jmodel, _, tmodel = builds
    assert tmodel.params().rhs.dtype == torch.complex128
    _close(tmodel.params().rhs, jmodel.params().rhs)
    np.testing.assert_array_equal(_np(tmodel.params().listen_idx),
                                  _np(jmodel.params().listen_idx))


def test_coarse_inverse_chain_matches(builds):
    jmg, _, tmg, _ = builds
    aks = np.array([0.6, 0.7, 0.8, 1.6])  # the wide last gap takes the direct-inverse path
    rc = -1j * 0.15 * aks
    ref = jax_coarse_chain(jmg.builder, jnp.asarray(aks), jnp.asarray(rc))
    got = build_coarse_inv_chain(tmg.builder, torch.tensor(aks), torch.tensor(rc))
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-10 * np.abs(_np(ref)).max())


@pytest.mark.parametrize("rule,order", [("tet_rule", 1), ("tet_rule", 2), ("tet_rule", 3),
                                        ("triangle_rule", 1), ("triangle_rule", 2),
                                        ("triangle_rule", 3), ("triangle_rule", 4),
                                        ("segment_rule", 2), ("segment_rule", 3)])
def test_quadrature_rules_match(rule, order):
    pts, w = getattr(quadrature, rule)(order)
    rpts, rw = getattr(jquad, rule)(order)
    np.testing.assert_array_equal(pts, rpts)
    np.testing.assert_array_equal(w, rw)


@pytest.mark.parametrize("etype", ["tet", "triangle"])
def test_element_tables_match(etype):
    t, r = basis.element_tables(etype), jbasis.element_tables(etype)
    assert (t.nv, t.dim) == (r.nv, r.dim)
    for field in ("points", "weights", "phi", "grad"):
        np.testing.assert_array_equal(getattr(t, field), getattr(r, field))


def test_builders_default_to_float32_complex64():
    mesh = box_hierarchy(2, 1)[0]
    model = RoomSweepModel(mesh, device="cpu")
    assert model.assembler.k_vals.dtype == torch.float32
    assert model.params().rhs.dtype == torch.complex64


def test_csr_from_triplets_matches():
    from mathaudio_tpu.solvers.sparse import CsrMatrix as JaxCsr
    from mathaudio_tpu_torch.solvers.sparse import CsrMatrix

    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, 9, 60), rng.integers(0, 7, 60)  # with duplicates
    vals = rng.standard_normal(60)
    got, ref = CsrMatrix.from_triplets(rows, cols, vals, (9, 7)), JaxCsr.from_triplets(rows, cols, vals, (9, 7))
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.data, ref.data, rtol=0, atol=1e-15)
    assert got.nnz == ref.nnz


def test_triangle_assembly_matches():
    """2D P1: triangle shape functions and rules, segment boundary faces."""
    from mathaudio_tpu.fem.assembly import HelmholtzAssembler as JaxAssembler
    from mathaudio_tpu.fem.mesh import rectangular_mesh_triangles
    from mathaudio_tpu_torch.fem.assembly import HelmholtzAssembler
    from mathaudio_tpu_torch.fem.mesh import Mesh

    jmesh = rectangular_mesh_triangles(0.0, 2.0, 0.0, 1.0, 4, 3)
    mesh = Mesh(2, jmesh.nodes, jmesh.elements, "triangle",
                jmesh.boundary_faces, jmesh.boundary_markers)
    ref = JaxAssembler(jmesh, robin_tags=(1, 2, 3, 4))
    got = HelmholtzAssembler(mesh, robin_tags=(1, 2, 3, 4), dtype=torch.float64, device="cpu")
    _close(got.k_vals, ref.k_vals)
    _close(got.m_vals, ref.m_vals)
    for tag in (1, 2, 3, 4):
        _close(got.b_vals[tag], ref.b_vals[tag])
