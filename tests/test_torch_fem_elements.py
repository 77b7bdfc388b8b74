"""Port vs reference: every FEM element type of slice 6c's rest.

fem/quadrature.py's rules (tet_rule_duffy, triangle_rule_order, quad_rule,
hex_rule) and fem/basis.py's shape functions and element tables for all
eight element types agree to 1e-14; the quadrilateral and hexahedral
generators, element measures, refinement (uniform, adaptive, Dörfler,
residual indicator, to_p2, to_p3) and the face tables give equal arrays.
Assembled values in float64 on the CPU (stiffness, mass, lumped mass,
boundary mass and right-hand side on P2, P3, quad and hex meshes; PML
values) agree within 1e-12 of the largest entry, and solve_helmholtz on
to_p2/to_p3 meshes within 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mathaudio_tpu.fem.assembly as jax_assembly
import mathaudio_tpu.fem.basis as jax_basis
import mathaudio_tpu.fem.boundary as jax_boundary
import mathaudio_tpu.fem.mesh as jax_mesh
import mathaudio_tpu.fem.pml as jax_pml
import mathaudio_tpu.fem.problem as jax_problem
import mathaudio_tpu.fem.quadrature as jax_quadrature
import mathaudio_tpu.fem.refinement as jax_refinement
from mathaudio_tpu.solvers import KrylovConfig as JaxKrylovConfig
from mathaudio_tpu_torch.fem import assembly, basis, boundary, mesh, pml, problem, quadrature
from mathaudio_tpu_torch.fem import refinement
from mathaudio_tpu_torch.solvers import KrylovConfig

CPU64 = dict(dtype=torch.float64, device="cpu")
TYPES = ("triangle", "quad", "tet", "hex", "triangle6", "tet10", "triangle10", "tet20")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol=1e-12):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-300)


def _same_mesh(got, ref):
    assert got.dim == ref.dim and got.element_type == ref.element_type
    for field in ("nodes", "elements", "boundary_faces", "boundary_markers"):
        g, r = getattr(got, field), getattr(ref, field)
        assert (g is None) == (r is None), field
        if r is not None:
            np.testing.assert_array_equal(g, r, err_msg=field)


RULES = [("tet_rule_duffy", (4,)), ("tet_rule_duffy", (5,)), ("triangle_rule_order", (4,)),
         ("triangle_rule_order", (6,)), ("triangle_rule_order", (9,)), ("quad_rule", (2,)),
         ("quad_rule", (3,)), ("hex_rule", (2,)), ("hex_rule", (3,)), ("gauss_1d", (4,)),
         ("gauss_1d", (5,)), ("segment_rule", (4,))]


@pytest.mark.parametrize("name,args", RULES, ids=[f"{n}{a}" for n, a in RULES])
def test_quadrature_rule_equals_reference(name, args):
    for got, want in zip(getattr(quadrature, name)(*args), getattr(jax_quadrature, name)(*args)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


@pytest.mark.parametrize("element_type", TYPES)
def test_shape_functions_and_tables_equal_reference(element_type):
    dim = 2 if element_type in ("triangle", "quad", "triangle6", "triangle10") else 3
    pts = np.random.default_rng(len(element_type)).random((7, dim)) * (0.3 if "quad" not in
                                                                      element_type else 1.0)
    for got, want in zip(basis.shape_functions(element_type, pts),
                         jax_basis.shape_functions(element_type, pts)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    for order in (1, 2, 3):
        got, want = basis.element_tables(element_type, order), jax_basis.element_tables(
            element_type, order)
        assert (got.element_type, got.dim, got.nv) == (want.element_type, want.dim, want.nv)
        for g, w in zip(got[3:], want[3:]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-14)


GENERATORS = [("rectangular_mesh_quads", (0.0, 2.0, -1.0, 0.5, 5, 3)),
              ("unit_square_quads", (4,)),
              ("box_mesh_hexahedra", (0.0, 1.5, 0.0, 1.0, -0.5, 0.5, 3, 2, 4)),
              ("unit_cube_hexahedra", (3,))]


@pytest.mark.parametrize("name,args", GENERATORS, ids=[n for n, _ in GENERATORS])
def test_generator_equals_reference(name, args):
    got, ref = getattr(mesh, name)(*args), getattr(jax_mesh, name)(*args)
    _same_mesh(got, ref)
    for tags in (None, [1], [2, 3]):
        np.testing.assert_array_equal(got.boundary_nodes(tags), ref.boundary_nodes(tags))


MEASURED = [("unit_square_triangles", (3,)), ("unit_square_quads", (3,)),
            ("unit_cube_tetrahedra", (2,)), ("unit_cube_hexahedra", (2,))]


@pytest.mark.parametrize("name,args", MEASURED, ids=[n for n, _ in MEASURED])
def test_element_measures_equal_reference(name, args):
    got, ref = getattr(mesh, name)(*args), getattr(jax_mesh, name)(*args)
    if got.element_type in ("quad", "hex"):  # a warped cell: the quad/hex formulas proper
        got.nodes[got.num_nodes // 2] += 0.05
        ref.nodes[ref.num_nodes // 2] += 0.05
    np.testing.assert_allclose(got.element_measures(), ref.element_measures(), rtol=1e-15,
                               atol=0)
    np.testing.assert_array_equal(got.element_centroids(), ref.element_centroids())


@pytest.mark.parametrize("volume_type", TYPES)
def test_face_table_equals_reference(volume_type):
    for got, want in zip(assembly._face_table(volume_type), jax_assembly._face_table(volume_type)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


BASES = {
    "triangles": (lambda m: m.unit_square_triangles(3)),
    "tets": (lambda m: m.unit_cube_tetrahedra(2)),
    "annulus": (lambda m: m.annular_mesh_triangles(1.0, 3.0, 3, 12)),
    "shell": (lambda m: m.spherical_shell_mesh_tetrahedra(1.0, 2.5, 2, 0)),
}


@pytest.mark.parametrize("base", list(BASES))
@pytest.mark.parametrize("fn", ["uniform_refine", "to_p2", "to_p3"])
def test_refinement_equals_reference(base, fn):
    _same_mesh(getattr(refinement, fn)(BASES[base](mesh)),
               getattr(jax_refinement, fn)(BASES[base](jax_mesh)))


@pytest.mark.parametrize("base", ["triangles", "tets"])
@pytest.mark.parametrize("theta", [0.3, 0.9])
def test_adaptive_refinement_equals_reference(base, theta):
    m, ref = BASES[base](mesh), BASES[base](jax_mesh)
    rng = np.random.default_rng(7)
    u = rng.normal(size=m.num_nodes) + 1j * rng.normal(size=m.num_nodes)
    eta = refinement.residual_indicator(m, torch.tensor(u), 2.0)
    np.testing.assert_allclose(eta, np.asarray(jax_refinement.residual_indicator(ref, u, 2.0)),
                               rtol=1e-15, atol=0)
    np.testing.assert_array_equal(refinement.dorfler_mark(eta, theta),
                                  jax_refinement.dorfler_mark(eta, theta))
    sparse_eta = np.where(np.arange(m.num_elements) < 3, eta, 0.0)
    _same_mesh(refinement.adaptive_refine(m, sparse_eta, theta),
               jax_refinement.adaptive_refine(ref, sparse_eta, theta))


def test_refinement_refuses_what_the_reference_does_not_take():
    with pytest.raises(ValueError):
        refinement.uniform_refine(mesh.unit_square_quads(2))
    with pytest.raises(ValueError):
        refinement.to_p3(mesh.unit_cube_hexahedra(1))


# --------------------------------------------------------------------------
# Assembled values on every element type (float64, CPU). The reference side
# of each mesh is computed once per module.
# --------------------------------------------------------------------------

ASSEMBLED = {
    "p2 triangles": lambda m, r: r.to_p2(m.annular_mesh_triangles(1.0, 2.0, 3, 12)),
    "p3 triangles": lambda m, r: r.to_p3(m.unit_square_triangles(3)),
    "p2 tets": lambda m, r: r.to_p2(m.unit_cube_tetrahedra(2)),
    "p3 tets": lambda m, r: r.to_p3(m.spherical_shell_mesh_tetrahedra(1.0, 2.0, 1, 0)),
    "quads": lambda m, r: m.rectangular_mesh_quads(0.0, 2.0, 0.0, 1.0, 6, 4),
    "hexes": lambda m, r: m.box_mesh_hexahedra(0.0, 1.0, 0.0, 1.5, 0.0, 0.5, 3, 4, 2),
}


def _source_jax(x):
    return jnp.exp(1j * 1.3 * x[..., 0]) * (1.0 + x[..., 1] ** 2)


def _source(x):
    return torch.exp(1j * 1.3 * x[..., 0]) * (1.0 + x[..., 1] ** 2)


@pytest.fixture(scope="module")
def reference_values():
    out = {}
    for name, make in ASSEMBLED.items():
        m = make(jax_mesh, jax_refinement)
        _csr, k_vals, m_vals, _ = jax_assembly.assemble_stiffness_mass(m, jnp.float64)
        out[name] = dict(
            k=np.asarray(k_vals), m=np.asarray(m_vals),
            lumped=np.asarray(jax_assembly.assemble_lumped_mass(m, jnp.float64)),
            b=np.asarray(jax_assembly.assemble_boundary_mass(m, 1, _csr, dtype=jnp.float64)),
            rhs=np.asarray(jax_assembly.assemble_rhs(m, _source_jax, jnp.float64)),
            load=np.asarray(jax_boundary.surface_load(m, 2, _source_jax, cdtype=jnp.complex128)))
    return out


@pytest.mark.parametrize("name", list(ASSEMBLED))
def test_assembled_values_equal_reference(reference_values, name):
    m = ASSEMBLED[name](mesh, refinement)
    ref = reference_values[name]
    csr, k_vals, m_vals, _ = assembly.assemble_stiffness_mass(m, torch.float64, device="cpu")
    _close(k_vals, ref["k"])
    _close(m_vals, ref["m"])
    _close(assembly.assemble_lumped_mass(m, torch.float64, device="cpu"), ref["lumped"])
    _close(assembly.assemble_boundary_mass(m, 1, csr, **CPU64), ref["b"])
    _close(assembly.assemble_rhs(m, _source, torch.float64, device="cpu"), ref["rhs"])
    _close(boundary.surface_load(m, 2, _source, cdtype=torch.complex128, device="cpu"),
           ref["load"])
    if m.element_type in ("quad", "hex"):  # the total mass is the mesh measure
        np.testing.assert_allclose(float(m_vals.sum()), m.element_measures().sum(), rtol=1e-12)


PML_MESHES = {
    "triangles": lambda m, r: m.unit_square_triangles(6),
    "quads": lambda m, r: m.unit_square_quads(5),
    "tets": lambda m, r: m.unit_cube_tetrahedra(2),
    "hexes": lambda m, r: m.unit_cube_hexahedra(3),
    "p2 triangles": lambda m, r: r.to_p2(m.unit_square_triangles(3)),
}


@pytest.mark.parametrize("name", list(PML_MESHES))
def test_pml_values_equal_reference(name):
    m, ref = PML_MESHES[name](mesh, refinement), PML_MESHES[name](jax_mesh, jax_refinement)
    bounds = (0.0, 1.0) * m.dim
    regions = pml.pml_box_regions(bounds, 0.3, sigma_max=12.0, order=3)
    ref_regions = jax_pml.pml_box_regions(bounds, 0.3, sigma_max=12.0, order=3)
    assert [vars(r) for r in regions] == [vars(r) for r in ref_regions]
    csr, k_vals, m_vals = pml.assemble_pml_values(m, regions, 2.5, **CPU64)
    ref_csr, ref_k, ref_m = jax_pml.assemble_pml_values(ref, ref_regions, 2.5, dtype=jnp.float64)
    np.testing.assert_array_equal(csr.indptr, ref_csr.indptr)
    np.testing.assert_array_equal(csr.indices, ref_csr.indices)
    assert k_vals.dtype == torch.complex128
    _close(k_vals, ref_k)
    _close(m_vals, ref_m)
    # the stretch is the identity outside every layer: the plain values there
    _, k0, m0, _ = assembly.assemble_stiffness_mass(m, torch.float64, device="cpu")
    one = pml.assemble_pml_values(m, [pml.PmlRegion(0, +1, 5.0, 1.0)], 2.5, csr, **CPU64)
    _close(one[1], k0.to(torch.complex128))
    _close(one[2], m0.to(torch.complex128))


def test_pml_sigma_profile_equals_reference():
    reg = pml.PmlRegion(1, -1, 0.4, 0.3, sigma_max=7.0, order=3)
    ref = jax_pml.PmlRegion(1, -1, 0.4, 0.3, sigma_max=7.0, order=3)
    x = np.random.default_rng(3).random((50, 2))
    np.testing.assert_allclose(reg.sigma(torch.tensor(x)).numpy(), np.asarray(ref.sigma(x)),
                               rtol=1e-15, atol=0)


# --------------------------------------------------------------------------
# solve_helmholtz on P2/P3 meshes: the plane wave of tests/test_fem_extras.py
# (Dirichlet on every side) and the QA cylinder problem (Neumann + Robin).
# --------------------------------------------------------------------------

KD = (1.2, 1.6)


def _exact(x):
    return torch.exp(1j * (KD[0] * x[..., 0] + KD[1] * x[..., 1]))


def _exact_jax(x):
    return jnp.exp(1j * (KD[0] * x[..., 0] + KD[1] * x[..., 1]))


SOLVES = [("to_p2", "direct"), ("to_p3", "direct"), ("to_p2", "gmres_jacobi"),
          ("to_p3", "gmres_schwarz")]


@pytest.mark.parametrize("fn,solver", SOLVES, ids=[f"{f}-{s}" for f, s in SOLVES])
def test_higher_order_solve_equals_reference(fn, solver):
    m = getattr(refinement, fn)(mesh.unit_square_triangles(4))
    ref_m = getattr(jax_refinement, fn)(jax_mesh.unit_square_triangles(4))
    prob = problem.HelmholtzProblem(m, 2.0, dirichlet=[boundary.DirichletBC(t, _exact)
                                                      for t in (1, 2, 3)],
                                    robin=[boundary.RobinBC.absorbing(4, 2.0)], **CPU64)
    ref_prob = jax_problem.HelmholtzProblem(
        ref_m, 2.0, dirichlet=[jax_boundary.DirichletBC(t, _exact_jax) for t in (1, 2, 3)],
        robin=[jax_boundary.RobinBC.absorbing(4, 2.0)], dtype=jnp.float64)
    _close(prob.vals, ref_prob.vals)
    _close(prob.rhs, ref_prob.rhs)
    cfg = dict(max_iterations=800, tolerance=1e-11, restart=40)
    ref_x, ref_info = jax_problem.solve_helmholtz(ref_prob, solver, JaxKrylovConfig(**cfg))
    x, info = problem.solve_helmholtz(prob, solver, KrylovConfig(**cfg))
    assert info["iterations"] == int(ref_info["iterations"])
    _close(x, ref_x, 1e-9)
    err = float(problem.l2_error_at_nodes(m, x, _exact))
    assert abs(err - float(jax_problem.l2_error_at_nodes(ref_m, ref_x, _exact_jax))) <= 1e-9
