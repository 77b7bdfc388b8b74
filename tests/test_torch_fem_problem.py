"""Port vs reference: the general FEM problem of slice 6c (fem/mesh.py's
annulus, spherical shell and disk generators, fem/assembly.py's lumped
mass, fem/boundary.py, fem/problem.py with every solver name of
solve_helmholtz).

Meshes are compared exactly (nodes, elements, boundary faces and markers).
Surface loads, boundary-condition values, the lumped mass and the assembled
systems agree within 1e-12 in float64 on the CPU. solve_helmholtz runs on a
small annulus (rigid cylinder, Bayliss–Turkel outer boundary: the QA
suite's problem) under the 13 names of the QA suite's list, ``cg`` and the
``gmres_ilu_coloring`` alias: iteration counts equal, x within 1e-10 of
max|x|. The reference solves each distinct solver once (its aliases map
onto the same solve); the port runs every name.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mathaudio_tpu.fem as jax_fem
import mathaudio_tpu.fem.boundary as jax_boundary
import mathaudio_tpu.fem.mesh as jax_mesh
import mathaudio_tpu.fem.problem as jax_problem
from mathaudio_tpu.fem.assembly import assemble_lumped_mass as jax_lumped_mass
from mathaudio_tpu.solvers import KrylovConfig as JaxKrylovConfig
from mathaudio_tpu_torch import fem
from mathaudio_tpu_torch.fem import boundary, mesh, problem
from mathaudio_tpu_torch.fem.assembly import assemble_lumped_mass
from mathaudio_tpu_torch.solvers import KrylovConfig

CPU64 = dict(dtype=torch.float64, device="cpu")
K = 1.0
R_OUT = 3.0
ANNULUS = (1.0, R_OUT, 6, 24)  # r_inner, r_outer, n_radial, n_theta


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


GENERATORS = [
    ("annular_mesh_triangles", (1.0, 3.0, 5, 17)),
    ("annular_mesh_triangles", (0.5, 2.0, 8, 32)),
    ("spherical_shell_mesh_tetrahedra", (1.0, 2.5, 3, 1)),
    ("spherical_shell_mesh_tetrahedra", (1.0, 2.5, 2, 2)),
    ("circular_mesh_triangles", (1.5, 4)),
    ("circular_mesh_triangles", (1.0, 1)),
]


@pytest.mark.parametrize("name,args", GENERATORS, ids=[f"{n}{a}" for n, a in GENERATORS])
def test_generator_equals_reference(name, args):
    ref = getattr(jax_mesh, name)(*args)
    got = getattr(mesh, name)(*args)
    assert got.dim == ref.dim and got.element_type == ref.element_type
    for field in ("nodes", "elements", "boundary_faces", "boundary_markers"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))
    for tags in (None, [1], [2], [1, 2]):
        np.testing.assert_array_equal(got.boundary_nodes(tags), ref.boundary_nodes(tags))


@pytest.mark.parametrize("name,args", [GENERATORS[0], GENERATORS[2]], ids=["annulus", "shell"])
def test_lumped_mass_matches_reference(name, args):
    m = getattr(mesh, name)(*args)
    got = assemble_lumped_mass(m, torch.float64, device="cpu")
    _close(got, jax_lumped_mass(getattr(jax_mesh, name)(*args), jnp.float64))


def _flux_jax(x):
    return jnp.exp(1j * K * x[..., 0]) * (1.0 + 0.5 * x[..., 1])


def _flux(x):
    return torch.exp(1j * K * x[..., 0]) * (1.0 + 0.5 * x[..., 1])


@pytest.mark.parametrize("name,args", [GENERATORS[0], GENERATORS[2]], ids=["segments", "triangles"])
@pytest.mark.parametrize("tag", [1, 2])
def test_surface_load_matches_reference(name, args, tag):
    ref = jax_boundary.surface_load(getattr(jax_mesh, name)(*args), tag, _flux_jax,
                                    cdtype=jnp.complex128)
    got = boundary.surface_load(getattr(mesh, name)(*args), tag, _flux, cdtype=torch.complex128,
                                device="cpu")
    assert got.dtype == torch.complex128
    _close(got, ref)
    empty = boundary.surface_load(getattr(mesh, name)(*args), 7, _flux, cdtype=torch.complex128,
                                  device="cpu")
    assert not bool(empty.any())


def test_boundary_conditions_match_reference():
    m = mesh.annular_mesh_triangles(1.0, 3.0, 5, 17)
    jm = jax_mesh.annular_mesh_triangles(1.0, 3.0, 5, 17)
    c_ref, g_ref = jax_boundary.dirichlet_mask_and_values(
        jm, [jax_boundary.DirichletBC(1, _flux_jax)], jnp.complex128)
    c, g = boundary.dirichlet_mask_and_values(m, [boundary.DirichletBC(1, _flux)],
                                              torch.complex128, device="cpu")
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    _close(g, g_ref)
    for kind, args in (("absorbing", (2, 1.3)), ("absorbing_curved", (2, 1.3, 3.0, 2)),
                       ("absorbing_curved", (2, 1.3, 3.0)), ("admittance", (2, 1.3, 0.4 - 0.1j))):
        ref = getattr(jax_boundary.RobinBC, kind)(*args)
        got = getattr(boundary.RobinBC, kind)(*args)
        assert (got.tag, got.g) == (ref.tag, ref.g) and abs(got.alpha - ref.alpha) < 1e-15


def _annulus_problems():
    """The QA suite's cylinder problem on a small annulus, in both
    packages."""
    args = ANNULUS

    def jflux(x):
        n_hat = -x / jnp.linalg.norm(x, axis=-1, keepdims=True)
        return -(1j * K * n_hat[..., 0]) * jnp.exp(1j * K * x[..., 0])

    def tflux(x):
        n_hat = -x / torch.linalg.norm(x, dim=-1, keepdim=True)
        return -(1j * K * n_hat[..., 0]) * torch.exp(1j * K * x[..., 0])

    ref = jax_problem.HelmholtzProblem(
        jax_mesh.annular_mesh_triangles(*args), K, neumann=[jax_boundary.NeumannBC(1, jflux)],
        robin=[jax_boundary.RobinBC.absorbing_curved(2, K, R_OUT, dim=2)], dtype=jnp.float64)
    port = problem.HelmholtzProblem(
        mesh.annular_mesh_triangles(*args), K, neumann=[boundary.NeumannBC(1, tflux)],
        robin=[boundary.RobinBC.absorbing_curved(2, K, R_OUT, dim=2)], **CPU64)
    return ref, port


@pytest.fixture(scope="module")
def annulus():
    return _annulus_problems()


def test_problem_system_matches_reference(annulus):
    ref, port = annulus
    _close(port.rhs, ref.rhs)
    _close(port.vals, ref.vals)
    _close(port.to_dense(), ref.to_dense())
    _close(port.diagonal(), ref.diagonal())
    assert port.vals.dtype == torch.complex128 and port.device.type == "cpu"


def test_problem_with_dirichlet_source_and_robin_load_matches_reference():
    """Every boundary-condition branch: a Dirichlet ring, a volume source,
    a Robin condition with its own load; the direct solve and the nodal
    L2 error against a closed form."""
    jm, m = jax_mesh.annular_mesh_triangles(*ANNULUS), mesh.annular_mesh_triangles(*ANNULUS)
    ref = jax_problem.HelmholtzProblem(
        jm, 1.7, source_fn=lambda x: jnp.exp(-jnp.sum(x**2, axis=-1)),
        dirichlet=[jax_boundary.DirichletBC(1, _flux_jax)],
        robin=[jax_boundary.RobinBC(2, 0.3 - 1.7j, _flux_jax)], dtype=jnp.float64)
    port = problem.HelmholtzProblem(
        m, 1.7, source_fn=lambda x: torch.exp(-torch.sum(x**2, dim=-1)),
        dirichlet=[boundary.DirichletBC(1, _flux)],
        robin=[boundary.RobinBC(2, 0.3 - 1.7j, _flux)], **CPU64)
    np.testing.assert_array_equal(port.constrained.numpy(), np.asarray(ref.constrained))
    for field in ("rhs", "vals", "g"):
        _close(getattr(port, field), getattr(ref, field))
    x_ref, info_ref = jax_problem.solve_helmholtz(ref, "direct")
    x, info = problem.solve_helmholtz(port, "direct")
    assert info == info_ref
    _close(x, x_ref, 1e-10)
    err_ref = jax_problem.l2_error_at_nodes(jm, x_ref, _flux_jax)
    _close(problem.l2_error_at_nodes(m, x, _flux), err_ref)


# The QA suite's list, then cg and the coloring alias; the reference's
# canonical solver of each.
NAMES = {
    "direct": "direct", "gmres": "gmres", "gmres_jacobi": "gmres_jacobi",
    "gmres_ilu": "gmres_ilu", "gmres_ilu_colored": "gmres_ilu_colored",
    "gmres_ilu_fixed_point": "gmres_ilu", "gmres_schwarz": "gmres_schwarz",
    "gmres_amg": "gmres_amg", "gmres_shifted_laplacian": "gmres_shifted_laplacian",
    "gmres_pipelined": "gmres", "gmres_pipelined_ilu": "gmres_ilu",
    "gmres_pipelined_amg": "gmres_amg", "bicgstab": "bicgstab", "cg": "cg",
    "gmres_ilu_coloring": "gmres_ilu_colored",
}
# The QA suite's Krylov settings; cg, which cannot converge on this
# indefinite system, at a budget of 300.
CONFIG = dict(max_iterations=4000, tolerance=1e-8, restart=60)
BUDGET = {"cg": 300}
# BiCGStab without a preconditioner on this indefinite system amplifies
# rounding: the reference's own ELL and dense forms of the same matrix differ
# by 3% of the residual at step 23 and take 47 and 45 steps to 1e-8 (tests/test_torch_krylov_solvers.py holds BiCGStab's iteration counts
# on a system where they are reproducible). Here it is held to converging in
# within a tenth of the reference's steps, x within 1e-7 of max|x|.
CHAOTIC = {"bicgstab": (0.1, 1e-7)}


def _config(cls, canonical):
    return cls(**dict(CONFIG, max_iterations=BUDGET.get(canonical, CONFIG["max_iterations"])))


@pytest.fixture(scope="module")
def reference_solves(annulus):
    ref, _ = annulus
    out = {}
    for canonical in sorted(set(NAMES.values())):
        x, info = jax_problem.solve_helmholtz(ref, canonical, _config(JaxKrylovConfig, canonical))
        out[canonical] = (np.asarray(x), info)
    return out


@pytest.mark.parametrize("name", list(NAMES))
def test_solve_helmholtz_matches_reference(annulus, reference_solves, name):
    _, port = annulus
    canonical = NAMES[name]
    x, info = problem.solve_helmholtz(port, name, _config(KrylovConfig, canonical))
    x_ref, info_ref = reference_solves[canonical]
    assert info["solver"] == info_ref["solver"] == canonical
    assert info["converged"] == info_ref["converged"] == (canonical != "cg")
    its_tol, x_tol = CHAOTIC.get(canonical, (0, 1e-10))
    assert abs(info["iterations"] - info_ref["iterations"]) <= its_tol * info_ref["iterations"]
    assert np.max(np.abs(x.numpy() - x_ref)) <= x_tol * np.max(np.abs(x_ref))


def test_package_exports_resolve():
    for name in ("HelmholtzProblem", "solve_helmholtz", "DirichletBC", "RobinBC", "NeumannBC",
                 "assemble_lumped_mass", "annular_mesh_triangles",
                 "spherical_shell_mesh_tetrahedra", "circular_mesh_triangles"):
        assert hasattr(jax_fem, name) and hasattr(fem, name)
