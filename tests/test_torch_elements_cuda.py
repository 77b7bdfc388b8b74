"""On the card: slices 4c and 6c's rest against their twins and the CPU.

The BEM pairwise kernel at the launch shapes of quadrilateral meshes (the
bilinear 2 x 2 rule: nq = 4 with weights that vary with position) against
its plain twins (float32 <= 1e-5, float64 <= 1e-12, off the diagonal where
the points are the surface's own); the near-pair upgrade, BemSolver on a
cube sphere, PML values, and solve_helmholtz on P2, P3, quad and hex meshes
on the GPU against the CPU in float64 (<= 1e-9; upgrade and assembled values
<= 1e-12). These tests need a CUDA device and skip without one; they import
no JAX (the CPU parity with the reference is in test_torch_fem_elements.py
and test_torch_bem_quads.py).

    python -m pytest tests/test_torch_elements_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from mathaudio_tpu_torch.bem import assembly
from mathaudio_tpu_torch.bem.mesh import cube_sphere, icosphere
from mathaudio_tpu_torch.bem.solver import BemProblem, BemSolver
from mathaudio_tpu_torch.bem.types import BemSolverConfig, PhysicsParams, SolverMethod
from mathaudio_tpu_torch.bem.incident import plane_wave
from mathaudio_tpu_torch.fem import HelmholtzProblem, NeumannBC, RobinBC, solve_helmholtz
from mathaudio_tpu_torch.fem import mesh as fem_mesh
from mathaudio_tpu_torch.fem.pml import assemble_pml_values, pml_box_regions
from mathaudio_tpu_torch.fem.refinement import to_p2, to_p3
from mathaudio_tpu_torch.ops import bem_assembly as ops
from mathaudio_tpu_torch.solvers import KrylovConfig

pytestmark = pytest.mark.cuda
F64 = torch.float64
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs the kernel and slices 4c/6c on the card)")
    return torch.device("cuda", 0)


def _max_rel(got, want):
    got, want = got.cpu(), want.cpu()
    return float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want)))


def _off_diagonal_rel(got, ref):
    g, r = got.detach().cpu().clone(), ref.detach().cpu().clone()
    if g.shape[-1] == g.shape[-2]:
        torch.diagonal(g, dim1=-2, dim2=-1).zero_()
        torch.diagonal(r, dim1=-2, dim2=-1).zero_()
    return float(torch.linalg.vector_norm(g - r) / torch.linalg.vector_norm(r))


def _twin(variant, x, nx, yq, ny, w, ks):
    if variant == "double_layer":
        return ops.pairwise_double_layer_ref(x, yq, ny, w, ks)
    if variant == "burton_miller":
        return ops.pairwise_bm_ref(x, nx, yq, ny, w, ks)
    if variant in ("mixed", "mixed_bm"):
        return ops.pairwise_mixed_ref(x, nx, yq, ny, w, ks, variant == "mixed_bm")
    return ops.pairwise_kh_ref(x, yq, ny, w, ks, variant == "kh")


@pytest.mark.parametrize("variant", ["double_layer", "burton_miller", "mixed", "mixed_bm", "kh",
                                     "kh_double"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (F64, 1e-12)])
@pytest.mark.parametrize("nf", [1, 3])
def test_kernel_at_quad_shapes_matches_twin(card, variant, dtype, tol, nf):
    mesh = cube_sphere(1.0, 9)  # 486 quads
    qp, qw = mesh.quad_points()
    field = variant in ("kh", "kh_double")
    pts = 2.0 * np.random.default_rng(0).normal(size=(300, 3))
    pts = 2.0 * pts / np.linalg.norm(pts, axis=1, keepdims=True)
    x = pts if field else mesh.centers

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=card)

    nx = None if field else t(mesh.normals)
    args = (t(x), nx, t(qp), t(mesh.normals), t(qw),
            torch.linspace(1.0, 4.0, nf, dtype=dtype, device=card))
    before = ops.LAUNCHES[variant]
    got = ops.bem_pairwise(variant, *args)
    ref = _twin(variant, *args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[variant] == before + 1
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        assert g.dtype == r.dtype and g.shape == r.shape
        assert _off_diagonal_rel(g, r) < tol


@pytest.mark.parametrize("bm", [False, True])
def test_near_pair_upgrade_card_matches_cpu(card, bm):
    mesh = icosphere(1.0, 2)
    k, beta = 2.0, (0.4j if bm else 0.0)
    a_cpu = assembly.assemble_burton_miller(mesh, k, beta, dtype=F64, device=CPU) if bm else \
        assembly.assemble_collocation_matrix(mesh, k, dtype=F64, device=CPU)
    got = assembly.apply_near_pair_upgrade(a_cpu.to(card), mesh, k, beta)
    want = assembly.apply_near_pair_upgrade(a_cpu, mesh, k, beta)
    assert got.device == a_cpu.to(card).device
    assert _max_rel(got - a_cpu.to(card), want - a_cpu) <= 1e-12


@pytest.mark.parametrize("bm", [False, True])
def test_bem_solver_on_quads_card_matches_cpu(card, bm):
    prob = BemProblem(mesh=cube_sphere(1.0, 6), physics=PhysicsParams.from_wave_number(1.5),
                      incident=plane_wave((0.0, 0.0, 1.0)))
    cfg = BemSolverConfig(method=SolverMethod.GMRES, burton_miller=bm, tolerance=1e-10)
    pts = np.array([[0.0, 0.0, 2.0], [1.5, 1.0, -1.0], [-2.0, 0.5, 0.3]])
    (p_g, f_g, info_g), (p_c, f_c, info_c) = (
        (sol.surface_pressure, sol.evaluate_pressure(pts), sol.info)
        for sol in (BemSolver(cfg, dtype=F64, device=where).solve(prob) for where in (card, CPU)))
    assert info_g["iterations"] == info_c["iterations"]
    assert _max_rel(p_g, p_c) <= 1e-9 and _max_rel(f_g, f_c) <= 1e-9


def test_pml_values_card_match_cpu(card):
    mesh = fem_mesh.box_mesh_tetrahedra(0, 2.0, 0, 1.5, 0, 1.0, 8, 6, 4)
    regions = pml_box_regions((0, 2.0, 0, 1.5, 0, 1.0), 0.3, sigma_max=12.0)
    _, k_g, m_g = assemble_pml_values(mesh, regions, 3.0, dtype=F64, device=card)
    _, k_c, m_c = assemble_pml_values(mesh, regions, 3.0, dtype=F64, device=CPU)
    assert _max_rel(k_g, k_c) <= 1e-12 and _max_rel(m_g, m_c) <= 1e-12


MESHES = {
    "p2 annulus": lambda: to_p2(fem_mesh.annular_mesh_triangles(1.0, 3.0, 8, 32)),
    "p3 annulus": lambda: to_p3(fem_mesh.annular_mesh_triangles(1.0, 3.0, 6, 24)),
    "p2 shell": lambda: to_p2(fem_mesh.spherical_shell_mesh_tetrahedra(1.0, 2.5, 3, 1)),
    "p3 shell": lambda: to_p3(fem_mesh.spherical_shell_mesh_tetrahedra(1.0, 2.5, 1, 0)),
}


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("solver", ["direct", "gmres_jacobi", "gmres_amg", "gmres_schwarz",
                                    "gmres_ilu_colored"])
def test_higher_order_solve_card_matches_cpu(card, name, solver):
    mesh = MESHES[name]()
    ax = 0 if mesh.dim == 2 else 2
    k = 1.0

    def flux(x):
        n_hat = -x / torch.linalg.norm(x, dim=-1, keepdim=True)
        return -(1j * k * n_hat[..., ax]) * torch.exp(1j * k * x[..., ax])

    r_out = 3.0 if mesh.dim == 2 else 2.5
    (u_g, info_g), (u_c, info_c) = (
        solve_helmholtz(HelmholtzProblem(mesh, k, neumann=[NeumannBC(1, flux)],
                                         robin=[RobinBC.absorbing_curved(2, k, r_out, dim=mesh.dim)],
                                         dtype=F64, device=where),
                        solver, KrylovConfig(max_iterations=3000, tolerance=1e-10, restart=60))
        for where in (card, CPU))
    assert info_g["iterations"] == info_c["iterations"] and info_g["converged"]
    assert _max_rel(u_g, u_c) <= 1e-9


@pytest.mark.parametrize("gen,args", [("unit_square_quads", (10,)), ("unit_cube_hexahedra", (5,))])
@pytest.mark.parametrize("solver", ["gmres_jacobi", "gmres_shifted_laplacian"])
def test_quad_and_hex_solve_card_matches_cpu(card, gen, args, solver):
    mesh = getattr(fem_mesh, gen)(*args)
    k = 3.0

    def source(x):
        return torch.exp(-torch.sum((x - 0.3) ** 2, dim=-1) / 0.02).to(torch.complex128)

    (u_g, info_g), (u_c, info_c) = (
        solve_helmholtz(HelmholtzProblem(mesh, k, source_fn=source,
                                         robin=[RobinBC.admittance(t, k, 0.2) for t in (1, 2, 3, 4)],
                                         dtype=F64, device=where),
                        solver, KrylovConfig(max_iterations=3000, tolerance=1e-10, restart=60))
        for where in (card, CPU))
    assert info_g["iterations"] == info_c["iterations"] and info_g["converged"]
    assert _max_rel(u_g, u_c) <= 1e-9
