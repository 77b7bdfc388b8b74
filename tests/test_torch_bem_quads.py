"""Port vs reference: slice 4c, the BEM leftovers.

bem/mesh.py: quadrilateral SurfaceMesh elements (bilinear areas and the 2 x
2 tensor rule), nodes_per_element, quad_points_refined and the uv_sphere,
cylinder_mesh and cube_sphere generators give equal arrays. The CBIE and
Burton–Miller systems on cube_sphere(1.0, 4) (96 quads) agree within 1e-12
of the largest entry; the near-pair upgrade (same pairs in the same order)
within 1e-12 on icosphere(1.0, 1); bem/io.py parses NC.inp and its node and
element files to equal values, and BemConfig (JSON and TOML) builds the
same problem, solved within 1e-9. Also F5: pairwise_mixed_xla, the plain
form under the reference's name, agrees within 1e-12.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mathaudio_tpu.bem.assembly as jax_assembly
import mathaudio_tpu.bem.io as jax_io
import mathaudio_tpu.bem.mesh as jax_mesh
import mathaudio_tpu.ops.bem_assembly as jax_ops
from mathaudio_tpu.bem.solver import BemSolver as JaxBemSolver
from mathaudio_tpu.bem.types import BemSolverConfig as JaxConfig
from mathaudio_tpu.bem.types import SolverMethod as JaxMethod
from mathaudio_tpu_torch.bem import assembly, io, mesh
from mathaudio_tpu_torch.bem.solver import BemSolver
from mathaudio_tpu_torch.bem.types import BemSolverConfig, SolverMethod
from mathaudio_tpu_torch.ops import bem_assembly as ops

CPU64 = dict(dtype=torch.float64, device="cpu")


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


MESHES = [("icosphere", (1.0, 1)), ("uv_sphere", (1.0, 6, 12)), ("uv_sphere", (2.0, 9, 7)),
          ("cylinder_mesh", (1.0, 2.0, 10, 4, True)), ("cylinder_mesh", (0.5, 3.0, 7, 3, False)),
          ("cube_sphere", (1.0, 4)), ("cube_sphere", (1.5, 3))]


@pytest.mark.parametrize("name,args", MESHES, ids=[f"{n}{a}" for n, a in MESHES])
def test_surface_mesh_equals_reference(name, args):
    got, ref = getattr(mesh, name)(*args), getattr(jax_mesh, name)(*args)
    assert got.nodes_per_element == ref.nodes_per_element
    assert got.num_elements == ref.num_elements
    np.testing.assert_array_equal(got.nodes, ref.nodes)
    np.testing.assert_array_equal(got.elements, ref.elements)
    for field in ("areas", "normals", "centers"):
        np.testing.assert_allclose(getattr(got, field), getattr(ref, field), rtol=0, atol=1e-15)
    assert got.avg_element_size() == ref.avg_element_size()
    assert got.ka_radius() == ref.ka_radius()
    for order in (2, 3, 4):
        for g, r in zip(got.quad_points(order), ref.quad_points(order)):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-15)
    if got.nodes_per_element == 3:
        for g, r in zip(got.quad_points_refined(3, 2), ref.quad_points_refined(3, 2)):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-15)
    else:
        with pytest.raises(ValueError, match="triangles"):
            got.quad_points_refined()
    flipped = mesh.SurfaceMesh(got.nodes, got.elements[:, ::-1].copy()).orient_outward()
    ref_flipped = jax_mesh.SurfaceMesh(ref.nodes, ref.elements[:, ::-1].copy()).orient_outward()
    np.testing.assert_array_equal(flipped.elements, ref_flipped.elements)


def test_warped_quad_area_is_the_bilinear_patch():
    nodes = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.2], [1.0, 1.0, -0.1], [0.0, 1.0, 0.3]])
    got = mesh.SurfaceMesh(nodes, np.array([[0, 1, 2, 3]]))
    ref = jax_mesh.SurfaceMesh(nodes, np.array([[0, 1, 2, 3]]))
    np.testing.assert_allclose(got.areas, ref.areas, rtol=1e-15)
    _, qw = got.quad_points()
    np.testing.assert_allclose(qw.sum(), got.areas[0], rtol=1e-14)


QUAD_K = 1.3


@pytest.mark.parametrize("bm", [False, True], ids=["cbie", "burton_miller"])
def test_quad_systems_equal_reference(bm):
    got_m, ref_m = mesh.cube_sphere(1.0, 4), jax_mesh.cube_sphere(1.0, 4)
    if bm:
        got = assembly.assemble_burton_miller(got_m, QUAD_K, 0.4j, **CPU64)
        ref = jax_assembly.assemble_burton_miller(ref_m, QUAD_K, 0.4j, dtype=jnp.float64)
    else:
        got = assembly.assemble_collocation_matrix(got_m, QUAD_K, **CPU64)
        ref = jax_assembly.assemble_collocation_matrix(ref_m, QUAD_K, dtype=jnp.float64)
    _close(got, ref)
    # quads pass through the near-pair upgrade unchanged, as in the reference
    assert assembly.apply_near_pair_upgrade(got, got_m, QUAD_K, 0.4j if bm else 0.0) is got


@pytest.mark.parametrize("bm", [False, True], ids=["cbie", "burton_miller"])
def test_quad_solve_equals_reference(bm):
    got_m, ref_m = mesh.cube_sphere(1.0, 4), jax_mesh.cube_sphere(1.0, 4)
    from mathaudio_tpu.bem import BemProblem as JaxProblem, plane_wave as jax_plane_wave
    from mathaudio_tpu.bem.types import PhysicsParams as JaxPhysics
    from mathaudio_tpu_torch.bem import BemProblem, plane_wave
    from mathaudio_tpu_torch.bem.types import PhysicsParams

    prob = BemProblem(got_m, PhysicsParams.from_wave_number(QUAD_K), plane_wave((0.3, 0.0, 1.0)))
    ref_prob = JaxProblem(ref_m, JaxPhysics.from_wave_number(QUAD_K),
                          jax_plane_wave((0.3, 0.0, 1.0)))
    sol = BemSolver(BemSolverConfig(method=SolverMethod.LU, burton_miller=bm), **CPU64).solve(prob)
    ref = JaxBemSolver(JaxConfig(method=JaxMethod.LU, burton_miller=bm)).solve(ref_prob)
    _close(sol.surface_pressure, ref.surface_pressure, 1e-9)
    pts = np.array([[0.0, 0.0, 2.0], [1.5, -1.0, 0.5]])
    _close(sol.evaluate_pressure(pts), ref.evaluate_pressure(jnp.asarray(pts)), 1e-9)


NEAR_K = 2.0


def test_near_pairs_equal_reference():
    for sub in (0, 1):
        got = assembly._near_pairs(mesh.icosphere(1.0, sub))
        ref = jax_assembly._near_pairs(jax_mesh.icosphere(1.0, sub))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    pi, _ = assembly._near_pairs(mesh.icosphere(1.0, 1), near_factor=0.1)
    assert len(pi) == 0


@pytest.mark.parametrize("bm", [False, True], ids=["cbie", "burton_miller"])
def test_near_pair_upgrade_equals_reference(bm):
    got_m, ref_m = mesh.icosphere(1.0, 1), jax_mesh.icosphere(1.0, 1)
    beta = 0.5j if bm else 0.0
    if bm:
        a = assembly.assemble_burton_miller(got_m, NEAR_K, beta, **CPU64)
        ref_a = jax_assembly.assemble_burton_miller(ref_m, NEAR_K, beta, dtype=jnp.float64)
    else:
        a = assembly.assemble_collocation_matrix(got_m, NEAR_K, **CPU64)
        ref_a = jax_assembly.assemble_collocation_matrix(ref_m, NEAR_K, dtype=jnp.float64)
    before = a.clone()
    got = assembly.apply_near_pair_upgrade(a, got_m, NEAR_K, beta)
    ref = jax_assembly.apply_near_pair_upgrade(ref_a, ref_m, NEAR_K, beta, dtype=jnp.float64)
    assert torch.equal(a, before)  # a copy, as the reference returns a new array
    _close(got, ref)
    _close(got - a, np.asarray(ref) - np.asarray(ref_a))
    assert np.count_nonzero((got - a).numpy()) > 0  # the upgrade moved entries


SAMPLE = """##-------------------------------------------
## This file was created by mesh2input
##-------------------------------------------
Mesh2HRTF 1.0.0
##
Test Description
##
## Controlparameter I
0 0 0 0 7 0
##
## Controlparameter II
1 1 0.000001 0.00e+00 1 0 0
##
## Load Frequency Curve
0 2
0.000000 0.000000e+00 0.0
0.000001 0.400000e+04 0.0
##
## 1. Main Parameters I
2 100 50 0 0 2 1 0 0
##
## 2. Main Parameters II
1 0 0 0.0000e+00 0 0 0
##
## 3. Main Parameters III
0 0 0 0
##
## 4. Main Parameters IV
343 1.21 1.0 0.0 0.0 0.0 0.0
##
NODES
nodes.txt
##
ELEMENTS
elements.txt
##
BOUNDARY
ELEM 0 TO 49 VELO 1.0 -1 0.0 -1
ELEM 50 TO 59 PRES 0.5 -1 0.25 -1
RETU
##
PLANE WAVES
1 0.0 -1.0 0.0 1.0 -1 0.0 -1
##
POINT SOURCES
1 0.5 0.5 2.0 2.0 -1 1.0 -1
##
END
"""


def _fields(obj):
    """Dataclass fields as plain values (arrays as lists)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif isinstance(v, list):
            v = [_fields(x) if dataclasses.is_dataclass(x) else x for x in v]
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        out[f.name] = v
    return out


@pytest.mark.parametrize("text", [SAMPLE, SAMPLE.replace("Test Description", "").replace(
    "## Controlparameter I\n0 0 0 0 7 0\n", "")], ids=["sample", "sparse"])
def test_nc_input_parses_as_reference(text):
    got = io.parse_nc_input_string(text, base_dir="somewhere")
    ref = jax_io.parse_nc_input_string(text, base_dir="somewhere")
    assert _fields(got) == _fields(ref)
    np.testing.assert_array_equal(got.frequencies(), ref.frequencies())
    phys, ref_phys = got.to_physics_params(500.0), ref.to_physics_params(500.0)
    assert (phys.frequency, phys.speed_of_sound, phys.density) == (
        ref_phys.frequency, ref_phys.speed_of_sound, ref_phys.density)


def test_nc_files_load_as_reference(tmp_path):
    (tmp_path / "NC.inp").write_text(SAMPLE)
    nodes = np.random.default_rng(0).normal(size=(7, 3))
    (tmp_path / "nodes.txt").write_text("# header comment\n7\n" + "".join(
        f"{i} {x!r} {y!r} {z!r}\n" for i, (x, y, z) in enumerate(nodes.tolist())))
    # triangles, quads (split in two) and triangles with trailing type/group columns
    (tmp_path / "elements.txt").write_text("5\n0 0 1 2\n1 1 2 3 4 0 0\n2 2 3 4\n"
                                          "3 3 4 5 6 1 2\n4 0 5 6 5 0\n")
    got = io.parse_nc_input(str(tmp_path / "NC.inp"))
    ref = jax_io.parse_nc_input(str(tmp_path / "NC.inp"))
    assert _fields(got) == _fields(ref) and got.base_dir == str(tmp_path)
    for fn in ("load_nc_nodes", "load_nc_elements"):
        path = str(tmp_path / ("nodes.txt" if fn == "load_nc_nodes" else "elements.txt"))
        g, r = getattr(io, fn)(path), getattr(jax_io, fn)(path)
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


CONFIGS = [
    {"frequency": 120.0, "mesh": {"type": "icosphere", "radius": 0.5, "subdivisions": 1},
     "incident": {"type": "plane", "direction": [0.0, 1.0, 1.0]}},
    {"frequency": 80.0, "speed_of_sound": 340.0, "density": 1.2,
     "mesh": {"type": "uv_sphere", "radius": 1.0, "n_theta": 6, "n_phi": 12},
     "incident": {"type": "point", "position": [0.0, 0.0, 3.0], "amplitude": 2.0},
     "solver": {"method": "lu"}, "ignored": 1},
    {"frequency": 60.0, "mesh": {"type": "cylinder", "radius": 0.8, "height": 1.5,
                                 "n_circ": 10, "n_height": 3}},
]


def _toml(d):
    """The config as TOML text (flat tables, which is all BemConfig has)."""
    def val(v):
        if isinstance(v, str):
            return f'"{v}"'
        if isinstance(v, list):
            return "[" + ", ".join(val(x) for x in v) + "]"
        return repr(v)

    top = [f"{k} = {val(v)}" for k, v in d.items() if not isinstance(v, dict)]
    tables = [f"[{k}]\n" + "\n".join(f"{kk} = {val(vv)}" for kk, vv in v.items())
              for k, v in d.items() if isinstance(v, dict)]
    return "\n".join(top) + "\n\n" + "\n\n".join(tables) + "\n"


@pytest.mark.parametrize("i", range(len(CONFIGS)))
@pytest.mark.parametrize("suffix", [".json", ".toml"])
def test_bem_config_solves_as_reference(tmp_path, i, suffix):
    import json

    path = tmp_path / f"config{suffix}"
    path.write_text(json.dumps(CONFIGS[i]) if suffix == ".json" else _toml(CONFIGS[i]))
    got, ref = io.BemConfig.from_file(str(path)), jax_io.BemConfig.from_file(str(path))
    assert _fields(got) == _fields(ref)
    prob, ref_prob = got.build_problem(), ref.build_problem()
    np.testing.assert_array_equal(prob.mesh.elements, ref_prob.mesh.elements)
    np.testing.assert_array_equal(prob.mesh.nodes, ref_prob.mesh.nodes)
    assert prob.physics.wave_number == ref_prob.physics.wave_number
    if suffix == ".toml":
        return  # one solve per config
    sol = BemSolver(BemSolverConfig(method=SolverMethod.LU), **CPU64).solve(prob)
    ref_sol = JaxBemSolver(JaxConfig(method=JaxMethod.LU)).solve(ref_prob)  # x64: float64
    _close(sol.surface_pressure, ref_sol.surface_pressure, 1e-9)


def test_bem_config_refuses_an_unknown_mesh():
    with pytest.raises(ValueError, match="unknown mesh type"):
        io.BemConfig(mesh={"type": "torus"}).build_problem()


def _off_diagonal(a):
    a = np.array(a)
    if a.shape[-1] == a.shape[-2]:
        ii = np.arange(a.shape[-1])
        a[..., ii, ii] = 0.0
    return a


@pytest.mark.parametrize("with_bm", [False, True])
def test_pairwise_mixed_xla_matches_reference(with_bm):
    m = mesh.cube_sphere(1.0, 3)
    qp, qw = m.quad_points()
    args = (m.centers, m.normals, qp, m.normals, qw)
    before = dict(ops.LAUNCHES)
    got = ops.pairwise_mixed_xla(*(torch.tensor(a) for a in args), 1.7, with_bm)
    want = jax_ops.pairwise_mixed_xla(*(jnp.asarray(a) for a in args), 1.7, with_bm)
    assert ops.LAUNCHES == before
    assert len(got) == len(want) == 6
    for g, r in zip(got, want):
        if r is None:
            assert g is None
            continue
        assert tuple(g.shape) == np.shape(r)
        np.testing.assert_allclose(_off_diagonal(g.numpy()), _off_diagonal(np.asarray(r)),
                                   rtol=0, atol=1e-12)
