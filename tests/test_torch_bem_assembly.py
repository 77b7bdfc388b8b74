"""Port vs reference: BEM surface meshes, incident fields and the dense
collocation assembly (bem/mesh.py, bem/incident.py, bem/assembly.py).

Everything runs on the CPU in float64: the port's ``SurfaceMesh`` /
``icosphere``, quadrature points and self-element angular rule against
the JAX package's to 1e-12; incident fields over a band of wavenumbers;
and the assembled (F, N, N) collocation matrices, rigid and
Burton–Miller, one-shot and in row chunks (96 leaves a ragged last chunk
of 32 rows, which the reference pads), against the reference's
``_assemble_jit`` called once per wavenumber, to 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mathaudio_tpu.bem.assembly import _assemble_jit
from mathaudio_tpu.bem.assembly import _self_angular_rule as jax_self_angular_rule
from mathaudio_tpu.bem.incident import plane_wave as jax_plane_wave
from mathaudio_tpu.bem.incident import point_source as jax_point_source
from mathaudio_tpu.bem.mesh import SurfaceMesh as JaxSurfaceMesh
from mathaudio_tpu.bem.mesh import icosphere as jax_icosphere
from mathaudio_tpu.bem.sweep import sweep_statics as jax_sweep_statics
from mathaudio_tpu_torch.bem import assembly
from mathaudio_tpu_torch.bem.incident import plane_wave, point_source
from mathaudio_tpu_torch.bem.mesh import SurfaceMesh, icosphere
from mathaudio_tpu_torch.convert import sweep_statics_from_numpy

KS = np.array([0.5, 1.75, 3.0])
BETAS = 4.0j / (KS + 8.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these shapes more threads do not shorten
    the tests and, in a parallel test run, only contend with the other
    workers (measured: same wall time, less than half the CPU time)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("subdiv", [0, 1, 2])
def test_icosphere_matches_reference(subdiv):
    got, want = icosphere(1.3, subdiv), jax_icosphere(1.3, subdiv)
    assert got.num_elements == want.num_elements == 20 * 4**subdiv
    np.testing.assert_array_equal(got.elements, want.elements)
    for field in ("nodes", "areas", "normals", "centers"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=0,
                                   atol=1e-12, err_msg=field)
    assert abs(got.avg_element_size() - want.avg_element_size()) < 1e-12
    assert abs(got.ka_radius() - want.ka_radius()) < 1e-12


@pytest.mark.parametrize("subdiv", [0, 1, 2])
@pytest.mark.parametrize("order", [1, 3, 4])
def test_quad_points_match_reference(subdiv, order):
    qp, qw = icosphere(1.0, subdiv).quad_points(order)
    rqp, rqw = jax_icosphere(1.0, subdiv).quad_points(order)
    np.testing.assert_allclose(qp, rqp, rtol=0, atol=1e-12)
    np.testing.assert_allclose(qw, rqw, rtol=0, atol=1e-12)


@pytest.mark.parametrize("subdiv", [0, 1, 2])
def test_self_angular_rule_matches_reference(subdiv):
    r, w = assembly._self_angular_rule(icosphere(1.0, subdiv))
    rr, rw = jax_self_angular_rule(jax_icosphere(1.0, subdiv))
    np.testing.assert_allclose(r, rr, rtol=0, atol=1e-12)
    np.testing.assert_allclose(w, rw, rtol=0, atol=1e-12)


def test_orient_outward_flips_inward_elements():
    mesh = icosphere(1.0, 1)
    flipped = SurfaceMesh(mesh.nodes, mesh.elements[:, [0, 2, 1]])
    assert np.all(np.einsum("nd,nd->n", flipped.normals, flipped.centers) < 0)
    fixed = flipped.orient_outward()
    want = JaxSurfaceMesh(mesh.nodes, mesh.elements[:, [0, 2, 1]]).orient_outward()
    np.testing.assert_array_equal(fixed.elements, want.elements)
    np.testing.assert_allclose(fixed.normals, mesh.normals, rtol=0, atol=1e-15)


def test_quadrilaterals_are_refused():
    """Since slice 4c a quadrilateral is a SurfaceMesh element, as in the
    reference; the subdivided rule of the near-pair upgrade still refuses it."""
    nodes = np.array([[0.0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]])
    quad = SurfaceMesh(nodes, np.array([[0, 1, 2, 3]]))
    assert quad.nodes_per_element == 4
    np.testing.assert_allclose(quad.areas, [1.0], rtol=1e-15)
    np.testing.assert_allclose(quad.normals, [[0.0, 0.0, 1.0]], atol=1e-15)
    with pytest.raises(ValueError, match="triangles"):
        quad.quad_points_refined()


@pytest.mark.parametrize("kind", ["plane", "point"])
def test_incident_fields_match_reference(kind):
    mesh = jax_icosphere(1.0, 1)
    if kind == "plane":
        inc, jinc = plane_wave((0.3, -0.2, 1.0), 0.7 - 0.2j), jax_plane_wave((0.3, -0.2, 1.0), 0.7 - 0.2j)
    else:
        inc, jinc = point_source((0.1, 2.0, -0.4), 1.5), jax_point_source((0.1, 2.0, -0.4), 1.5)
    pts, nrm = torch.tensor(mesh.centers), torch.tensor(mesh.normals)
    ks = torch.tensor(KS)
    p, dp = inc.pressure(pts, ks), inc.normal_derivative(pts, nrm, ks)
    assert p.dtype == torch.complex128 and tuple(p.shape) == (len(KS), mesh.num_elements)
    for f, k in enumerate(KS):
        rp = jinc.pressure(jnp.asarray(mesh.centers), k)
        rdp = jinc.normal_derivative(jnp.asarray(mesh.centers), jnp.asarray(mesh.normals), k)
        np.testing.assert_allclose(_np(p[f]), np.asarray(rp), rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(_np(dp[f]), np.asarray(rdp), rtol=1e-13, atol=1e-15)
    # a scalar wavenumber gives one (N,) field
    np.testing.assert_allclose(_np(inc.pressure(pts, 1.75)), _np(p[1]), rtol=1e-15, atol=0)


@pytest.fixture(scope="module")
def statics():
    """The reference's statics for icosphere subdiv 2 (N=320), and the
    port's copy of them on the CPU in float64."""
    jst = jax_sweep_statics(jax_icosphere(1.0, 2))
    tree = type(jst)(*(np.asarray(a) for a in jst))
    return jst, sweep_statics_from_numpy(tree, device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("with_bm", [False, True], ids=["rigid", "burton_miller"])
@pytest.mark.parametrize("row_block", [0, 64, 96], ids=["one_shot", "rows64", "rows96_ragged"])
def test_assembly_matches_reference(statics, with_bm, row_block):
    jst, st = statics
    a = assembly._assemble(*st, torch.tensor(KS), torch.tensor(BETAS), with_bm, row_block)
    assert a.dtype == torch.complex128 and tuple(a.shape) == (len(KS), 320, 320)
    for f, (k, beta) in enumerate(zip(KS, BETAS)):
        ref = np.asarray(_assemble_jit(*jst, k, beta, with_bm, row_block))
        err = np.max(np.abs(_np(a[f]) - ref)) / np.max(np.abs(ref))
        assert err < 1e-12, (f, err)
