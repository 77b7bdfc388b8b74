"""Port vs reference: the mixed velocity/pressure dense BEM system
(bem/assembly.py: assemble_mixed_system, single_layer_self_terms, and the
single-k fronts assemble_collocation_matrix / assemble_burton_miller).

Both packages get the same mesh and the same boundary data (seeded numpy
arrays, carried across by mathaudio_tpu_torch.convert) on the CPU in
float64. A, b and unknown_p are compared for velocity, pressure,
half-and-half, admittance and incident-field cases, without (beta = 0)
and with Burton–Miller (beta != 0), one-shot and in row chunks of 48 (the
80-element icosphere then leaves a ragged last chunk of 32 rows, which
the reference pads), to 1e-12 of max|A| (b: of max|b|). The reference's
assembly is jitted per (Burton–Miller, row_block) pair, so the cases
share four compilations.
"""

import numpy as np
import pytest
import torch

from mathaudio_tpu.bem import assembly as jax_assembly
from mathaudio_tpu.bem.incident import plane_wave as jax_plane_wave
from mathaudio_tpu.bem.mesh import icosphere as jax_icosphere
from mathaudio_tpu.bem.types import BoundaryCondition as JaxBoundaryCondition
from mathaudio_tpu_torch.bem import assembly
from mathaudio_tpu_torch.bem.incident import plane_wave
from mathaudio_tpu_torch.convert import boundary_condition_from_numpy, surface_mesh_from_numpy

K = 1.3
BETA = 0.05 + 0.3j
CASES = ("velocity", "pressure", "half", "admittance", "incident")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these shapes more threads do not shorten
    the tests and only contend with the other workers of a parallel run."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def meshes():
    jm = jax_icosphere(1.0, 1)
    return jm, surface_mesh_from_numpy(jm.nodes, jm.elements)


def _boundary(case, mesh):
    """(types, values, admittance, incident direction) of a case, from a seed."""
    n = mesh.num_elements
    rng = np.random.default_rng(11)
    values = rng.normal(size=n) + 1j * rng.normal(size=n)
    upper = mesh.centers[:, 2] >= 0.0
    types = {"velocity": np.zeros(n, np.int32), "pressure": np.ones(n, np.int32)}.get(
        case, np.where(upper, 0, 1).astype(np.int32))
    adm = (0.2 + 0.1j) * rng.uniform(0.5, 1.5, n) if case == "admittance" else None
    direction = (0.3, -0.2, 1.0) if case == "incident" else None
    return types, values, adm, direction


@pytest.mark.parametrize("row_block", [None, 48], ids=["one_shot", "rows48_ragged"])
@pytest.mark.parametrize("beta", [0.0, BETA], ids=["cbie", "burton_miller"])
@pytest.mark.parametrize("case", CASES)
def test_mixed_system_matches_reference(meshes, case, beta, row_block):
    jm, tm = meshes
    types, values, adm, direction = _boundary(case, jm)
    ra, rb, rup = jax_assembly.assemble_mixed_system(
        jm, K, JaxBoundaryCondition(types, values, adm), beta=beta,
        incident=None if direction is None else jax_plane_wave(direction),
        row_block=row_block)
    a, b, up = assembly.assemble_mixed_system(
        tm, K, boundary_condition_from_numpy(types, values, adm), beta=beta,
        incident=None if direction is None else plane_wave(direction),
        row_block=row_block, dtype=torch.float64, device="cpu")
    ra, rb = np.asarray(ra), np.asarray(rb)
    assert a.dtype == torch.complex128 and tuple(a.shape) == ra.shape
    assert up.dtype == bool and np.array_equal(up, np.asarray(rup))
    assert bool(torch.isfinite(a).all())
    assert np.max(np.abs(a.numpy() - ra)) < 1e-12 * np.max(np.abs(ra))
    assert np.max(np.abs(b.numpy() - rb)) < 1e-12 * max(np.max(np.abs(rb)), 1.0)


def test_mixed_system_quad_order_and_physics_follow_the_arguments(meshes):
    jm, tm = meshes
    types, values, _, _ = _boundary("half", jm)
    kw = dict(beta=BETA, quad_order=3, density=1.1, speed_of_sound=330.0)
    ra, rb, _ = jax_assembly.assemble_mixed_system(jm, K, JaxBoundaryCondition(types, values),
                                                   **kw)
    a, b, _ = assembly.assemble_mixed_system(tm, K, boundary_condition_from_numpy(types, values),
                                             dtype=torch.float64, device="cpu", **kw)
    assert np.max(np.abs(a.numpy() - np.asarray(ra))) < 1e-12 * np.max(np.abs(np.asarray(ra)))
    assert np.max(np.abs(b.numpy() - np.asarray(rb))) < 1e-12 * np.max(np.abs(np.asarray(rb)))


def test_mixed_system_refuses_wrong_boundary_shapes(meshes):
    _, tm = meshes
    n = tm.num_elements
    with pytest.raises(ValueError, match="boundary types"):
        assembly.assemble_mixed_system(tm, K, boundary_condition_from_numpy(
            np.zeros(n - 1, np.int32), np.zeros(n - 1)), device="cpu")
    with pytest.raises(ValueError, match="boundary values"):
        assembly.assemble_mixed_system(tm, K, boundary_condition_from_numpy(
            np.zeros(n, np.int32), np.zeros(n + 1)), device="cpu")


@pytest.mark.parametrize("row_block", [None, 48], ids=["one_shot", "rows48_ragged"])
@pytest.mark.parametrize("with_bm", [False, True], ids=["cbie", "burton_miller"])
def test_single_k_fronts_match_reference(meshes, with_bm, row_block):
    jm, tm = meshes
    if with_bm:
        ref = jax_assembly.assemble_burton_miller(jm, K, BETA, row_block=row_block)
    else:
        ref = jax_assembly.assemble_collocation_matrix(jm, K, row_block=row_block)
    kw = dict(row_block=row_block, dtype=torch.float64, device="cpu")
    got = (assembly.assemble_burton_miller(tm, K, BETA, **kw) if with_bm
           else assembly.assemble_collocation_matrix(tm, K, **kw))
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    assert np.max(np.abs(got.numpy() - ref)) < 1e-12 * np.max(np.abs(ref))


def test_single_layer_self_terms_match_reference(meshes):
    jm, tm = meshes
    ref = np.asarray(jax_assembly.single_layer_self_terms(jm, K))
    got = assembly.single_layer_self_terms(tm, K, dtype=torch.float64, device="cpu")
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13, atol=1e-15)


def test_auto_row_block_on_the_cpu_follows_the_reference():
    like = torch.zeros(1, dtype=torch.float64)
    for n, nq in ((320, 7), (2048, 4), (5120, 4), (20480, 7)):
        assert (assembly._resolve_row_block(None, n, nq, like, "mixed_bm")
                == jax_assembly._resolve_row_block(None, n, nq))
    assert assembly._resolve_row_block(96, 5120, 4, like, "mixed") == 96
