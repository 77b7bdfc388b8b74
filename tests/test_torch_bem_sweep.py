"""Port vs reference: the dense BEM frequency sweep (bem/sweep.py).

``sweep_apply`` of mathaudio_tpu_torch against mathaudio_tpu's on an
icosphere with 320 elements and 5 wavenumbers in [0.5, 3.0]: direct LU
and Jacobi-GMRES (tol 1e-5, restart 16), rigid and Burton–Miller, the
whole band at once and in chunks of 2 (the last chunk padded). Both run
on the CPU in float64 from the same statics (``sweep_statics_from_numpy``
of the reference's); pressures must agree to 1e-9 relative. So must
``bem_frequency_sweep`` with the constant and the piecewise
Burton–Miller beta rules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mathaudio_tpu.bem.incident import plane_wave as jax_plane_wave
from mathaudio_tpu.bem.mesh import icosphere as jax_icosphere
from mathaudio_tpu.bem.sweep import bem_frequency_sweep as jax_bem_frequency_sweep
from mathaudio_tpu.bem.sweep import sweep_apply as jax_sweep_apply
from mathaudio_tpu.bem.sweep import sweep_statics as jax_sweep_statics
from mathaudio_tpu_torch.bem import sweep
from mathaudio_tpu_torch.bem.incident import plane_wave
from mathaudio_tpu_torch.bem.mesh import icosphere
from mathaudio_tpu_torch.convert import sweep_statics_from_numpy

KS = np.linspace(0.5, 3.0, 5)
BM_BETA_SCALE = 4.0


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


def _rel(got, want):
    """Largest per-frequency relative 2-norm error."""
    got, want = _np(got), np.asarray(want)
    return float(np.max(np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)))


@pytest.fixture(scope="module")
def problem():
    """Reference statics and band inputs, the port's copy of the statics,
    and a per-variant cache of the reference's pressures."""
    jmesh = jax_icosphere(1.0, 2)
    jst = jax_sweep_statics(jmesh)
    tst = sweep_statics_from_numpy(type(jst)(*(np.asarray(a) for a in jst)),
                                   device="cpu", dtype=torch.float64)
    inc = jax_plane_wave((0.0, 0.0, 1.0))
    ks = jnp.asarray(KS)
    h = jmesh.avg_element_size()
    inputs = {}
    for bm in (False, True):
        if bm:
            betas = BM_BETA_SCALE * 1j / (ks + 1.0 / h)
            rhs = jax.vmap(lambda k, b: inc.pressure(jst.centers, k)
                           - b * inc.normal_derivative(jst.centers, jst.normals, k))(ks, betas)
        else:
            betas = jnp.zeros_like(ks).astype(jnp.complex128)
            rhs = jax.vmap(lambda k: inc.pressure(jst.centers, k))(ks)
        inputs[bm] = (betas, rhs)
    cache = {}

    def reference(bm, solver, chunk):
        key = (bm, solver, chunk)
        if key not in cache:
            betas, rhs = inputs[bm]
            cache[key] = np.asarray(jax_sweep_apply(jst, ks, betas, rhs, burton_miller=bm,
                                                    freq_chunk=chunk, solver=solver))
        return cache[key]

    port_inputs = {bm: tuple(torch.tensor(np.asarray(a)) for a in v) for bm, v in inputs.items()}
    return tst, port_inputs, reference


@pytest.mark.parametrize("chunk", [0, 2], ids=["whole_band", "chunks2_padded"])
@pytest.mark.parametrize("solver", ["lu", "gmres"])
@pytest.mark.parametrize("bm", [False, True], ids=["rigid", "burton_miller"])
def test_sweep_apply_matches_reference(problem, bm, solver, chunk):
    statics, inputs, reference = problem
    betas, rhs = inputs[bm]
    p = sweep.sweep_apply(statics, torch.tensor(KS), betas, rhs, burton_miller=bm,
                          freq_chunk=chunk, solver=solver)
    assert p.dtype == torch.complex128 and tuple(p.shape) == (len(KS), 320)
    assert _rel(p, reference(bm, solver, chunk)) < 1e-9


@pytest.mark.parametrize("beta_scale", [4.0, 0.0], ids=["constant", "piecewise_ka"])
def test_bem_frequency_sweep_matches_reference(beta_scale):
    ks = np.array([0.3, 1.0, 2.5])  # ka below 0.5, in [0.5, 2) and above 2
    ref = jax_bem_frequency_sweep(jax_icosphere(1.0, 2), ks, jax_plane_wave((0.0, 0.0, 1.0)),
                                  burton_miller=True, beta_scale=beta_scale)
    got = sweep.bem_frequency_sweep(icosphere(1.0, 2), ks, plane_wave((0.0, 0.0, 1.0)),
                                    burton_miller=True, beta_scale=beta_scale,
                                    dtype=torch.float64, device="cpu")
    assert _rel(got, ref) < 1e-9


def test_piecewise_beta_rule_picks_each_scale():
    mesh = icosphere(1.0, 2)
    statics = sweep.sweep_statics(mesh, dtype=torch.float64, device="cpu")
    ks = torch.tensor([0.3, 1.0, 2.5], dtype=torch.float64)
    betas, _ = sweep.sweep_inputs(mesh, statics, ks, plane_wave(), True, beta_scale=0.0)
    h = mesh.avg_element_size()
    np.testing.assert_allclose(_np(betas), np.array([4.0, 2.0, 1.0]) * 1j / (_np(ks) + 1 / h),
                               rtol=1e-15)
    betas0, rhs0 = sweep.sweep_inputs(mesh, statics, ks, plane_wave(), False)
    assert not bool(torch.any(betas0 != 0)) and tuple(rhs0.shape) == (3, 320)


def test_statics_round_trip():
    """The reference's statics carried across equal the port's own."""
    mesh = icosphere(1.0, 2)
    jst = jax_sweep_statics(jax_icosphere(1.0, 2))
    carried = sweep_statics_from_numpy(type(jst)(*(np.asarray(a) for a in jst)),
                                       device="cpu", dtype=torch.float64)
    own = sweep.sweep_statics(mesh, dtype=torch.float64, device="cpu")
    assert carried._fields == own._fields
    for name, a, b in zip(own._fields, carried, own):
        assert a.dtype == b.dtype == torch.float64 and a.shape == b.shape, name
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-12, err_msg=name)
    f32 = sweep_statics_from_numpy(type(jst)(*(np.asarray(a) for a in jst)), device="cpu")
    assert all(t.dtype == torch.float32 for t in f32)


def test_sweep_entry_points_refuse_to_drift_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is valid here")
    mesh = icosphere(1.0, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.sweep_statics(mesh)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.sweep_fn(mesh)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.bem_frequency_sweep(mesh, [1.0], plane_wave())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_statics_from_numpy(sweep.sweep_statics(mesh, device="cpu"))


def test_unknown_solver_is_refused():
    statics = sweep.sweep_statics(icosphere(1.0, 0), dtype=torch.float64, device="cpu")
    ks = torch.tensor([1.0], dtype=torch.float64)
    with pytest.raises(ValueError, match="solver"):
        sweep.sweep_apply(statics, ks, torch.zeros(1, dtype=torch.complex128),
                          torch.ones((1, 20), dtype=torch.complex128), solver="qr")
