"""Port vs reference: the DIA stencil operator (fem/dia.py).

The plain PyTorch twins (dia_matvec_ref / dia_residual_ref /
dia_jacobi_ref) are held against the reference's XLA form in float64 and
against its Pallas kernel (interpret mode on the CPU) in complex64. The
CUDA kernel itself is held against the twins by the tests marked
``cuda`` (they skip without a card) and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mathaudio_tpu.fem.assembly import HelmholtzAssembler as JaxAssembler
from mathaudio_tpu.fem.dia import dia_diag as jax_dia_diag
from mathaudio_tpu.fem.dia import dia_matvec as jax_dia_matvec
from mathaudio_tpu.fem.dia import dia_matvec_pallas as jax_dia_matvec_pallas
from mathaudio_tpu.fem.dia import dia_pattern as jax_dia_pattern
from mathaudio_tpu.fem.dia import dia_tables_of as jax_dia_tables_of
from mathaudio_tpu.fem.mesh import unit_cube_tetrahedra as jax_unit_cube
from mathaudio_tpu_torch.fem import dia
from mathaudio_tpu_torch.fem.assembly import HelmholtzAssembler
from mathaudio_tpu_torch.fem.mesh import unit_cube_tetrahedra

WALLS = (1, 2, 3, 4, 5, 6)
ALPHA = 0.15
SHIFT = 1.0 + 0.5j  # coarse-level shifted-Laplacian cm = (b1 + i b2) k^2


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def level():
    """(offsets, port tables, reference tables) of an n=5 box level."""
    jasm = JaxAssembler(jax_unit_cube(5), robin_tags=WALLS)
    joffs, jtabs = jax_dia_tables_of(jasm, sum(jasm.b_vals.values()))
    asm = HelmholtzAssembler(unit_cube_tetrahedra(5), robin_tags=WALLS,
                             dtype=torch.float64, device="cpu")
    offs, tabs = dia.dia_tables_of(asm, sum(asm.b_vals.values()))
    assert offs == joffs
    return offs, tabs, jtabs


def _lanes(nf, shifted, dtype=np.complex128):
    ks = np.linspace(0.55, 2.2, nf)
    cm = ((SHIFT if shifted else 1.0) * ks * ks).astype(dtype)
    cb = (-1j * ALPHA * ks).astype(dtype)
    return cm, cb


def _vec(rng, n, nf, dtype=np.complex128):
    return (rng.standard_normal((n, nf)) + 1j * rng.standard_normal((n, nf))).astype(dtype)


def _rel(a, b):
    return np.linalg.norm(_np(a) - _np(b)) / np.linalg.norm(_np(b))


@pytest.mark.parametrize("n", [3, 4, 5])
def test_box_stencil_has_15_diagonals(n):
    asm = HelmholtzAssembler(unit_cube_tetrahedra(n), dtype=torch.float64, device="cpu")
    offs, d_of_slot = dia.dia_pattern(asm.row_of_slot, asm.col_of_slot)
    assert len(offs) == 15
    s = n + 1
    assert max(offs) == s * s + s + 1  # the halo of the stencil
    roffs, rd = jax_dia_pattern(asm.row_of_slot.numpy(), asm.col_of_slot.numpy())
    assert offs == roffs
    np.testing.assert_array_equal(d_of_slot, rd)


def test_tables_match_reference(level):
    _, tabs, jtabs = level
    for field in dia.DiaTables._fields:
        np.testing.assert_allclose(_np(getattr(tabs, field)), _np(getattr(jtabs, field)),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("shifted", [False, True])
def test_matvec_ref_matches_xla_f64(level, shifted):
    offs, tabs, jtabs = level
    n = tabs.k.shape[1]
    rng = np.random.default_rng(0)
    x = _vec(rng, n, 7)
    cm, cb = _lanes(7, shifted)
    ref = jax_dia_matvec(offs, jtabs, jnp.asarray(cm), jnp.asarray(cb), jnp.asarray(x))
    got = dia.dia_matvec_ref(offs, tabs, torch.tensor(cm), torch.tensor(cb), torch.tensor(x))
    assert got.dtype == torch.complex128
    assert _rel(got, ref) < 1e-12


def test_matvec_ref_matches_pallas_interpret_c64(level):
    offs, tabs, jtabs = level
    n, nf = tabs.k.shape[1], 8
    rng = np.random.default_rng(3)
    x = _vec(rng, n, nf, np.complex64)
    cm, cb = _lanes(nf, False, np.complex64)
    ref = jax_dia_matvec_pallas(offs, jtabs, jnp.asarray(cm), jnp.asarray(cb), jnp.asarray(x),
                                tile_n=128, lane_tile=16)
    tabs32 = dia.DiaTables(*(t.to(torch.float32) for t in tabs))
    got = dia.dia_matvec_ref(offs, tabs32, torch.tensor(cm), torch.tensor(cb), torch.tensor(x))
    assert got.dtype == torch.complex64
    assert _rel(got, ref) < 1e-5


def _jax_jacobi(offs, jtabs, cm, cb, x, r, omega):
    """The reference's smoothing expression (multigrid_batched.py:301-335)."""
    diag = jax_dia_diag(jtabs, cm, cb)
    inv_diag = jnp.where(jnp.abs(diag) > 1e-30, 1.0 / diag, 1.0)
    om = jnp.asarray(omega, r.dtype)
    if x is None:
        return om * inv_diag * r
    return x + om * inv_diag * (r - jax_dia_matvec(offs, jtabs, cm, cb, x))


@pytest.mark.parametrize("shifted", [False, True])
def test_residual_ref_matches_reference(level, shifted):
    offs, tabs, jtabs = level
    n = tabs.k.shape[1]
    rng = np.random.default_rng(1)
    x, r = _vec(rng, n, 5), _vec(rng, n, 5)
    cm, cb = _lanes(5, shifted)
    ref = jnp.asarray(r) - jax_dia_matvec(offs, jtabs, jnp.asarray(cm), jnp.asarray(cb),
                                          jnp.asarray(x))
    got = dia.dia_residual_ref(offs, tabs, torch.tensor(cm), torch.tensor(cb),
                               torch.tensor(x), torch.tensor(r))
    assert _rel(got, ref) < 1e-12


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("omega", [1.0, 2.0 / 3.0])
def test_jacobi_ref_matches_reference(level, shifted, from_zero, omega):
    offs, tabs, jtabs = level
    n = tabs.k.shape[1]
    rng = np.random.default_rng(2)
    x, r = _vec(rng, n, 6), _vec(rng, n, 6)
    cm, cb = _lanes(6, shifted)
    ref = _jax_jacobi(offs, jtabs, jnp.asarray(cm), jnp.asarray(cb),
                      None if from_zero else jnp.asarray(x), jnp.asarray(r), omega)
    got = dia.dia_jacobi_ref(offs, tabs, torch.tensor(cm), torch.tensor(cb),
                             None if from_zero else torch.tensor(x), torch.tensor(r), omega)
    assert _rel(got, ref) < 1e-12


def test_cpu_dispatch_runs_twins_and_counts_nothing(level):
    offs, tabs, _ = level
    n = tabs.k.shape[1]
    rng = np.random.default_rng(4)
    x, r = torch.tensor(_vec(rng, n, 3)), torch.tensor(_vec(rng, n, 3))
    cm, cb = (torch.tensor(a) for a in _lanes(3, True))
    before = dict(dia.LAUNCHES)
    assert torch.equal(dia.dia_matvec(offs, tabs, cm, cb, x),
                       dia.dia_matvec_ref(offs, tabs, cm, cb, x))
    assert torch.equal(dia.dia_residual(offs, tabs, cm, cb, x, r),
                       dia.dia_residual_ref(offs, tabs, cm, cb, x, r))
    assert torch.equal(dia.dia_jacobi(offs, tabs, cm, cb, x, r, 1.0),
                       dia.dia_jacobi_ref(offs, tabs, cm, cb, x, r, 1.0))
    assert dia.LAUNCHES == before


def test_kernel_wrapper_refuses_what_it_cannot_launch(level):
    offs, tabs, _ = level
    n = tabs.k.shape[1]
    x = torch.zeros((n, 2), dtype=torch.complex128)
    cm = cb = torch.zeros(2, dtype=torch.complex128)
    with pytest.raises(ValueError, match="CUDA"):
        dia.dia_stencil("matvec", offs, tabs, cm, cb, x)
    with pytest.raises(ValueError, match="mode"):
        dia.dia_stencil("spmv", offs, tabs, cm, cb, x)
    with pytest.raises(ValueError, match="needs r"):
        dia.dia_stencil("residual", offs, tabs, cm, cb, x)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["matvec", "residual", "jacobi", "jacobi0"])
@pytest.mark.parametrize("cdtype,tol", [(torch.complex64, 1e-5), (torch.complex128, 1e-12)])
@pytest.mark.parametrize("nf", [37, 64])
def test_kernel_matches_twin_on_card(level, cuda_device, mode, cdtype, tol, nf):
    offs, tabs, _ = level
    rdt = torch.float32 if cdtype == torch.complex64 else torch.float64
    tabs = dia.DiaTables(*(t.to(cuda_device, rdt).contiguous() for t in tabs))
    n = tabs.k.shape[1]
    rng = np.random.default_rng(5)
    x = torch.tensor(_vec(rng, n, nf), device=cuda_device).to(cdtype)
    r = torch.tensor(_vec(rng, n, nf), device=cuda_device).to(cdtype)
    cm, cb = (torch.tensor(a, device=cuda_device).to(cdtype) for a in _lanes(nf, True))
    if mode == "matvec":
        got = dia.dia_stencil("matvec", offs, tabs, cm, cb, x)
        ref = dia.dia_matvec_ref(offs, tabs, cm, cb, x)
    elif mode == "residual":
        got = dia.dia_stencil("residual", offs, tabs, cm, cb, x, r)
        ref = dia.dia_residual_ref(offs, tabs, cm, cb, x, r)
    else:
        x0 = None if mode == "jacobi0" else x
        got = dia.dia_stencil("jacobi", offs, tabs, cm, cb, x0, r, 0.8)
        ref = dia.dia_jacobi_ref(offs, tabs, cm, cb, x0, r, 0.8)
    torch.cuda.synchronize()
    assert _rel(got, ref) < tol
