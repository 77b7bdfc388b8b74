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


def _box_offsets(s):
    """The 15 offsets of the P1 box stencil on a grid of s nodes a side."""
    return tuple(sorted({0, 1, -1, s, -s, s + 1, -s - 1, s * s, -s * s, s * s + 1, -s * s - 1,
                         s * s + s, -s * s - s, s * s + s + 1, -s * s - s - 1}))


def test_box_offsets_form_the_kernels_runs(level):
    offs, _, _ = level
    assert offs == _box_offsets(6)
    assert dia.offset_runs(offs) == dia.BOX_RUNS
    assert dia.offset_runs((-5, 3, 4, 9, 10, 11, 0)) == (1, 2, 3, 1)


@pytest.mark.parametrize("offsets", [_box_offsets(21), _box_offsets(11), (-700, -3, 0, 5, 650),
                                     (40, -40, 3, 2, 1)])
@pytest.mark.parametrize("tile", [16, 32, 64])
def test_stage_windows_hold_every_row_a_tile_reads(offsets, tile):
    windows, base, rows = dia.stage_windows(offsets, tile)
    assert rows == sum(length for _, _, length in windows)
    starts = [b for _, b, _ in windows]
    assert starts == sorted(starts) and starts[0] == 0
    for (lo, _, length), (lo2, _, _) in zip(windows, windows[1:]):
        assert lo + length < lo2  # disjoint and not touching: they would have merged
    for off, b in zip(offsets, base):
        w = max(i for i, (_, wb, _) in enumerate(windows) if wb <= b)
        lo, wb, length = windows[w]
        assert b - wb + tile <= length  # the whole run of tile rows is staged
        assert lo + (b - wb) == off  # staged row b holds the tile's row ``off``
    if offsets == _box_offsets(21) and tile == 64:
        assert [length for _, _, length in windows] == [86, 108, 86]  # z-1, z, z+1 planes


@pytest.mark.parametrize("n,nf,itemsize,rows_per_thread,blocks", [
    (9261, 2048, 8, 2, 290 * 64),  # the bench's full chunk
    (1331, 2048, 8, 2, 42 * 64),
    (9261, 32, 8, 2, 290),  # the 32 anchor lanes: still two blocks per SM
    (1331, 32, 8, 1, 84),  # too few nodes for that: the lower tile
    (1331, 37, 16, 1, 84 * 3),
])
def test_plan_picks_the_tile_height_by_blocks(n, nf, itemsize, rows_per_thread, blocks):
    offsets = _box_offsets(21 if n == 9261 else 11)
    plan = dia.stencil_plan(offsets, n, nf, itemsize, 132)
    assert plan.kind == 2 and len(plan.windows) == 3  # staged plane by plane
    assert plan.rows_per_thread == rows_per_thread and plan.blocks == blocks
    assert plan.self_base == plan.base[offsets.index(0)]
    tab = 16 if itemsize == 8 else 32
    assert plan.shared_bytes == plan.rows * 256 + 15 * plan.tile * tab
    ints = list(plan.c_plan)
    assert ints[:7] == [2, rows_per_thread, plan.rows, plan.self_base, offsets[0], offsets[-1], 3]
    assert ints[7:22] == list(plan.base)
    assert ints[22:] == [w[field] for field in range(3) for w in plan.windows]


def test_plan_stages_by_planes_only_where_they_hold_the_runs():
    # a tile too low to merge the runs of a plane: 5 windows, one group
    plan = dia.stencil_plan(_box_offsets(21), 9261, 2048, 8, 132, rows_per_thread=1)
    assert plan.kind == 1 and len(plan.windows) > 3
    # the box's runs in another order: planes no longer hold runs {0, 1},
    # {2, 3, 4} and {5, 6}, so the block waits for all three at once
    offsets = _box_offsets(11)
    shuffled = offsets[:2] + offsets[11:13] + offsets[4:11] + offsets[2:4] + offsets[13:]
    assert dia.offset_runs(shuffled) == dia.BOX_RUNS
    assert dia.stencil_plan(shuffled, 1331, 64, 8, 132).kind == 1
    assert dia.stencil_plan(offsets[:-1], 1331, 64, 8, 132).kind == 0


def test_plan_generic_stencils_fit_shared_memory():
    rng = np.random.default_rng(7)
    offsets = tuple(int(o) for o in rng.choice(np.arange(-1500, 1500), 32, replace=False))
    plan = dia.stencil_plan(offsets, 1331, 2048, 16, 132)
    assert plan.kind == 0 and plan.tile == 16
    assert plan.shared_bytes <= dia.SHARED_LIMIT
    assert dia.stencil_plan((-3, 0, 5), 100, 4, 8, 132).self_base >= 0
    assert dia.stencil_plan((-3, 5), 100, 4, 8, 132).self_base == -1
    assert dia.stencil_plan(offsets[:5], 1331, 2048, 8, 132, 1).rows_per_thread == 1
    with pytest.raises(ValueError, match="rows_per_thread"):
        dia.stencil_plan(offsets[:5], 1331, 2048, 8, 132, 3)
    with pytest.raises(ValueError, match="shared memory"):
        dia.stencil_plan(offsets, 1331, 2048, 8, 132, 2)
    with pytest.raises(ValueError, match="diagonals"):
        dia.stencil_plan(tuple(range(33)), 1331, 2048, 8, 132)


@pytest.mark.parametrize("generic", [False, True])
@pytest.mark.parametrize("rows_per_thread", dia.ROWS_PER_THREAD)
def test_plan_staging_reproduces_the_product(level, generic, rows_per_thread):
    """The kernel's tiling, written out in numpy: stage each tile's windows
    from x (zeros outside [0, N)), read diagonal d of the tile's node t at
    staged row base[d] + t. It must give the plain product."""
    offs, tabs, _ = level
    n, nf = tabs.k.shape[1], 3
    if generic:  # drop diagonals: runs of one, windows that leave the band
        keep = [0, 3, 7, 11, 14]
        offs = tuple(offs[d] for d in keep)
        tabs = dia.DiaTables(tabs.k[keep], tabs.m[keep], tabs.b[keep], tabs.dk, tabs.dm, tabs.db)
    plan = dia.stencil_plan(offs, n, nf, 16, 132, rows_per_thread)
    assert (plan.kind == 0) == generic
    rng = np.random.default_rng(8)
    x = _vec(rng, n, nf)
    cm, cb = _lanes(nf, True)
    coef = (_np(tabs.k)[:, :, None] - cm * _np(tabs.m)[:, :, None]
            + cb * _np(tabs.b)[:, :, None])  # (D, N, F)
    y = np.zeros_like(x)
    for n0 in range(0, n, plan.tile):
        staged = np.zeros((plan.rows, nf), complex)
        for lo, b, length in plan.windows:
            rows = np.arange(n0 + lo, n0 + lo + length)
            inside = (rows >= 0) & (rows < n)
            staged[b + np.flatnonzero(inside)] = x[rows[inside]]
        t = np.arange(min(plan.tile, n - n0))
        for d, b in enumerate(plan.base):
            y[n0 + t] += coef[d, n0 + t] * staged[b + t]
    ref = dia.dia_matvec_ref(offs, tabs, torch.tensor(cm), torch.tensor(cb), torch.tensor(x))
    assert _rel(y, ref) < 1e-12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_vs_twin(offs, tabs, mode, nf, cdtype, device, seed, rows_per_thread=None):
    """Relative error of one kernel launch against its twin."""
    rdt = torch.float32 if cdtype == torch.complex64 else torch.float64
    tabs = dia.DiaTables(*(t.to(device, rdt).contiguous() for t in tabs))
    n = tabs.k.shape[1]
    rng = np.random.default_rng(seed)
    x = torch.tensor(_vec(rng, n, nf), device=device).to(cdtype)
    r = torch.tensor(_vec(rng, n, nf), device=device).to(cdtype)
    cm, cb = (torch.tensor(a, device=device).to(cdtype) for a in _lanes(nf, True))
    if mode == "matvec":
        got = dia.dia_stencil("matvec", offs, tabs, cm, cb, x, rows_per_thread=rows_per_thread)
        ref = dia.dia_matvec_ref(offs, tabs, cm, cb, x)
    elif mode == "residual":
        got = dia.dia_stencil("residual", offs, tabs, cm, cb, x, r, rows_per_thread=rows_per_thread)
        ref = dia.dia_residual_ref(offs, tabs, cm, cb, x, r)
    else:
        x0 = None if mode == "jacobi0" else x
        got = dia.dia_stencil("jacobi", offs, tabs, cm, cb, x0, r, 0.8, rows_per_thread=rows_per_thread)
        ref = dia.dia_jacobi_ref(offs, tabs, cm, cb, x0, r, 0.8)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    return _rel(got, ref)


MODES4 = ["matvec", "residual", "jacobi", "jacobi0"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES4)
@pytest.mark.parametrize("cdtype,tol", [(torch.complex64, 1e-5), (torch.complex128, 1e-12)])
@pytest.mark.parametrize("nf", [37, 64])
def test_kernel_matches_twin_on_card(level, cuda_device, mode, cdtype, tol, nf):
    offs, tabs, _ = level
    assert _kernel_vs_twin(offs, tabs, mode, nf, cdtype, cuda_device, 5) < tol


@pytest.fixture(scope="module")
def bench_levels():
    """(offsets, tables) of the bench's two smoothing levels (n=20: 9261
    nodes; n=10: 1331), built on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    out = {}
    for s in (20, 10):
        asm = HelmholtzAssembler(unit_cube_tetrahedra(s), robin_tags=WALLS,
                                 dtype=torch.float64, device="cuda")
        out[(s + 1) ** 3] = dia.dia_tables_of(asm, sum(asm.b_vals.values()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES4)
@pytest.mark.parametrize("cdtype,nf,tol", [(torch.complex64, 1, 1e-5), (torch.complex64, 32, 1e-5),
                                           (torch.complex64, 37, 1e-5),
                                           (torch.complex64, 2048, 1e-5),
                                           (torch.complex128, 1, 1e-12),
                                           (torch.complex128, 37, 1e-12)])
@pytest.mark.parametrize("n", [9261, 1331])
def test_kernel_matches_twin_at_bench_levels(bench_levels, cuda_device, mode, cdtype, nf, tol, n):
    offs, tabs = bench_levels[n]
    assert _kernel_vs_twin(offs, tabs, mode, nf, cdtype, cuda_device, 9) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES4)
@pytest.mark.parametrize("rows_per_thread", dia.ROWS_PER_THREAD)
@pytest.mark.parametrize("n", [9261, 1331])
def test_kernel_tile_heights_agree(bench_levels, cuda_device, mode, rows_per_thread, n):
    """Every tile height, staged by planes or not, at a ragged lane count."""
    offs, tabs = bench_levels[n]
    err = _kernel_vs_twin(offs, tabs, mode, 333, torch.complex64, cuda_device, 10,
                          rows_per_thread)
    assert err < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES4)
@pytest.mark.parametrize("cdtype,tol", [(torch.complex64, 1e-5), (torch.complex128, 1e-12)])
@pytest.mark.parametrize("nd", [5, 32])
def test_kernel_generic_offsets(cuda_device, mode, cdtype, tol, nd):
    """The generic instantiation: offsets in no order, runs of one, windows
    that leave the band, a main diagonal only for D = 32."""
    rng = np.random.default_rng(nd)
    n = 1331
    pool = np.arange(-1500, 1500) if nd == 32 else np.array([-1400, -40, -3, 7, 900, 1200])
    offs = tuple(int(o) for o in rng.choice(pool, nd, replace=False))
    if nd == 32 and 0 not in offs:
        offs = offs[:-1] + (0,)
    assert dia.stencil_plan(offs, n, 37, 8, 132).kind == 0
    band = np.array([[0 <= i + o < n for i in range(n)] for o in offs])
    k, m, b = (torch.tensor(rng.standard_normal((nd, n)) * band) for _ in range(3))
    k = k + 40.0 * torch.tensor(band)  # keep the Jacobi diagonal away from 0
    d0 = offs.index(0) if 0 in offs else 0
    tabs = dia.DiaTables(k, m, b, k[d0], m[d0], b[d0])
    assert _kernel_vs_twin(offs, tabs, mode, 37, cdtype, cuda_device, 11) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES4)
def test_kernel_box_runs_in_another_order(bench_levels, cuda_device, mode):
    """The box kernel with its runs reordered: the planes no longer match
    the runs, so the plan waits for all windows at once."""
    offs, tabs = bench_levels[1331]
    order = [0, 1, 11, 12, 4, 5, 6, 7, 8, 9, 10, 2, 3, 13, 14]
    shuffled = tuple(offs[d] for d in order)
    tabs = dia.DiaTables(tabs.k[order], tabs.m[order], tabs.b[order], tabs.dk, tabs.dm, tabs.db)
    assert dia.stencil_plan(shuffled, 1331, 64, 8, 132).kind == 1
    assert _kernel_vs_twin(shuffled, tabs, mode, 64, torch.complex64, cuda_device, 12) < 1e-5
