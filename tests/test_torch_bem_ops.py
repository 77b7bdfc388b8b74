"""Port vs reference: the pairwise BEM quadrature sums (ops/bem_assembly.py).

The plain PyTorch twins (pairwise_double_layer_ref, pairwise_bm_ref) are
held in float64 against the reference's XLA forms and its Pallas kernels
(interpret mode on the CPU, as tests/test_ops.py runs them), on an
icosphere with 320 elements and on a ragged 300-element subset, for a
band of wavenumbers (the reference is called once per wavenumber). The
singular i == j entries differ between the forms and are overwritten by
the assembly, so Burton–Miller is compared off the diagonal. The CUDA
kernel itself is held against the twins by the tests marked ``cuda``
(they skip without a card) and by chip_smoke.py.
"""

import re
from pathlib import Path

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mathaudio_tpu.bem.mesh import icosphere as jax_icosphere
from mathaudio_tpu.ops.bem_assembly import (
    pairwise_bm_pallas,
    pairwise_bm_xla,
    pairwise_double_layer_pallas,
    pairwise_double_layer_xla,
)
from mathaudio_tpu_torch.ops import bem_assembly as ops

KS = np.array([1.5, 2.75])
SUBSETS = {"full": slice(None), "ragged300": slice(0, 300)}
KERNEL_SOURCE = Path(ops.__file__).resolve().parents[1] / "kernels" / "bem_pairwise.cu"


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


def _off_diagonal(a):
    """Copy of (..., Ni, Nj) with the entries (i, i) set to 0."""
    a = np.array(a)
    ii = np.arange(min(a.shape[-2:]))
    a[..., ii, ii] = 0.0
    return a


@pytest.fixture(scope="module")
def geometry():
    """Icosphere subdiv 2 (N=320) as numpy: centers, normals, qp, qw."""
    mesh = jax_icosphere(1.0, 2)
    qp, qw = mesh.quad_points(3)
    return mesh.centers, mesh.normals, qp, qw


def _inputs(geometry, subset):
    sel = SUBSETS[subset]
    c, n, qp, qw = geometry
    return c[sel], n[sel], qp[sel], n[sel], qw[sel]


@pytest.fixture(scope="module")
def reference(geometry):
    """Per (form, variant, subset): the reference's planes stacked over KS."""
    cache = {}

    def get(form, variant, subset):
        key = (form, variant, subset)
        if key not in cache:
            x, nx, yq, ny, w = (jnp.asarray(a) for a in _inputs(geometry, subset))
            if variant == "double_layer":
                fn = pairwise_double_layer_pallas if form == "pallas" else pairwise_double_layer_xla
                outs = [fn(x, yq, ny, w, float(k)) for k in KS]
            else:
                fn = pairwise_bm_pallas if form == "pallas" else pairwise_bm_xla
                outs = [fn(x, nx, yq, ny, w, float(k)) for k in KS]
            cache[key] = [np.stack([np.asarray(o[p]) for o in outs]) for p in range(len(outs[0]))]
        return cache[key]

    return get


def _port(geometry, variant, subset):
    x, nx, yq, ny, w = (torch.tensor(a) for a in _inputs(geometry, subset))
    ks = torch.tensor(KS)
    if variant == "double_layer":
        return ops.pairwise_double_layer_ref(x, yq, ny, w, ks)
    return ops.pairwise_bm_ref(x, nx, yq, ny, w, ks)


@pytest.mark.parametrize("subset", list(SUBSETS))
@pytest.mark.parametrize("form", ["xla", "pallas"])
def test_double_layer_twin_matches_reference(geometry, reference, form, subset):
    dk, d0 = _port(geometry, "double_layer", subset)
    ref_dk, ref_d0 = reference(form, "double_layer", subset)
    assert dk.dtype == torch.complex128 and d0.dtype == torch.float64
    assert tuple(dk.shape) == ref_dk.shape and tuple(d0.shape) == ref_d0.shape[1:]
    np.testing.assert_allclose(_off_diagonal(_np(dk)), _off_diagonal(ref_dk), rtol=0, atol=1e-12)
    for f in range(len(KS)):  # D_0 does not depend on k
        np.testing.assert_allclose(_off_diagonal(_np(d0)), _off_diagonal(ref_d0[f]),
                                   rtol=0, atol=1e-12)
    # The i == j sums meet the singular centroid point (|D_k| ~ 1e25): held
    # as tests/test_ops.py holds the reference's two forms to each other.
    ii = np.arange(min(dk.shape[-2:]))
    np.testing.assert_allclose(_np(dk)[:, ii, ii], ref_dk[:, ii, ii], atol=1e-12)
    np.testing.assert_allclose(_np(d0)[ii, ii], ref_d0[0][ii, ii], atol=1e-12)


@pytest.mark.parametrize("subset", list(SUBSETS))
@pytest.mark.parametrize("form", ["xla", "pallas"])
def test_burton_miller_twin_matches_reference_off_diagonal(geometry, reference, form, subset):
    got = _port(geometry, "burton_miller", subset)
    want = reference(form, "burton_miller", subset)
    for name, g, r in zip(("D_k", "D_0", "T_k", "T_0"), got, want):
        g = _off_diagonal(_np(g))
        if g.ndim == 2:  # static planes: one for the whole band
            g = np.broadcast_to(g, r.shape)
        np.testing.assert_allclose(g, _off_diagonal(r), rtol=1e-10, atol=1e-12, err_msg=name)


def test_cpu_dispatch_runs_twins_and_counts_nothing(geometry):
    x, nx, yq, ny, w = (torch.tensor(a) for a in _inputs(geometry, "ragged300"))
    ks = torch.tensor(KS)
    before = dict(ops.LAUNCHES)
    for got, want in zip(ops.pairwise_double_layer(x, yq, ny, w, ks),
                         ops.pairwise_double_layer_ref(x, yq, ny, w, ks)):
        assert torch.equal(got, want)
    for got, want in zip(ops.pairwise_bm(x, nx, yq, ny, w, ks),
                         ops.pairwise_bm_ref(x, nx, yq, ny, w, ks)):
        assert torch.equal(got, want)
    assert ops.LAUNCHES == before


def test_kernel_wrapper_refuses_what_it_cannot_launch(geometry):
    x, nx, yq, ny, w = (torch.tensor(a) for a in _inputs(geometry, "ragged300"))
    ks = torch.tensor(KS)
    with pytest.raises(ValueError, match="CUDA"):
        ops.bem_pairwise("double_layer", x, None, yq, ny, w, ks)
    with pytest.raises(ValueError, match="variant"):
        ops.bem_pairwise("single_layer", x, None, yq, ny, w, ks)
    with pytest.raises(ValueError, match="needs nx"):
        ops.bem_pairwise("burton_miller", x, None, yq, ny, w, ks)
    with pytest.raises(TypeError, match="float32/float64"):
        ops.bem_pairwise("double_layer", x.half(), None, yq, ny, w, ks)
    with pytest.raises(ValueError, match="no path"):
        ops.pairwise_double_layer(x.to("meta"), yq, ny, w, ks)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rel_off_diagonal(got, ref):
    g, r = _off_diagonal(_np(got)), _off_diagonal(_np(ref))
    return np.linalg.norm(g - r) / np.linalg.norm(r)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["double_layer", "burton_miller"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("subset,nf", [("full", 8), ("ragged300", 3), ("ragged300", 11)])
def test_kernel_matches_twin_on_card(geometry, cuda_device, variant, dtype, tol, subset, nf):
    x, nx, yq, ny, w = (torch.tensor(a, dtype=dtype, device=cuda_device).contiguous()
                        for a in _inputs(geometry, subset))
    ks = torch.linspace(0.5, 3.0, nf, dtype=dtype, device=cuda_device)
    bm = variant == "burton_miller"
    before = ops.LAUNCHES[variant]
    got = ops.bem_pairwise(variant, x, nx if bm else None, yq, ny, w, ks)
    ref = (ops.pairwise_bm_ref(x, nx, yq, ny, w, ks) if bm
           else ops.pairwise_double_layer_ref(x, yq, ny, w, ks))
    torch.cuda.synchronize()
    assert ops.LAUNCHES[variant] == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert _rel_off_diagonal(g, r) < tol


# The sweep's variants through both bodies of the kernel, as the launcher
# picks them: the band body over F > 1 wavenumbers (any nq), the row walk
# at F = 1 (nq 1 and 4 held in registers, any other nq, here 3, read per
# row), at ragged 300 x 300 (no multiple of 8 rows, of a warp or of a block
# of 128) with small and large wavenumbers.


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["double_layer", "burton_miller"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("nq", [1, 3, 4])
@pytest.mark.parametrize("band", [[50.0], [1.5, 25.0, 50.0]], ids=["row_walk", "band"])
def test_each_body_matches_twin_on_card(geometry, cuda_device, variant, dtype, tol, nq, band):
    x, nx, yq, ny, w = (torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=cuda_device)
                        for a in _inputs(geometry, "ragged300"))
    yq, w = yq[:, :nq].contiguous(), w[:, :nq].contiguous()
    ks = torch.tensor(band, dtype=dtype, device=cuda_device)
    bm = variant == "burton_miller"
    got = ops.bem_pairwise(variant, x, nx if bm else None, yq, ny, w, ks)
    ref = (ops.pairwise_bm_ref(x, nx, yq, ny, w, ks) if bm
           else ops.pairwise_double_layer_ref(x, yq, ny, w, ks))
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert _rel_off_diagonal(g, r) < tol


@pytest.mark.cuda
def test_force_xla_raises_on_card(geometry, cuda_device):
    """The port runs no twin on the card: force="xla" on CUDA tensors
    raises instead of running it, for every wrapper."""
    x, nx, yq, ny, w = (torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                     device=cuda_device) for a in _inputs(geometry, "ragged300"))
    before = dict(ops.LAUNCHES)
    calls = (lambda: ops.pairwise_double_layer(x, yq, ny, w, 1.5, "xla"),
             lambda: ops.pairwise_bm(x, nx, yq, ny, w, 1.5, "xla"),
             lambda: ops.pairwise_mixed(x, nx, yq, ny, w, 1.5, True, "xla"),
             lambda: ops.pairwise_kh(x, yq, ny, w, 1.5, "xla"))
    for call in calls:
        with pytest.raises(ValueError, match="force='xla'"):
            call()
    assert ops.LAUNCHES == before


# --------------------------------------------------------------------------
# The float kernel's range reduction, emulated on the CPU.
# --------------------------------------------------------------------------


def _fma32(a, b, c):
    """float32 a * b + c rounded once (the product of two float32 values is
    exact in float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def test_float_range_reduction_lands_in_one_period():
    """A numpy emulation of the float kernel's reduction of k r to
    [-pi, pi] (kernels/bem_pairwise.cu ``sin_cos``, its constants read from
    the source): the reduced argument has the sine and cosine of k r to
    float32 rounding of the result, up to k r = 160 rad, where the SFU then
    adds its ~2^-21 on [-pi, pi]."""
    src = KERNEL_SOURCE.read_text()

    def const(name):
        return np.float32(float(re.search(rf"{name} = ([-0-9.e]+)f;", src).group(1)))

    inv2pi, hi, lo, rnd = (const(n) for n in ("kInv2Pi", "kTwoPiHi", "kTwoPiLo", "kRound"))
    rng = np.random.default_rng(3)
    v = np.concatenate([np.linspace(0, 160, 400001), rng.uniform(0, 160, 100000),
                        np.pi * np.arange(0, 51)]).astype(np.float32)
    n = (_fma32(v, inv2pi, rnd) - rnd).astype(np.float32)
    t = _fma32(-n, lo, _fma32(-n, hi, v))
    assert np.array_equal(n, np.round(n)) and n.max() == np.round(160 / (2 * np.pi))
    # n = rint of a rounded product: by half-integers t may pass pi by ulps
    assert np.abs(t).max() <= np.pi + 1e-5
    exact = v.astype(np.float64)
    t = t.astype(np.float64)
    assert np.abs(np.sin(t) - np.sin(exact)).max() < 3e-7
    assert np.abs(np.cos(t) - np.cos(exact)).max() < 3e-7


# --------------------------------------------------------------------------
# The kernel on the card: ragged wavenumber groups (F = 1 runs one
# wavenumber per thread, F > 1 groups of 8: F = 3, 9, 17 leave lanes idle),
# ragged Ni != Nj, large arguments (k up to 50 on the unit sphere: k r up to
# 100 rad, which the float kernel reduces to [-pi, pi] before the SFU).
# --------------------------------------------------------------------------

SWEEP_VARIANTS = ["double_layer", "burton_miller"]
DTYPES = [(torch.float32, 1e-5), (torch.float64, 1e-12)]


def _ragged_on_card(geometry, dtype, device, rows=257, cols=300):
    """The first ``rows`` collocation points against the first ``cols``
    elements: partial tiles in i and j, off-diagonal entries (i, i) for
    i < rows."""
    c, n, qp, qw = geometry
    return tuple(torch.tensor(a, dtype=dtype, device=device).contiguous()
                 for a in (c[:rows], n[:rows], qp[:cols], n[:cols], qw[:cols]))


def _held_on_card(variant, x, nx, yq, ny, w, ks, tol):
    bm = variant == "burton_miller"
    before = ops.LAUNCHES[variant]
    got = ops.bem_pairwise(variant, x, nx if bm else None, yq, ny, w, ks)
    ref = (ops.pairwise_bm_ref(x, nx, yq, ny, w, ks) if bm
           else ops.pairwise_double_layer_ref(x, yq, ny, w, ks))
    torch.cuda.synchronize()
    assert ops.LAUNCHES[variant] == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert bool(torch.isfinite(_off_diagonal_t(g)).all())
        assert _rel_off_diagonal(g, r) < tol


def _off_diagonal_t(t):
    t = t.clone()
    torch.diagonal(t, dim1=-2, dim2=-1).zero_()
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("variant", SWEEP_VARIANTS)
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("nf", [1, 3, 8, 9, 17])
@pytest.mark.parametrize("k_max", [3.0, 50.0], ids=["band", "large_kr"])
def test_kernel_matches_twin_on_card_in_ragged_groups(geometry, cuda_device, variant, dtype, tol,
                                                      nf, k_max):
    x, nx, yq, ny, w = _ragged_on_card(geometry, dtype, cuda_device)
    ks = k_max * torch.arange(1, nf + 1, dtype=dtype, device=cuda_device) / nf
    _held_on_card(variant, x, nx, yq, ny, w, ks, tol)


# Far-field phase (chip_smoke.py ``far_field_errors``): with one quadrature
# point per element each entry is one term of the sum, so where k r >= 50
# its error against the twin is that of e^{ikr} there; SFU sin and cos of an
# unreduced k r are off by ~1e-5 rad at k r = 100, which the whole-plane
# error above barely sees.


@pytest.mark.cuda
@pytest.mark.parametrize("variant", SWEEP_VARIANTS)
@pytest.mark.parametrize("nf", [1, 9])
def test_far_field_phase_on_card(geometry, cuda_device, variant, nf):
    x, nx, yq, ny, w = _ragged_on_card(geometry, torch.float32, cuda_device)
    yq, w = yq[:, :1].contiguous(), w[:, :1].contiguous()
    ks = 50.0 * torch.arange(1, nf + 1, dtype=torch.float32, device=cuda_device) / nf
    bm = variant == "burton_miller"
    got = ops.bem_pairwise(variant, x, nx if bm else None, yq, ny, w, ks)
    ref = (ops.pairwise_bm_ref(x, nx, yq, ny, w, ks) if bm
           else ops.pairwise_double_layer_ref(x, yq, ny, w, ks))
    errors, n_far, _ = chip_smoke.far_field_errors(variant, got, ref, x, yq, ks)
    assert n_far > 1000 and len(errors) == (2 if bm else 1)
    for plane, err in errors.items():
        print(f"{variant} F={nf} {plane}: far-field rel err {err:.3e}")
        assert err < chip_smoke.FAR_TOL, (plane, err)
