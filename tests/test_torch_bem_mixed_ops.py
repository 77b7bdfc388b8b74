"""Port vs reference: the mixed-BC and Kirchhoff–Helmholtz pairwise sums
(ops/bem_assembly.py: pairwise_mixed_ref, pairwise_kh_ref).

The plain PyTorch twins are held in float64 against the reference's XLA
forms and its Pallas kernels (interpret mode on the CPU, as
tests/test_ops.py runs them), on an icosphere with 320 elements and on
ragged subsets, for one wavenumber and for a band of three (the reference
is called once per wavenumber and its results are shared between the
tests; the Pallas forms, slow to interpret, run at one wavenumber), to
1e-12 absolute. The mixed sums are
taken at the surface's own collocation points, where the i == j entries
are singular, differ between the forms and are overwritten by the
assembly: they are compared off the diagonal. The field sums are taken at
exterior points and compared whole. The CUDA kernel itself is held
against the twins by the tests marked ``cuda`` (they skip without a card)
and by chip_smoke.py.
"""

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mathaudio_tpu.bem.mesh import icosphere as jax_icosphere
from mathaudio_tpu.ops.bem_assembly import (
    pairwise_kh_pallas,
    pairwise_kh_xla,
    pairwise_mixed_pallas,
    pairwise_mixed_xla,
)
from mathaudio_tpu_torch.ops import bem_assembly as ops

BANDS = {"F1": np.array([1.5]), "F3": np.array([0.75, 1.5, 2.75])}
SUBSETS = {"full": (slice(None), slice(None)), "ragged": (slice(0, 150), slice(0, 300))}
FORM_BANDS = [("xla", "F1"), ("xla", "F3"), ("pallas", "F1")]
MIXED_PLANES = ("D_k", "D_0", "S_k", "T_k", "T_0", "K'_k")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these shapes more threads do not shorten
    the tests and only contend with the other workers of a parallel run."""
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
    """Icosphere subdiv 2 (N=320) as numpy: centers, normals, qp, qw (order
    3, the solver's default: 4 points), and 48 exterior points."""
    mesh = jax_icosphere(1.0, 2)
    qp, qw = mesh.quad_points(3)
    rng = np.random.default_rng(7)
    d = rng.normal(size=(48, 3))
    pts = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(1.2, 3.0, (48, 1))
    return mesh.centers, mesh.normals, qp, qw, pts


def _mixed_inputs(geometry, subset):
    si, sj = SUBSETS[subset]
    c, n, qp, qw, _ = geometry
    return c[si], n[si], qp[sj], n[sj], qw[sj]


def _kh_inputs(geometry, subset):
    _, sj = SUBSETS[subset]
    _, n, qp, qw, pts = geometry
    return (pts if subset == "full" else pts[:37]), qp[sj], n[sj], qw[sj]


@pytest.fixture(scope="module")
def reference(geometry):
    """The reference's planes per (kind, form, flag, subset, k), computed once."""
    cache = {}
    # jitted with k traced: one compilation per shape serves the band
    mixed_xla = jax.jit(pairwise_mixed_xla, static_argnames="with_bm")
    kh_xla = jax.jit(pairwise_kh_xla)

    def get(kind, form, flag, subset, k):
        key = (kind, form, flag, subset, float(k))
        if key not in cache:
            if kind == "mixed":
                fn = pairwise_mixed_pallas if form == "pallas" else mixed_xla
                jin = [jnp.asarray(a) for a in _mixed_inputs(geometry, subset)]
                cache[key] = fn(*jin, float(k), with_bm=flag)
            else:
                jin = [jnp.asarray(a) for a in _kh_inputs(geometry, subset)]
                cache[key] = (pairwise_kh_pallas(*jin, float(k), want_single=flag)
                              if form == "pallas" else kh_xla(*jin, float(k)))
        return cache[key]

    return get


def _stack(outs):
    """Per plane: the reference's per-k results stacked over the band
    (None where the plane is absent)."""
    return [None if outs[0][p] is None else np.stack([np.asarray(o[p]) for o in outs])
            for p in range(len(outs[0]))]


@pytest.mark.parametrize("subset", list(SUBSETS))
@pytest.mark.parametrize("with_bm", [False, True], ids=["cbie", "burton_miller"])
@pytest.mark.parametrize("form,band", FORM_BANDS)
def test_mixed_twin_matches_reference_off_diagonal(geometry, reference, form, band, with_bm, subset):
    inputs = _mixed_inputs(geometry, subset)
    want = _stack([reference("mixed", form, with_bm, subset, k) for k in BANDS[band]])
    got = ops.pairwise_mixed_ref(*(torch.tensor(a) for a in inputs), torch.tensor(BANDS[band]),
                                 with_bm)
    assert len(got) == 6
    for name, g, r in zip(MIXED_PLANES, got, want):
        if r is None:
            assert g is None, name
            continue
        g = _np(g)
        assert g.dtype == (np.float64 if name.endswith("_0") else np.complex128), name
        if g.ndim == 2:  # static planes: one for the whole band
            g = np.broadcast_to(g, r.shape)
        assert g.shape == r.shape, name
        np.testing.assert_allclose(_off_diagonal(g), _off_diagonal(r), rtol=1e-10, atol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("subset", list(SUBSETS))
@pytest.mark.parametrize("want_single", [True, False], ids=["single_and_double", "double_only"])
@pytest.mark.parametrize("form,band", FORM_BANDS)
def test_kh_twin_matches_reference(geometry, reference, form, band, want_single, subset):
    inputs = _kh_inputs(geometry, subset)
    # the XLA form has no want_single: one cached call serves both cases
    flag = want_single if form == "pallas" else True
    want_s, want_d = _stack([reference("kh", form, flag, subset, k) for k in BANDS[band]])
    got_s, got_d = ops.pairwise_kh_ref(*(torch.tensor(a) for a in inputs),
                                       torch.tensor(BANDS[band]), want_single=want_single)
    assert got_d.dtype == torch.complex128 and tuple(got_d.shape) == want_d.shape
    np.testing.assert_allclose(_np(got_d), want_d, rtol=0, atol=1e-12)
    if want_single:
        np.testing.assert_allclose(_np(got_s), want_s, rtol=0, atol=1e-12)
    else:
        assert got_s is None


def test_cpu_dispatch_runs_twins_and_counts_nothing(geometry):
    x, nx, yq, ny, w = (torch.tensor(a) for a in _mixed_inputs(geometry, "ragged"))
    ks = torch.tensor(BANDS["F1"])
    before = dict(ops.LAUNCHES)
    for with_bm in (False, True):
        for got, want in zip(ops.pairwise_mixed(x, nx, yq, ny, w, ks, with_bm),
                             ops.pairwise_mixed_ref(x, nx, yq, ny, w, ks, with_bm)):
            assert (got is None and want is None) or torch.equal(got, want)
    pts, yq, ny, w = (torch.tensor(a) for a in _kh_inputs(geometry, "ragged"))
    for want_single in (True, False):
        for got, want in zip(ops.pairwise_kh(pts, yq, ny, w, ks, want_single=want_single),
                             ops.pairwise_kh_ref(pts, yq, ny, w, ks, want_single)):
            assert (got is None and want is None) or torch.equal(got, want)
    assert ops.LAUNCHES == before
    assert set(before) == {"double_layer", "burton_miller", "mixed", "mixed_bm", "kh", "kh_double"}


def test_kernel_wrapper_refuses_what_it_cannot_launch(geometry):
    x, nx, yq, ny, w = (torch.tensor(a) for a in _mixed_inputs(geometry, "ragged"))
    ks = torch.tensor(BANDS["F1"])
    for variant in ("mixed", "mixed_bm", "kh", "kh_double"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.bem_pairwise(variant, x, nx, yq, ny, w, ks)
    with pytest.raises(ValueError, match="needs nx"):
        ops.bem_pairwise("mixed_bm", x, None, yq, ny, w, ks)
    with pytest.raises(ValueError, match="no path"):
        ops.pairwise_mixed(x.to("meta"), nx, yq, ny, w, ks, True)
    with pytest.raises(ValueError, match="no path"):
        ops.pairwise_kh(x.to("meta"), yq, ny, w, ks)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rel(got, ref, off_diagonal):
    g, r = _np(got), _np(ref)
    if off_diagonal:
        g, r = _off_diagonal(g), _off_diagonal(r)
    return np.linalg.norm(g - r) / np.linalg.norm(r)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mixed", "mixed_bm", "kh", "kh_double"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("subset,band", [("full", "F1"), ("ragged", "F3")])
def test_kernel_matches_twin_on_card(geometry, cuda_device, variant, dtype, tol, subset, band):
    ks = torch.tensor(BANDS[band], dtype=dtype, device=cuda_device)
    before = ops.LAUNCHES[variant]
    if variant.startswith("mixed"):
        x, nx, yq, ny, w = (torch.tensor(a, dtype=dtype, device=cuda_device).contiguous()
                            for a in _mixed_inputs(geometry, subset))
        got = ops.bem_pairwise(variant, x, nx, yq, ny, w, ks)
        ref = ops.pairwise_mixed_ref(x, nx, yq, ny, w, ks, variant == "mixed_bm")
    else:
        x, yq, ny, w = (torch.tensor(a, dtype=dtype, device=cuda_device).contiguous()
                        for a in _kh_inputs(geometry, subset))
        got = ops.bem_pairwise(variant, x, None, yq, ny, w, ks)
        ref = ops.pairwise_kh_ref(x, yq, ny, w, ks, variant == "kh")
    torch.cuda.synchronize()
    assert ops.LAUNCHES[variant] == before + 1
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.dtype == r.dtype and g.shape == r.shape
            assert _rel(g, r, off_diagonal=variant.startswith("mixed")) < tol


# The kernel on the card: several wavenumbers (these variants run one per
# thread, so F wavenumbers are F groups), ragged Ni != Nj, large arguments
# (k up to 50: k r up to 100 rad on the surface, 200 from the field points,
# reduced to [-pi, pi] by the float kernel before the SFU).

SINGLE_K_VARIANTS = ["mixed", "mixed_bm", "kh", "kh_double"]
DTYPES = [(torch.float32, 1e-5), (torch.float64, 1e-12)]


def _held_on_card(geometry, device, variant, dtype, tol, ks):
    before = ops.LAUNCHES[variant]
    if variant.startswith("mixed"):
        x, nx, yq, ny, w = (torch.tensor(a, dtype=dtype, device=device).contiguous()
                            for a in _mixed_inputs(geometry, "ragged"))
        got = ops.bem_pairwise(variant, x, nx, yq, ny, w, ks)
        ref = ops.pairwise_mixed_ref(x, nx, yq, ny, w, ks, variant == "mixed_bm")
    else:
        x, yq, ny, w = (torch.tensor(a, dtype=dtype, device=device).contiguous()
                        for a in _kh_inputs(geometry, "ragged"))
        got = ops.bem_pairwise(variant, x, None, yq, ny, w, ks)
        ref = ops.pairwise_kh_ref(x, yq, ny, w, ks, variant == "kh")
    torch.cuda.synchronize()
    assert ops.LAUNCHES[variant] == before + 1
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.dtype == r.dtype and g.shape == r.shape
            assert _rel(g, r, off_diagonal=variant.startswith("mixed")) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("variant", SINGLE_K_VARIANTS)
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("nf", [1, 3, 8, 9, 17])
@pytest.mark.parametrize("k_max", [3.0, 50.0], ids=["band", "large_kr"])
def test_kernel_matches_twin_on_card_in_ragged_groups(geometry, cuda_device, variant, dtype, tol,
                                                      nf, k_max):
    ks = k_max * torch.arange(1, nf + 1, dtype=dtype, device=cuda_device) / nf
    _held_on_card(geometry, cuda_device, variant, dtype, tol, ks)


# Far-field phase, as in tests/test_torch_bem_ops.py (chip_smoke.py
# ``far_field_errors``): one quadrature point per element, the error of
# e^{ikr} where k r >= 50.


@pytest.mark.cuda
@pytest.mark.parametrize("variant", SINGLE_K_VARIANTS)
def test_far_field_phase_on_card(geometry, cuda_device, variant):
    ks = torch.tensor([50.0 / 3, 100.0 / 3, 50.0], device=cuda_device)
    mixed = variant.startswith("mixed")
    if mixed:
        x, nx, yq, ny, w = (torch.tensor(a, dtype=torch.float32, device=cuda_device).contiguous()
                            for a in _mixed_inputs(geometry, "full"))
    else:
        nx = None
        x, yq, ny, w = (torch.tensor(a, dtype=torch.float32, device=cuda_device).contiguous()
                        for a in _kh_inputs(geometry, "full"))
    yq, w = yq[:, :1].contiguous(), w[:, :1].contiguous()
    got = ops.bem_pairwise(variant, x, nx, yq, ny, w, ks)
    ref = (ops.pairwise_mixed_ref(x, nx, yq, ny, w, ks, variant == "mixed_bm") if mixed
           else ops.pairwise_kh_ref(x, yq, ny, w, ks, variant == "kh"))
    errors, n_far, _ = chip_smoke.far_field_errors(variant, got, ref, x, yq, ks)
    assert n_far > 1000 and errors
    for plane, err in errors.items():
        print(f"{variant} {plane}: far-field rel err {err:.3e}")
        assert err < chip_smoke.FAR_TOL, (plane, err)


# The row walk of the kernel (kernels/bem_pairwise.cu), which runs every
# launch of these variants: a thread keeps its element in registers (nq 1
# and 4) or reads it again per row (any other nq, here 3) and walks the
# block's rows, as many as the launcher picks. Held against the twin with
# small and large wavenumbers (k r up to 100 rad on the surface, 150 from
# the field points) in one band at ragged shapes: 150 rows of 300 elements
# (8 rows per block; 150 is no multiple of 8, 300 none of a warp or of a
# block of 128), and 2001 and 4001 points off the sphere, with their
# directions as normals, against the 300 (16 and 32 rows per block on an
# H100's 114-132 SMs, mixed_bm keeping its 8; the point counts are
# multiples of neither).

ROW_KS = [1.5, 25.0, 50.0]
ROW_SHAPES = {"rows8": 150, "rows16": 2001, "rows32": 4001}


def _row_walk_inputs(geometry, variant, dtype, device, nq, shape):
    if variant.startswith("mixed"):
        x, nx, yq, ny, w = _mixed_inputs(geometry, "ragged")
    else:
        (x, yq, ny, w), nx = _kh_inputs(geometry, "ragged"), None
    if shape != "rows8":
        d = np.random.default_rng(13).normal(size=(ROW_SHAPES[shape], 3))
        u = d / np.linalg.norm(d, axis=1, keepdims=True)
        x, nx = u * 1.5, (u if variant.startswith("mixed") else None)
    yq, w = yq[:, :nq], w[:, :nq]
    return tuple(None if a is None else torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                                     device=device)
                 for a in (x, nx, yq, ny, w))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", SINGLE_K_VARIANTS)
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("nq", [1, 3, 4])
@pytest.mark.parametrize("shape", list(ROW_SHAPES))
def test_row_walk_matches_twin_on_card(geometry, cuda_device, variant, dtype, tol, nq, shape):
    x, nx, yq, ny, w = _row_walk_inputs(geometry, variant, dtype, cuda_device, nq, shape)
    ks = torch.tensor(ROW_KS, dtype=dtype, device=cuda_device)
    got = ops.bem_pairwise(variant, x, nx, yq, ny, w, ks)
    mixed = variant.startswith("mixed")
    ref = (ops.pairwise_mixed_ref(x, nx, yq, ny, w, ks, variant == "mixed_bm") if mixed
           else ops.pairwise_kh_ref(x, yq, ny, w, ks, variant == "kh"))
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.dtype == r.dtype and g.shape == r.shape
            assert _rel(g, r, off_diagonal=mixed and shape == "rows8") < tol


@pytest.mark.cuda
def test_row_walk_radius_is_sqrtf_at_every_float(cuda_device):
    assert ops.radius_mismatches(cuda_device) == 0
