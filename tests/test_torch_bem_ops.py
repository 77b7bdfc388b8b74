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
