"""What chip_smoke.py reports of the BEM pairwise kernel, checked on the CPU.

``bem_bound``, its least time for one call (``bound_ms`` in its kernels
line): the bytes term is each input a variant reads, once, and each plane
it returns, once, counted here from the tensors the plain twins take and
return, which have the kernel's shapes and dtypes; the operations term is
the quadrature's own count, the same in float32 and float64, over each
type's peak rate (what the float kernel adds to reduce k r before the SFU
is its own cost and raises no bound).

``far_field_errors``, its far-field check: on points whose every distance
is exact in float32, so that the twin's k r is the kernel's, it reads 0
for the twin against itself and, for planes whose phase is off by a share
of k r, the relative error that phase error makes over the entries with
k r >= 50.
"""

import chip_smoke as smoke
import numpy as np
import pytest
import torch

from mathaudio_tpu_torch.ops import bem_assembly as ops

VARIANTS = ["double_layer", "burton_miller", "mixed", "mixed_bm", "kh", "kh_double"]


def _inputs(ni, nj, nq, nf, dtype):
    """Points near the unit sphere and elements on a sphere of radius 3."""
    rng = np.random.default_rng(11)

    def unit(n):
        d = rng.normal(size=(n, 3))
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    x, ny = unit(ni), unit(nj)
    yq = 3.0 * ny[:, None, :] + 0.05 * rng.normal(size=(nj, nq, 3))
    w = rng.uniform(0.01, 0.02, (nj, nq))
    ks = np.linspace(0.5, 3.0, nf)
    return tuple(torch.tensor(a, dtype=dtype) for a in (x, unit(ni), yq, ny, w, ks))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_bem_bound_moves_each_input_and_each_plane_once(variant, dtype):
    ni, nj, nq, nf = 19, 23, 4, 3
    x, nx, yq, ny, w, ks = _inputs(ni, nj, nq, nf, dtype)
    reads_nx = variant in ("burton_miller", "mixed_bm")
    planes = smoke.twin_pairwise(ops)(variant, x, nx if reads_nx else None, yq, ny, w, ks)
    read = [x, yq, ny, w, ks] + ([nx] if reads_nx else [])
    written = [p for p in planes if p is not None]
    assert len(written) == sum(name is not None for name in smoke.BEM_PLANES[variant])
    moved = sum(t.numel() * t.element_size() for t in read + written)
    bound_ms, bound_by = smoke.bem_bound(variant, ni, nj, nq, nf, dtype)
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(moved / smoke.HBM_BYTES_PER_S * 1e3, rel=1e-12)


@pytest.mark.parametrize("variant", VARIANTS)
def test_bem_bound_counts_the_same_operations_in_both_dtypes(variant):
    # 16 quadrature points and one wavenumber: the operations set the bound
    ni = nj = 64
    f32_ms, f32_by = smoke.bem_bound(variant, ni, nj, 16, 1, torch.float32)
    f64_ms, f64_by = smoke.bem_bound(variant, ni, nj, 16, 1, torch.float64)
    assert f32_by == f64_by == "operations"
    ops32 = f32_ms * 1e-3 * smoke.PEAK_FLOPS["float32"]
    ops64 = f64_ms * 1e-3 * smoke.PEAK_FLOPS["float64"]
    assert ops32 == pytest.approx(ops64, rel=1e-12)
    per_pair, per_point, per_point_k = smoke.BEM_OPS[variant]
    assert ops32 == pytest.approx(ni * nj * (per_pair + 16 * (per_point + per_point_k)), rel=1e-12)


@pytest.mark.parametrize("variant", VARIANTS)
def test_far_field_errors_read_the_phase_of_the_far_entries(variant):
    rng = np.random.default_rng(5)
    # eighths: every square and sum of r^2 is exact, in any order
    x = torch.tensor(rng.integers(-16, 17, (30, 3)) / 8, dtype=torch.float32)
    yq = torch.tensor(rng.integers(-24, 25, (40, 1, 3)) / 8, dtype=torch.float32)
    _, nx, _, ny, w, _ = _inputs(30, 40, 1, 1, torch.float32)
    ks = torch.tensor([25.0, 50.0])
    reads_nx = variant in ("burton_miller", "mixed_bm")
    ref = smoke.twin_pairwise(ops)(variant, x, nx if reads_nx else None, yq, ny, w, ks)
    errors, n_far, moved = smoke.far_field_errors(variant, ref, ref, x, yq, ks)
    assert n_far > 500 and moved == 0.0
    assert errors and all(err == 0.0 for err in errors.values())
    # a phase error of 6e-8 k r, about what SFU sin and cos of an unreduced
    # k r make (a rounded 1/2pi, truncated)
    kr = ks[:, None, None].double() * torch.cdist(x.double(), yq[:, 0].double())
    turn = torch.polar(torch.ones_like(kr), 6e-8 * kr)
    off = [p if p is None or not p.is_complex() else (p.to(torch.complex128) * turn).to(p.dtype)
           for p in ref]
    errors, _, _ = smoke.far_field_errors(variant, off, ref, x, yq, ks)
    far = kr >= smoke.FAR_KR
    for plane, got in zip(smoke.BEM_PLANES[variant], ref):
        if plane is None or not got.is_complex():
            continue
        r = got[far].to(torch.complex128)
        want = float(torch.linalg.vector_norm(r * (turn[far] - 1)) / torch.linalg.vector_norm(r))
        assert errors[plane] == pytest.approx(want, rel=0.05), plane
        assert errors[plane] > smoke.FAR_TOL, plane
