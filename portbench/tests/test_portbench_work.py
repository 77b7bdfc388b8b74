"""The frozen byte and operation counts against hand arithmetic."""

from __future__ import annotations

import pytest

from portbench import work
from portbench.timeline import breakdown, gaps, union_us


def test_kuhn_offsets_are_the_program_pattern():
    from mathaudio_tpu_torch.fem.assembly import HelmholtzAssembler
    from mathaudio_tpu_torch.fem.dia import dia_pattern
    from mathaudio_tpu_torch.fem.mesh import unit_cube_tetrahedra

    for m in (2, 3, 5):
        asm = HelmholtzAssembler(unit_cube_tetrahedra(m), dtype=None, device="cpu")
        offsets, _ = dia_pattern(asm.row_of_slot, asm.col_of_slot)
        assert work.kuhn_box_offsets((m + 1) ** 3) == offsets


def test_stencil_work_by_hand():
    n, nf = 27, 2  # a 2 x 2 x 2 cube of cells: 27 nodes
    offs = work.kuhn_box_offsets(n)
    assert len(offs) == 15
    pairs = sum(n - abs(o) for o in offs)
    tables = 3 * 15 * n * 4  # three float32 (D, N) tables
    vec = n * nf * 8  # one complex64 (N, F) vector
    lanes = 2 * nf * 8  # cm, cb
    assert work.stencil_work("matvec", n, nf, offs) == (2 * vec + tables + lanes, 15 * pairs * nf)
    assert work.stencil_work("residual", n, nf, offs) == (3 * vec + tables + lanes,
                                                         15 * pairs * nf + 2 * n * nf)
    assert work.stencil_work("jacobi", n, nf, offs) == (3 * vec + tables + 3 * n * 4 + lanes,
                                                       15 * pairs * nf + 31 * n * nf)
    assert work.stencil_work("jacobi", n, nf, offs, from_zero=True) == (
        2 * vec + 3 * n * 4 + lanes, 31 * n * nf)
    nbytes = 2 * vec + tables + lanes
    assert work.stencil_bound_s("matvec", n, nf) == pytest.approx(
        max(nbytes / 3.35e12, 15 * pairs * nf / 67e12))


def test_bem_work_by_hand():
    ni, nj, nq, nf = 3, 5, 4, 2
    inputs = (3 * ni + nj * (3 * nq + 3 + nq) + nf) * 4
    outputs = (2 * nf * 1 + 1) * ni * nj * 4
    assert work.bem_work("double_layer", ni, nj, nq, nf) == (
        inputs + outputs, ni * nj * nq * (22 + 12 * nf))
    inputs = (6 * ni + nj * (3 * nq + 3 + nq) + nf) * 4
    outputs = (2 * nf * 2 + 2) * ni * nj * 4
    assert work.bem_work("burton_miller", ni, nj, nq, nf) == (
        inputs + outputs, ni * nj * (5 + nq * (41 + 24 * nf)))
    # the band at N = 20480 is bound by its output planes
    nbytes, ops = work.bem_work("burton_miller", 20480, 20480, 4, 8)
    assert work.bem_bound_s("burton_miller", 20480, 20480, 4, 8) == nbytes / 3.35e12 > ops / 67e12


def test_union_gaps_and_breakdown():
    spans = [(0, 10), (5, 20), (30, 40), (45, 50)]
    assert union_us(spans, 0, 50) == 35
    assert union_us(spans, 8, 35) == 17
    assert gaps(spans, 0, 60) == [(20, 30), (40, 45), (50, 60)]
    kernels = [("k1", 0, 10), ("k2", 30, 40)]
    cpu = [("aten::item", 12, 28), ("cudaStreamSynchronize", 13, 27), ("sweep", 0, 40)]
    out = breakdown(kernels, cpu, 0, 40, skip=("sweep",))
    assert out["device_ops"] == [["k1", 1e-5], ["k2", 1e-5]]
    assert out["idle_gaps"] == [["cudaStreamSynchronize", 2e-5]]
