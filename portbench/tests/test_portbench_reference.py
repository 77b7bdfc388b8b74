"""The plain references against the program's CPU path at tiny sizes, in
float64."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.bem_sphere_dense import SphereSystem
from portbench.reference.fem_room_nm import RoomSystem

SOURCE, LISTENERS = (0.4, 0.55, 0.5), ((0.25, 0.25, 0.25), (0.7, 0.6, 0.4))


def test_fem_reference_is_the_program_system():
    from mathaudio_tpu_torch.fem.mesh import unit_cube_tetrahedra
    from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel

    n = 4
    model = RoomSweepModel(unit_cube_tetrahedra(n), absorption=0.15, source_position=SOURCE,
                           listening_positions=LISTENERS, dtype=torch.float64, device="cpu")
    prm = model.params()
    ref = RoomSystem(n, 0.15, SOURCE, 0.1, LISTENERS, "cpu")
    size = ref.num_nodes

    def program(vals):
        a = np.zeros((size, size))
        np.add.at(a, (prm.row_of_slot.numpy(), prm.col_of_slot.numpy()), vals.numpy())
        return a

    def reference(tab):
        a = np.zeros((size, size))
        cols = ref.cols.numpy()
        np.add.at(a, (np.repeat(np.arange(size), cols.shape[1]), cols.ravel()),
                  tab.numpy().ravel())
        return a

    for vals, tab in ((prm.k_vals, ref.k), (prm.m_vals, ref.m), (prm.b_sum, ref.b)):
        want = reference(tab)
        assert np.abs(program(vals) - want).max() <= 1e-14 * np.abs(want).max()
    assert torch.allclose(prm.rhs.real, ref.rhs, rtol=0, atol=1e-15)
    assert torch.equal(prm.listen_idx, ref.listen_idx)


def test_fem_reference_matches_the_sweep():
    from mathaudio_tpu_torch.fem.multigrid import GeometricMultigrid, box_hierarchy
    from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel
    from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorRoomSweep
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig

    n = 8
    ks = torch.linspace(0.55, 2.2, 16, dtype=torch.float64)
    meshes = box_hierarchy(n, 3)
    mg = GeometricMultigrid(meshes, robin_tags=(1, 2, 3, 4, 5, 6), dtype=torch.float64,
                            device="cpu")
    nm = NodeMajorRoomSweep(RoomSweepModel(meshes[0], assembler=mg.assemblers[0],
                                           absorption=0.15, source_position=SOURCE,
                                           listening_positions=LISTENERS), mg)
    fn = nm.sweep_fn(KrylovConfig(max_iterations=500, tolerance=1e-10, restart=6), mg_nu=1,
                     mg_omega=1.0, mg_coarse_anchors=4, gmres_orth="cgs1", freq_chunk=16,
                     warm_stride=4, warm_restart=3, warm_interp="cubic")
    p, _, conv = fn(nm.params(), ks)
    want, _, rel = RoomSystem(n, 0.15, SOURCE, 0.1, LISTENERS, "cpu").solve(ks)
    assert bool(conv.all()) and float(rel.max()) < 1e-11
    gap = ((p - want).abs().amax(dim=1) / want.abs().amax(dim=1)).max()
    assert float(gap) < 1e-7


def test_bem_reference_is_the_program_matrix():
    from mathaudio_tpu_torch.bem import assembly, sweep
    from mathaudio_tpu_torch.bem.incident import plane_wave
    from mathaudio_tpu_torch.bem.mesh import icosphere

    mesh = icosphere(1.0, 2)
    st = sweep.sweep_statics(mesh, quad_order=3, dtype=torch.float64, device="cpu")
    ref = SphereSystem(2, "cpu", rows=100)
    assert torch.equal(st.centers, ref.centers) and ref.h == mesh.avg_element_size()
    ks = torch.tensor([0.7, 2.9], dtype=torch.float64)
    d = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    for bm in (False, True):
        betas, rhs = sweep.sweep_inputs(mesh, st, ks, plane_wave(d), burton_miller=bm)
        a = assembly._assemble(*st, ks, betas, bm)
        p = sweep.sweep_apply(st, ks, betas, rhs, burton_miller=bm, solver="lu")
        for f, k in enumerate(ks.tolist()):
            want = ref.matrix(k, bm)
            assert float((a[f] - want).abs().max() / want.abs().max()) < 1e-13
            assert float((rhs[f] - ref.rhs(k, d, bm)).abs().max()) < 1e-14
            assert ref.residual(k, bm, d, p[f]) < 1e-13
