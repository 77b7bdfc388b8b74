"""Port vs reference: the node-major multigrid's transfer forms, the
stored inverse diagonals and one cycle of each type.

At n=8, 3 levels, on the CPU in float64: the tensor-product ("tp"),
streamed ("stream") and bfloat16-plane streamed ("stream16") prolongation
and restriction against the gather stencil and against the reference's
same transfer; one V, W and F cycle of ``mg_cycle_batched`` (gather) and
one W cycle with each other transfer against the reference's (1e-12;
stream16 to its bfloat16 rounding); ``make_dia_mg(fuse_diag=False)``
against the fused cycle and the reference's; the grid dims and 1D factors
the sweep derives, and the reference's refusal of streamed transfers
without a 2:1-nested box grid. The sweeps with each option are in
tests/test_torch_mg_sweeps.py (tp, stream, W, F) and
tests/test_torch_mg_jit_sweeps.py (stream16, Jacobi): each file keeps to
well under a minute on one worker.

The reference's transfers run eagerly (``jax.disable_jit``), its cycles
jitted, on one build per module; torch runs on one thread.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mathaudio_tpu.fem.multigrid_batched as jax_mgb
from mathaudio_tpu.fem.multigrid import GeometricMultigrid as JaxMultigrid
from mathaudio_tpu.fem.multigrid import box_hierarchy as jax_box_hierarchy
from mathaudio_tpu.fem.multigrid import build_coarse_inv_chain as jax_coarse_chain
from mathaudio_tpu.models import RoomSweepModel as JaxRoomModel
from mathaudio_tpu.models.room_sweep_nm import NodeMajorRoomSweep as JaxNodeMajor
import mathaudio_tpu_torch.fem.multigrid_batched as mgb
from mathaudio_tpu_torch.fem.mesh import unit_cube_tetrahedra
from mathaudio_tpu_torch.fem.multigrid import (
    GeometricMultigrid,
    box_grid_dims,
    box_hierarchy,
    build_coarse_inv_chain,
    prolongation_1d,
)
from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel
from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorRoomSweep

torch.set_num_threads(1)

WALLS = (1, 2, 3, 4, 5, 6)
ROOM = dict(wall_tags=WALLS, absorption=0.15,
            listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)))
KS = np.linspace(0.55, 2.2, 8)
TRANSFERS = ("tp", "stream", "stream16")


@pytest.fixture(scope="module")
def sweeps():
    jm = jax_box_hierarchy(8, 3)
    jmg = JaxMultigrid(jm, robin_tags=WALLS)
    jnm = JaxNodeMajor(JaxRoomModel(jm[0], assembler=jmg.assemblers[0], **ROOM), jmg)
    tm = box_hierarchy(8, 3)
    tmg = GeometricMultigrid(tm, robin_tags=WALLS, dtype=torch.float64, device="cpu")
    tnm = NodeMajorRoomSweep(RoomSweepModel(tm[0], assembler=tmg.assemblers[0], **ROOM), tmg)
    return jnm, tnm


def _transfer_args(nm, transfer, level=0):
    """(tp, dims_f, dims_c, bf16) of ``transfer`` at ``level``."""
    params = nm.params()
    if transfer == "tp":
        return params.tp[level], (), (), False
    if transfer in ("stream", "stream16"):
        return (), nm.grid_dims[level], nm.grid_dims[level + 1], transfer == "stream16"
    return (), (), (), False


def _random(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.mark.parametrize("transfer", TRANSFERS)
@pytest.mark.parametrize("direction", ["prolong", "restrict"])
def test_transfer_matches_gather_and_reference(sweeps, transfer, direction):
    jnm, tnm = sweeps
    level = 0
    n_f = tnm.params().levels[level].p_idx.shape[0]
    n_c = tnm.params().levels[level].r_idx.shape[0]
    tp, dims_f, dims_c, bf16 = _transfer_args(tnm, transfer, level)
    jtp, jdims_f, jdims_c, _ = _transfer_args(jnm, transfer, level)
    lvl, jlvl = tnm.params().levels[level], jnm.params().levels[level]
    v = _random((n_c if direction == "prolong" else n_f, 4), 5)
    if direction == "prolong":
        got = mgb._prolong_b(lvl, torch.tensor(v), tp, dims_c, bf16).numpy()
        gather = mgb._prolong_b(lvl, torch.tensor(v)).numpy()
        with jax.disable_jit():
            ref = np.asarray(jax_mgb._prolong_b(jlvl, jnp.asarray(v), jtp, jdims_c, bf16))
    else:
        got = mgb._restrict_b(lvl, torch.tensor(v), n_c, tp, dims_f, bf16).numpy()
        gather = mgb._restrict_b(lvl, torch.tensor(v), n_c).numpy()
        with jax.disable_jit():
            ref = np.asarray(jax_mgb._restrict_b(jlvl, jnp.asarray(v), n_c, jtp, jdims_f, bf16))
    assert got.shape == gather.shape == ref.shape
    scale = np.abs(gather).max()
    if transfer == "stream16":  # bfloat16 planes: ~2^-8 relative per rounding
        np.testing.assert_allclose(got, gather, rtol=0, atol=2e-2 * scale)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * scale)
    else:
        np.testing.assert_allclose(got, gather, rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * scale)


def test_tp_and_stream_agree(sweeps):
    _, tnm = sweeps
    for level in range(2):
        lvl = tnm.params().levels[level]
        n_c = lvl.r_idx.shape[0]
        xc = torch.tensor(_random((n_c, 3), 7 + level))
        rf = torch.tensor(_random((lvl.p_idx.shape[0], 3), 9 + level))
        tp = tnm.params().tp[level]
        dims_f, dims_c = tnm.grid_dims[level], tnm.grid_dims[level + 1]
        np.testing.assert_allclose(mgb._prolong_tp(tp, xc).numpy(),
                                   mgb._prolong_stream(dims_c, xc).numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(mgb._restrict_tp(tp, rf).numpy(),
                                   mgb._restrict_stream(dims_f, rf).numpy(), rtol=0, atol=1e-12)


def test_real_view_interleaves_re_and_im():
    x = torch.tensor(_random((3, 2), 1))
    xr, undo = mgb._real_view(x)
    assert tuple(xr.shape) == (3, 4)
    np.testing.assert_array_equal(xr[:, 0::2].numpy(), x.real.numpy())
    np.testing.assert_array_equal(xr[:, 1::2].numpy(), x.imag.numpy())
    assert torch.equal(undo(xr), x)


def test_grid_dims_and_tp_factors(sweeps):
    jnm, tnm = sweeps
    assert tnm.grid_dims == jnm.grid_dims == ((9, 9, 9), (5, 5, 5), (3, 3, 3))
    tp, jtp = tnm.params().tp, jnm.params().tp
    assert len(tp) == len(jtp) == 2  # one per smoothing level
    assert tuple(tp[0][0].shape) == (9, 5) and tuple(tp[1][0].shape) == (5, 3)
    for level, jlevel in zip(tp, jtp):
        for m, jm in zip(level, jlevel):
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    p = prolongation_1d(3)  # 7 fine x 4 coarse
    assert p.shape == (7, 4)
    np.testing.assert_array_equal(p[::2], np.eye(4))
    np.testing.assert_array_equal(p[1::2].sum(axis=1), 1.0)


def test_box_grid_dims_detects_and_rejects():
    mesh = unit_cube_tetrahedra(4)
    assert box_grid_dims(mesh) == (5, 5, 5)
    nodes = mesh.nodes.copy()
    nodes[7, 0] += 0.01  # perturbed nodes are not a lexicographic grid
    assert box_grid_dims(SimpleNamespace(nodes=nodes)) is None
    assert box_grid_dims(SimpleNamespace(nodes=nodes[:, :2])) is None  # 2D


@pytest.mark.parametrize("transfer", ["stream", "stream16"])
def test_stream_needs_a_nested_box_hierarchy(sweeps, transfer):
    _, tnm = sweeps
    dims = tnm.grid_dims
    tnm.grid_dims = ()  # as on a hierarchy that is not a 2:1-nested box grid
    try:
        with pytest.raises(ValueError, match="2:1-nested box hierarchy"):
            tnm.sweep_fn(mg_transfers=transfer)
    finally:
        tnm.grid_dims = dims


def _cycle_inputs(jnm, tnm):
    """Both packages' anchored coarse inverses for KS (4 anchors) and one
    seeded residual."""
    anchors = KS.reshape(4, 2).mean(axis=1)
    robin = -1j * 0.15 * anchors
    jinv = jax_coarse_chain(jnm.params().mg_builder, jnp.asarray(anchors), jnp.asarray(robin))
    tinv = build_coarse_inv_chain(tnm.params().mg_builder, torch.tensor(anchors),
                                  torch.tensor(robin))
    r = _random((tnm.params().rhs.shape[0], len(KS)), 3)
    return jinv, tinv, r


def _reference_cycle(jnm, jinv, r, cycle, omega=1.0, nu=1, **mg_kw):
    """One reference cycle, jitted (one small compile)."""
    def run(levels, ks, inv, r):
        mgp = jax_mgb.make_dia_mg(jnm.offsets, levels, ks, 0.15, inv, **mg_kw)
        return mgp, jax_mgb.mg_cycle_batched(mgp, jnm.offsets, r, omega=omega, nu=nu,
                                             cycle=cycle)

    mgp, x = jax.jit(run)(jnm.params().levels, jnp.asarray(KS), jinv, jnp.asarray(r))
    return mgp, np.asarray(x)


CYCLES = [("v", "gather"), ("w", "gather"), ("f", "gather"), ("w", "tp"), ("w", "stream"),
          ("w", "stream16")]


@pytest.mark.parametrize("cycle,transfer", CYCLES, ids=[f"{c}-{t}" for c, t in CYCLES])
def test_cycle_matches_reference(sweeps, cycle, transfer):
    jnm, tnm = sweeps
    jinv, tinv, r = _cycle_inputs(jnm, tnm)

    def mg_kw(nm):
        return dict(tp=nm.params().tp if transfer == "tp" else (),
                    dims=nm.grid_dims if transfer.startswith("stream") else (),
                    transfer_bf16=transfer == "stream16")

    mgp = mgb.make_dia_mg(tnm.offsets, tnm.params().levels, torch.tensor(KS), 0.15, tinv,
                          **mg_kw(tnm))
    got = mgb.mg_cycle_batched(mgp, tnm.offsets, torch.tensor(r), omega=1.0, nu=1,
                               cycle=cycle).numpy()
    _, ref = _reference_cycle(jnm, jinv, r, cycle, **mg_kw(jnm))
    # stream16: torch rounds every bfloat16 op, XLA may keep float32 inside
    # a fusion: the two agree to the planes' rounding, not to float64
    tol = 1e-2 if transfer == "stream16" else 1e-12
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_stored_inverse_diagonals_match_fused(sweeps):
    """fuse_diag=False stores (N_l, F) inverse diagonals; the cycle then
    forms each residual with the kernel's residual mode and updates
    elementwise. Same cycle as the fused Jacobi kernel, and as the
    reference's stored form."""
    jnm, tnm = sweeps
    jinv, tinv, r = _cycle_inputs(jnm, tnm)
    ks = torch.tensor(KS)
    stored = mgb.make_dia_mg(tnm.offsets, tnm.params().levels, ks, 0.15, tinv, fuse_diag=False)
    fused = mgb.make_dia_mg(tnm.offsets, tnm.params().levels, ks, 0.15, tinv)
    assert fused.inv_diags == ()
    assert [tuple(d.shape) for d in stored.inv_diags] == [
        (lvl.tables.dk.shape[0], len(KS)) for lvl in tnm.params().levels]
    for cycle, nu in (("v", 1), ("w", 2)):
        a = mgb.mg_cycle_batched(stored, tnm.offsets, torch.tensor(r), omega=0.8, nu=nu,
                                 cycle=cycle).numpy()
        b = mgb.mg_cycle_batched(fused, tnm.offsets, torch.tensor(r), omega=0.8, nu=nu,
                                 cycle=cycle).numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * np.abs(b).max())
    jmgp, ref = _reference_cycle(jnm, jinv, r, "w", omega=0.8, nu=2, fuse_diag=False)
    for d, jd in zip(stored.inv_diags, jmgp.inv_diags):
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-12)
    np.testing.assert_allclose(a, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


# --------------------------------------------------------------------------
# On the card: every option's cycle through the DIA kernel against the CPU.
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the DIA kernel has no CPU mode)")
    out = {}
    for where in ("cuda", "cpu"):
        tm = box_hierarchy(8, 3)
        tmg = GeometricMultigrid(tm, robin_tags=WALLS, dtype=torch.float64, device=where)
        out[where] = NodeMajorRoomSweep(RoomSweepModel(tm[0], assembler=tmg.assemblers[0],
                                                       **ROOM), tmg)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_diag", [True, False])
@pytest.mark.parametrize("cycle,transfer", CYCLES, ids=[f"{c}-{t}" for c, t in CYCLES])
def test_cycle_on_card_matches_cpu(card_pair, cycle, transfer, fuse_diag):
    """complex128 on the card (the kernel) against the CPU (the twins)."""
    from mathaudio_tpu_torch.fem import dia

    r = _random((card_pair["cpu"].params().rhs.shape[0], len(KS)), 3)
    out = {}
    for where, nm in card_pair.items():
        anchors = torch.tensor(KS.reshape(4, 2).mean(axis=1), device=where)
        inv = build_coarse_inv_chain(nm.params().mg_builder, anchors, -0.15j * anchors.to(
            torch.complex128))
        mgp = mgb.make_dia_mg(nm.offsets, nm.params().levels, torch.tensor(KS, device=where),
                              0.15, inv, fuse_diag=fuse_diag,
                              tp=nm.params().tp if transfer == "tp" else (),
                              dims=nm.grid_dims if transfer.startswith("stream") else (),
                              transfer_bf16=transfer == "stream16")
        dia.reset_launches()
        out[where] = mgb.mg_cycle_batched(mgp, nm.offsets, torch.tensor(r, device=where),
                                          omega=1.0, nu=1, cycle=cycle).cpu().numpy()
        if where == "cuda":
            assert dia.LAUNCHES["residual"] > 0
            assert (dia.LAUNCHES["jacobi"] == 0) == (not fuse_diag)
    tol = 1e-2 if transfer == "stream16" else 1e-12
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0,
                               atol=tol * np.abs(out["cpu"]).max())
