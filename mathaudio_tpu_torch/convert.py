"""Carry the reference's sweep state across to the port.

``node_major_params_from_numpy`` takes the JAX package's
``NodeMajorParams`` with every leaf already converted to a numpy array
(the container structure and field names kept, e.g. by mapping
``np.asarray`` over the tree) and returns the port's ``NodeMajorParams``
on ``device``. It reads fields by name and never imports JAX. The static
DIA offsets are rebuilt from each level's ``row_of_slot``/``col_of_slot``.
``sweep_statics_from_numpy`` does the same for the dense BEM sweep's
``SweepStatics``.

For the single-frequency BEM engines the state is smaller: a surface mesh
(nodes, elements), per-element boundary data, and a solved surface field.
``surface_mesh_from_numpy``, ``boundary_condition_from_numpy``,
``bem_solution_from_numpy`` and ``room_bem_solution_from_numpy`` build
the port's objects from those arrays, so both packages can be fed the
same data and the port can evaluate the field from the reference's
surface solution. ``peq_from_numpy`` carries a parametric EQ across as
plain rows.
"""

from __future__ import annotations

import numpy as np
import torch

from mathaudio_tpu_torch.bem.mesh import SurfaceMesh
from mathaudio_tpu_torch.bem.room_acoustics import RoomBemSolution
from mathaudio_tpu_torch.bem.solver import BemProblem, BemSolution
from mathaudio_tpu_torch.bem.sweep import SweepStatics
from mathaudio_tpu_torch.bem.types import BoundaryCondition
from mathaudio_tpu_torch.dsp.iir import Biquad, BiquadFilterType, Peq
from mathaudio_tpu_torch.fem.dia import DiaTables, dia_pattern
from mathaudio_tpu_torch.fem.multigrid import MgBuilder, MgBuilderLevel
from mathaudio_tpu_torch.fem.multigrid_batched import DiaLevel
from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorParams
from mathaudio_tpu_torch.xtypes import complex_dtype_for, default_float, resolve_device


def node_major_params_from_numpy(tree, device=None, dtype=None) -> NodeMajorParams:
    """Port ``NodeMajorParams`` from the reference's numpy-leaved tree.

    ``dtype`` is the real dtype of the tables (default float32); vectors
    become the matching complex dtype, indices int64."""
    dtype = dtype or default_float()
    device = resolve_device(device)

    def real(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def index(a):
        return torch.tensor(np.asarray(a), dtype=torch.int64, device=device)

    def tables(t):
        return DiaTables(*(real(getattr(t, f)) for f in DiaTables._fields))

    fine = tables(tree.fine_tables)
    levels = []
    for l, lv in enumerate(tree.levels):
        tabs = fine if l == 0 else tables(lv.tables)
        levels.append(DiaLevel(tabs, index(lv.p_idx), real(lv.p_w), index(lv.r_idx), real(lv.r_w)))

    builder_levels = []
    for bl in tree.mg_builder.levels:
        rows = np.asarray(bl.row_of_slot)
        builder_levels.append(MgBuilderLevel(
            k_vals=real(bl.k_vals),
            m_vals=real(bl.m_vals),
            b_sum=real(bl.b_sum),
            row_of_slot=index(rows),
            col_of_slot=index(bl.col_of_slot),
            p_idx=index(bl.p_idx),
            p_w=real(bl.p_w),
            r_idx=index(bl.r_idx),
            r_w=real(bl.r_w),
            num_nodes=int(rows.max()) + 1,  # every P1 row holds its diagonal
        ))

    offsets = tuple(
        dia_pattern(bl.row_of_slot, bl.col_of_slot)[0]
        for bl in tree.mg_builder.levels[: len(tree.levels)]
    )
    return NodeMajorParams(
        offsets=offsets,
        fine_tables=fine,
        levels=tuple(levels),
        mg_builder=MgBuilder(tuple(builder_levels)),
        rhs=torch.tensor(np.asarray(tree.rhs), dtype=complex_dtype_for(dtype), device=device),
        listen_idx=index(tree.listen_idx),
    )


def sweep_statics_from_numpy(tree, device=None, dtype=None) -> SweepStatics:
    """Port the dense BEM sweep's ``SweepStatics`` from the reference's
    numpy-leaved tree, reading its fields by name; ``dtype`` is the real
    dtype (default float32)."""
    dtype = dtype or default_float()
    device = resolve_device(device)
    return SweepStatics(*(
        torch.tensor(np.asarray(getattr(tree, f)), dtype=dtype, device=device)
        for f in SweepStatics._fields
    ))


def surface_mesh_from_numpy(nodes, elements) -> SurfaceMesh:
    """Port ``SurfaceMesh`` from the reference's (Nn, 3) nodes and (N, 3)
    triangle connectivity (orientation kept as given)."""
    return SurfaceMesh(np.array(nodes, float), np.array(elements, np.int64))


def boundary_condition_from_numpy(types, values, admittance=None) -> BoundaryCondition:
    """Port ``BoundaryCondition`` from the reference's per-element arrays."""
    return BoundaryCondition(
        types=np.array(types, np.int32),
        values=np.array(values, complex),
        admittance=None if admittance is None else np.array(admittance, complex),
    )


def bem_solution_from_numpy(problem: BemProblem, surface_pressure, surface_q=None, info=None,
                            device=None, dtype=None) -> BemSolution:
    """Port ``BemSolution`` holding the reference's surface pressure (and
    dp/dn for non-rigid problems) on ``device``; ``dtype`` is the real
    dtype (default float32), the fields become its complex dtype."""
    cd = complex_dtype_for(dtype or default_float())
    device = resolve_device(device)

    def field(a):
        return None if a is None else torch.tensor(np.asarray(a), dtype=cd, device=device)

    return BemSolution(problem, field(surface_pressure), dict(info or {}), field(surface_q))


def room_bem_solution_from_numpy(mesh: SurfaceMesh, k: float, frequency: float,
                                 surface_pressure, admittance, sources, info=None,
                                 device=None, dtype=None) -> RoomBemSolution:
    """Port ``RoomBemSolution`` holding the reference's wall pressure and
    per-element admittance on ``device``; ``sources`` are the port's."""
    dtype = dtype or default_float()
    device = resolve_device(device)
    n = mesh.num_elements
    return RoomBemSolution(
        mesh, float(k), float(frequency),
        torch.tensor(np.asarray(surface_pressure), dtype=complex_dtype_for(dtype), device=device),
        torch.tensor(np.broadcast_to(np.asarray(admittance, float), (n,)).copy(), dtype=dtype,
                     device=device),
        list(sources), dict(info or {}),
    )


def peq_from_numpy(rows) -> Peq:
    """Port a ``Peq`` from rows of (weight, filter type name, freq, srate,
    q, db_gain), the type named by its member name ("PEAK") or short name
    ("PK"); e.g. ``[(w, bq.filter_type.name, bq.freq, bq.srate, bq.q,
    bq.db_gain) for w, bq in peq]`` of the reference's ``Peq``."""
    peq: Peq = []
    for weight, name, freq, srate, q, db_gain in rows:
        ft = BiquadFilterType[name] if name in BiquadFilterType.__members__ else (
            BiquadFilterType(name))
        peq.append((float(weight), Biquad(ft, float(freq), float(srate), float(q), float(db_gain))))
    return peq
