"""The cluster-major FMM solve (counterpart of
mathaudio_tpu/bem/fmm_chip.py::fmm_chip_solve_cm_fn).

The reference's module ships every complex tensor as (re, im) real planes,
because its TPU transport carried no complex numbers; the port's complex
tensors live on the card, so only the cluster-major solve has a
counterpart, and it takes operator objects and complex tensors where the
reference's takes planes.
"""

from __future__ import annotations

from typing import Optional

from mathaudio_tpu_torch.bem.fmm import (
    MlfmmTreeOperator,
    SlfmmOperator,
    _bmv,
    _slot_sums,
)
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, gmres


def fmm_chip_solve_cm_fn(config: Optional[KrylovConfig] = None):
    """Cluster-major solve: the whole Krylov space lives in the padded
    (C*m,) leaf-cluster layout, so the matvec and the preconditioner never
    re-gather element order (the ``x[clusters]`` scalar gathers and the
    ``elem_pos`` placement gather leave every iteration); element order is
    restored once, on the final solution. Numerically the same operator
    conjugated by the elements->cluster-slots permutation (padded slots
    carry exact zeros end to end: the right-hand side's pads are zero and
    every stage masks them).

    Returns ``solve(op, pre, rhs) -> (x, iterations, converged)``: ``op`` an
    MlfmmTreeOperator or SlfmmOperator in gather (or sel) form, ``pre`` a
    ClusterBlockPreconditioner on the same clusters or None, ``rhs`` (N,)
    complex; x comes back in element order."""
    config = config or KrylovConfig(max_iterations=400, tolerance=1e-5, restart=60)

    def solve(op, pre, rhs):
        if not isinstance(op, (MlfmmTreeOperator, SlfmmOperator)):
            raise TypeError(f"unsupported operator {type(op).__name__}")
        d = op.data
        if d.elem_pos is None:
            raise ValueError("the cluster-major solve needs an operator in gather form "
                             "(fmm.gather_form or fmm.sel_form)")
        c, m = d.clusters.shape
        mask = d.cluster_mask.to(rhs.dtype)
        diag_cm = d.diag_add[d.clusters] * mask
        # one-time permutation into cluster-major: the (C, m) slot gather is
        # the layout (pads masked to exact zero)
        rhs_cm = (rhs[d.clusters] * mask).reshape(-1)

        def mv(y):
            xc = y.reshape(c, m)
            far, near = op._far_near(xc)
            return (_slot_sums(far, near, d.near_of_tgt, mask) + diag_cm * xc).reshape(-1)

        pre_mv = None
        if pre is not None:
            pmask = pre.mask.to(rhs.dtype)

            def pre_mv(r):
                return (_bmv(pre.inv, r.reshape(c, m) * pmask) * pmask).reshape(-1)

        sol = gmres(mv, rhs_cm, config=config, preconditioner=pre_mv)
        return sol.x[d.elem_pos], sol.iterations, sol.converged  # element order, once

    return solve
