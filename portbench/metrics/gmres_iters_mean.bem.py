"""Mean GMRES iterations a lane over the traced sweeps: the sum of the
per-lane iterations the BEM sweep's solve tallies
(``bem.gmres.lane_iterations``) over the lanes it counts
(``bem.gmres.lanes``). Lockstep GMRES applies the band to every lane for
every step of a cycle, so the gap to the cycles' steps is work spent on
lanes that had converged. None without a trace or the names."""

from mathaudio_tpu_torch.utils import profiling


def read(rec):
    if rec["trace"] is None or not hasattr(profiling, "snapshot"):
        return None
    snap = profiling.snapshot()
    its = snap["tallies"].get("bem.gmres.lane_iterations")
    lanes = snap["counters"].get("bem.gmres.lanes")
    return its / lanes if its is not None and lanes else None
