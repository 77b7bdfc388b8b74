"""Nodes x converged lanes of every sweep finished in the window, over the
window's seconds."""


def read(rec):
    if "dof_solves" not in rec["sweeps"][0]:
        return None
    return sum(s["dof_solves"] for s in rec["sweeps"]) / rec["window_s"]
