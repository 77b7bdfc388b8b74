"""Mean GMRES iterations a lane over the window's sweeps, as the sweep
returns them (anchor lanes count both phases)."""


def read(rec):
    if "iterations" not in rec["sweeps"][0]:
        return None
    return sum(s["iterations"] for s in rec["sweeps"]) / sum(s["lanes"] for s in rec["sweeps"])
