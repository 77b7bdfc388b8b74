"""Wavenumber solves finished in the window (finite answers), over the
window's seconds."""


def read(rec):
    if "solves" not in rec["sweeps"][0]:
        return None
    return sum(s["solves"] for s in rec["sweeps"]) / rec["window_s"]
