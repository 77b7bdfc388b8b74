"""Device-stream ms per traced sweep of the program's region
``bem.assemble``: the band's pairwise kernel, its epilogue and the launch
gaps of its row chunks. None without a trace or the region."""

from mathaudio_tpu_torch.utils import profiling


def read(rec):
    if rec["trace"] is None or not hasattr(profiling, "snapshot"):
        return None
    found = profiling.snapshot()["regions"].get("bem.assemble")
    return found["ms"] / rec["trace"]["sweeps"] if found else None
