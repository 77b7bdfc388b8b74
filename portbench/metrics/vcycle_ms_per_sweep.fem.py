"""Device-stream ms per traced sweep of the program's region ``mg.cycle``:
every multigrid cycle from level 0 down (smoothing, transfers, the
anchored coarse solve). None without a trace or the region."""

from mathaudio_tpu_torch.utils import profiling


def read(rec):
    if rec["trace"] is None or not hasattr(profiling, "snapshot"):
        return None
    found = profiling.snapshot()["regions"].get("mg.cycle")
    return found["ms"] / rec["trace"]["sweeps"] if found else None
