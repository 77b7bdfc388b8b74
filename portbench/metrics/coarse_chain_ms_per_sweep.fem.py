"""Device-stream ms per traced sweep of the program's region
``mg.coarse_chain``: the anchored coarse inverses (dense operators, one
direct inverse, Newton-Schulz GEMMs and a host-read check per anchor).
None without a trace or the region."""

from mathaudio_tpu_torch.utils import profiling


def read(rec):
    if rec["trace"] is None or not hasattr(profiling, "snapshot"):
        return None
    found = profiling.snapshot()["regions"].get("mg.coarse_chain")
    return found["ms"] / rec["trace"]["sweeps"] if found else None
