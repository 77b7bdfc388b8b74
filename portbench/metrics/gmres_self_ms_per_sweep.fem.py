"""Self ms per traced sweep of the program's region ``gmres``: its
device-stream time less the union of its ``mg.cycle`` children (the
fine operator, Arnoldi, Givens and restart checks). None without a trace
or the region."""

from mathaudio_tpu_torch.utils import profiling


def read(rec):
    if rec["trace"] is None or not hasattr(profiling, "snapshot"):
        return None
    found = profiling.snapshot()["regions"].get("gmres")
    return found["self_ms"] / rec["trace"]["sweeps"] if found else None
