"""Host syncs per traced sweep: the sum of the program's ``host_sync.*``
counters, one at each read or copy that waits for the card (a check
read on the host, a direct inverse's status, a Python number copied to
the card). None without a trace or the counters."""

from mathaudio_tpu_torch.utils import profiling


def read(rec):
    if rec["trace"] is None or not hasattr(profiling, "snapshot"):
        return None
    syncs = [v for k, v in profiling.snapshot()["counters"].items()
             if k.startswith("host_sync.")]
    return sum(syncs) / rec["trace"]["sweeps"] if syncs else None
