"""90th percentile of every window sweep's wall, call to answers on the
host, in ms."""

import statistics


def read(rec):
    walls = [s["wall_s"] * 1e3 for s in rec["sweeps"]]
    if len(walls) < 2:
        return walls[0]
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
