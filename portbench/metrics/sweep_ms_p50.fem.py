"""Median window sweep wall, call to answers on the host, in ms."""

import statistics


def read(rec):
    return statistics.median(s["wall_s"] * 1e3 for s in rec["sweeps"])
