"""The readers of the program's own layer record: each on a synthetic
traced record with the program's snapshot filled by hand, and None
without a trace, without the name it reads, and with a program that has
no such record."""

from __future__ import annotations

import pytest

from mathaudio_tpu_torch.utils import profiling
from portbench import spec
from portbench.tests.conftest import REPO
from portbench.work import least_seconds

N, F, SWEEPS = 20 * 4**5, 8, 4
MATVEC_S = least_seconds(8 * F * N * N, 8 * F * N * N, "complex64")
SNAPSHOT = {
    "regions": {"mg.cycle": {"calls": 120, "ms": 800.0, "self_ms": 800.0},
                "mg.coarse_chain": {"calls": 16, "ms": 400.0, "self_ms": 400.0},
                "gmres": {"calls": 16, "ms": 920.0, "self_ms": 120.0},
                "bem.assemble": {"calls": 4, "ms": 500.0, "self_ms": 500.0}},
    "counters": {"host_sync.coarse_chain": 272, "host_sync.gmres": 8, "host_sync.upload": 8,
                 "gmres.matvecs": 132, "gmres.cycles": 8, "bem.gmres.lanes": 32},
    "tallies": {"bem.gmres.lane_iterations": 400},
}
# the band matvecs at twice their least time, under a kernel name that
# matvec_ms_per_sweep.bem selects; other kernels do not count
KERNELS = [("std::gemvx::kernel<int>", 0.0, 132 * 2 * MATVEC_S * 1e6),
           ("bem_pairwise_kernel<float>", 0.0, 5e5)]
EXPECTED = {
    "vcycle_ms_per_sweep.fem": 200.0,
    "coarse_chain_ms_per_sweep.fem": 100.0,
    "gmres_self_ms_per_sweep.fem": 30.0,
    "assembly_ms_per_sweep.bem": 125.0,
    "gmres_iters_mean.bem": 12.5,
    "gemv_roofline_pct.bem": 50.0,
    "host_syncs_per_sweep": 72.0,
}


def _record(trace=True):
    return {"traffic": {"subdivisions": 5, "lanes": F}, "sweeps": [{"lanes": F}],
            "trace": {"sweeps": SWEEPS, "kernels": KERNELS, "counters": {}} if trace else None}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_reads_the_programs_record(monkeypatch, metric):
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAPSHOT)
    assert spec.reader(REPO, metric)(_record()) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_gives_none_without_a_trace_or_a_record(monkeypatch, metric):
    read = spec.reader(REPO, metric)
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAPSHOT)
    assert read(_record(trace=False)) is None
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"regions": {}, "counters": {}, "tallies": {}})
    assert read(_record()) is None
    monkeypatch.delattr(profiling, "snapshot")  # a program before the record existed
    assert read(_record()) is None


def test_every_reader_is_in_the_benchmark():
    import json

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric in EXPECTED:
        assert metric in entries, metric
        assert entries[metric]["source"] in ("program_span", "program_counter", "device_trace")
