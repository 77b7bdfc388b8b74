"""Port vs reference: the room config, geometry and output layer (common/),
the validation artifacts (bem/testing.py) and the profiling spans
(utils/profiling.py). All host code (Python and numpy) in both packages.

The rooms' surface meshes are equal node for node and face for face, and
so are their derived areas, normals and centroids; every file of configs/
loads to the same ``to_dict()`` and ``to_simulation()`` in both packages
and round-trips through ``to_file``; the SimulationResults JSON has the
reference's keys, key for key, and its values but the generator's name
and the time stamp.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import mathaudio_tpu.bem.testing as jax_testing
import mathaudio_tpu.common as jax_common
import mathaudio_tpu.common.config as jax_config
import mathaudio_tpu.common.output as jax_output
import mathaudio_tpu_torch.bem.testing as testing
import mathaudio_tpu_torch.common as common
import mathaudio_tpu_torch.common.config as config
import mathaudio_tpu_torch.common.output as output
from mathaudio_tpu_torch.bem.mesh import SurfaceMesh
from mathaudio_tpu_torch.utils import Timer, span

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.json"))
ROOMS = {
    # name: (shape, args, densities)
    "rectangular": ("RectangularRoom", (4.0, 5.0, 2.7), (1, 2, 3)),
    "rectangular_odd": ("RectangularRoom", (2.3, 3.7, 2.45), (2, 5)),
    "lshaped_wide_main": ("LShapedRoom", (5.0, 4.0, 3.0, 2.5, 2.6), (1, 2, 4)),
    "lshaped_wide_extension": ("LShapedRoom", (3.0, 4.0, 5.0, 2.5, 2.6), (2, 3)),
    "lshaped_flush": ("LShapedRoom", (4.0, 3.0, 4.0, 2.0, 2.5), (2,)),
}


def _same_mesh(got, ref):
    assert np.array_equal(got.nodes, ref.nodes) and np.array_equal(got.elements, ref.elements)
    for attr in ("areas", "normals", "centroids"):
        assert np.array_equal(getattr(got, attr), getattr(ref, attr)), attr
    assert (got.num_elements, got.num_nodes) == (ref.num_elements, ref.num_nodes)
    assert got.total_area() == ref.total_area()


@pytest.mark.parametrize("name", list(ROOMS))
def test_room_meshes_equal_the_reference(name):
    shape, args, densities = ROOMS[name]
    room, ref = getattr(common, shape)(*args), getattr(jax_common, shape)(*args)
    geo, ref_geo = common.RoomGeometry(room), jax_common.RoomGeometry(ref)
    for d in densities:
        _same_mesh(room.generate_mesh(d), ref.generate_mesh(d))
        _same_mesh(geo.generate_mesh(d), ref_geo.generate_mesh(d))
    src = [common.Source.omnidirectional(common.Point3D(0.5, 0.5, 1.0))]
    ref_src = [jax_common.Source.omnidirectional(jax_common.Point3D(0.5, 0.5, 1.0))]
    for f in (30.0, 200.0):
        _same_mesh(geo.generate_adaptive_mesh(2, f, src), ref_geo.generate_adaptive_mesh(2, f, ref_src))
    assert geo.dimensions() == ref_geo.dimensions() and geo.volume() == ref_geo.volume()
    assert [(a.to_array().tolist(), b.to_array().tolist()) for a, b in geo.get_edges()] == [
        (a.to_array().tolist(), b.to_array().tolist()) for a, b in ref_geo.get_edges()]
    for p in ((0.5, 0.5, 1.0), (4.5, 4.5, 1.0), (1.0, 6.0, 1.0), (1.0, 1.0, 3.0)):
        assert geo.contains(common.Point3D(*p)) == ref_geo.contains(jax_common.Point3D(*p))


def test_room_mesh_elements_and_surface_mesh():
    mesh = common.RectangularRoom(2.0, 2.5, 2.0).generate_mesh(2)
    ref = jax_common.RectangularRoom(2.0, 2.5, 2.0).generate_mesh(2)
    for i in (0, 7, mesh.num_elements - 1):
        got, want = mesh.element(i), ref.element(i)
        assert got.connectivity == want.connectivity and got.is_triangle and got.area == want.area
        assert np.array_equal(got.centroid, want.centroid) and np.array_equal(got.normal, want.normal)
    surf = mesh.to_surface_mesh()
    assert isinstance(surf, SurfaceMesh)
    assert np.array_equal(surf.centers, ref.to_surface_mesh().centers)
    assert common.RoomGeometry.rectangular(2.0, 2.5, 2.0).volume() == 10.0
    assert common.RoomGeometry.lshaped(3.0, 2.0, 2.0, 1.0, 2.0).volume() == 16.0


def _simulation_summary(sim):
    """The resolved simulation as plain values."""
    freqs = np.asarray(sim.frequencies)
    return {
        "shape": dataclasses.asdict(sim.geometry.shape),
        "frequencies": freqs.tolist(),
        "listening": [p.to_array().tolist() for p in sim.listening_positions],
        "sources": [(s.name, s.position.to_array().tolist(), s.amplitude,
                     [s.crossover.amplitude_at_frequency(f) for f in freqs[:: max(1, len(freqs) // 5)]],
                     s.directivity.magnitude.tolist())
                    for s in sim.sources],
    }


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_file_loads_as_the_reference(path, tmp_path):
    cfg, ref = config.load_room_config(str(path)), jax_config.load_room_config(str(path))
    assert cfg.to_dict() == ref.to_dict()
    assert _simulation_summary(cfg.to_simulation()) == _simulation_summary(ref.to_simulation())
    assert {k: dataclasses.asdict(v) for k, v in cfg.boundaries.wall_specs().items()} == {
        k: dataclasses.asdict(v) for k, v in ref.boundaries.wall_specs().items()}
    for spec, ref_spec in zip(cfg.boundaries.wall_specs().values(), ref.boundaries.wall_specs().values()):
        assert spec.robin_alpha(1.3) == ref_spec.robin_alpha(1.3)
    out = tmp_path / "again.json"
    cfg.to_file(str(out))
    assert common.RoomConfig.from_file(str(out)).to_dict() == cfg.to_dict()
    mesh = cfg.to_simulation().geometry.generate_mesh(2)
    _same_mesh(mesh, ref.to_simulation().geometry.generate_mesh(2))


def test_config_specs_and_defaults_match_reference():
    for kind in ({"type": "rigid"}, {"type": "absorption", "coefficient": 0.35},
                 {"type": "impedance", "real": 2.0, "imag": -1.0}, None):
        got, ref = config.SurfaceSpec.from_dict(kind), jax_config.SurfaceSpec.from_dict(kind)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.robin_alpha(0.7) == ref.robin_alpha(0.7)
    with pytest.raises(ValueError, match="unknown surface type"):
        config.SurfaceSpec.from_dict({"type": "foam"})
    for spacing in ("linear", "logarithmic"):
        for n in (1, 6):
            got = config.FrequencySpec(20.0, 200.0, n, spacing).generate_frequencies()
            assert np.array_equal(got, jax_config.FrequencySpec(20.0, 200.0, n, spacing)
                                  .generate_frequencies())
    assert dataclasses.asdict(config.SolverSpec.from_dict(None)) == dataclasses.asdict(
        jax_config.SolverSpec.from_dict(None))
    assert config.WALL_TAGS == jax_config.WALL_TAGS
    assert output.create_default_config().to_dict() == jax_output.create_default_config().to_dict()
    with pytest.raises(ValueError, match="unknown room type"):
        config.RoomConfig.from_dict({"room": {"type": "dome"}, "frequencies": {
            "min_freq": 1.0, "max_freq": 2.0, "num_points": 2}}).to_simulation()


def _results(module, cfg_module):
    cfg = cfg_module.RoomConfig.from_file(str(CONFIGS[0]))
    freqs = cfg.frequencies.generate_frequencies()[:4]
    spl = np.random.default_rng(3).uniform(60.0, 90.0, (4, len(cfg.listening_positions)))
    res = module.create_output_json_with_sources(cfg, freqs, spl, {"a": [1.0, 2.0]},
                                                 extra_metadata={"engine": "bem", "n": 3})
    res.results[1].converged = False
    res.results[2].pressure_real = [0.5]
    res.slices.append(module.generate_spatial_slices(lambda pts: np.exp(1j * pts[:, 0]),
                                                     (2.0, 3.0, 2.5), 1.1, resolution=5))
    return res


def test_simulation_results_json_is_the_references(tmp_path):
    got, ref = _results(output, config), _results(jax_output, jax_config)
    d_got, d_ref = got.to_dict(), ref.to_dict()

    def keys(d):
        if isinstance(d, dict):
            return {k: keys(v) for k, v in d.items()}
        if isinstance(d, list):
            return [keys(v) for v in d]
        return None

    assert keys(d_got) == keys(d_ref)
    assert d_got["metadata"].pop("generator") == "mathaudio_tpu_torch"
    assert d_ref["metadata"].pop("generator") == "mathaudio_tpu"
    d_got["metadata"].pop("generated"), d_ref["metadata"].pop("generated")
    np.testing.assert_allclose(d_got["slices"][0].pop("spl_db"), d_ref["slices"][0].pop("spl_db"),
                               rtol=1e-14)
    assert d_got == d_ref
    got.save(str(tmp_path / "out.json"))
    with open(tmp_path / "out.json") as fh:
        assert keys(json.load(fh)) == keys(got.to_dict())


def _validation(module):
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(6, 3))
    exact = rng.normal(size=6) + 1j * rng.normal(size=6)
    meta = module.ExecutionMetadata(timestamp="t", host="h", backend="cpu", wall_time_s=0.5,
                                    solver="lu", num_dofs=6)
    return module.ValidationResult.create("case", pos, exact * (1 + 1e-3), exact, {"ka": 1.0}, meta)


def test_validation_result_matches_reference(tmp_path, capsys):
    got, ref = _validation(testing), _validation(jax_testing)
    assert got.to_dict() == ref.to_dict()
    assert got.passed(1e-2) == ref.passed(1e-2) and not got.passed(1e-4)
    path = tmp_path / "case.json"
    got.save_json(str(path))
    assert testing.ValidationResult.load_json(str(path)).to_dict() == ref.to_dict()
    assert got.print_summary() == ref.print_summary()
    empty = testing.ErrorMetrics.compute(np.zeros(0), np.zeros(0))
    assert dataclasses.asdict(empty) == dataclasses.asdict(jax_testing.ErrorMetrics.compute(
        np.zeros(0), np.zeros(0)))


def test_timer_and_span_report_host_time(capsys):
    import sys

    t = Timer()
    for _ in range(2):
        with t.phase("assembly"):
            pass
    assert list(t.phases) == ["assembly"] and t.phases["assembly"] >= 0.0
    t.report(file=sys.stdout)
    with span("solve", 1, file=sys.stdout):
        pass
    with span("quiet", 0, file=sys.stdout):
        pass
    out = capsys.readouterr().out
    assert "  assembly: " in out and "solve: " in out and "quiet" not in out
