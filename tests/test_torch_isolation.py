"""The port stands alone: mathaudio_tpu_torch, chip_smoke.py, dia_bench.py and
bem_bench.py import neither JAX nor the JAX package, and entry points never
drift to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "mathaudio_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "dia_bench.py", ROOT / "bem_bench.py"]
FORBIDDEN = ("jax", "jaxlib", "mathaudio_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in names and "dia_bench.py" in names and "bem_bench.py" in names
    assert "mathaudio_tpu_torch/fem/dia.py" in names
    assert "mathaudio_tpu_torch/models/room_sweep_nm.py" in names
    assert "mathaudio_tpu_torch/ops/bem_assembly.py" in names
    assert "mathaudio_tpu_torch/bem/sweep.py" in names
    for module in ("bem/types.py", "bem/solver.py", "bem/postprocess.py", "bem/room_acoustics.py",
                   "solvers/preconditioners/basic.py", "common/types.py", "common/source.py",
                   "dsp/__init__.py", "dsp/iir.py", "dsp/scan.py", "dsp/fir.py", "dsp/denormals.py",
                   "dsp/formats.py", "dsp/response.py", "optim/__init__.py", "optim/de.py",
                   "optim/recorder.py", "optim/peq_fit.py", "apps/__init__.py", "apps/autoeq.py",
                   "convert.py", "xtypes.py", "wave/__init__.py", "wave/special/__init__.py",
                   "wave/special/bessel.py", "wave/special/spherical.py", "wave/special/legendre.py",
                   "wave/special/helmholtz.py", "wave/analytical/__init__.py",
                   "wave/analytical/solution.py", "wave/analytical/solutions_1d.py",
                   "wave/analytical/solutions_2d.py", "wave/analytical/solutions_3d.py",
                   "common/__init__.py", "common/geometry.py", "common/config.py",
                   "common/output.py", "utils/__init__.py", "utils/profiling.py", "bem/testing.py",
                   "apps/roomsim_bem.py", "apps/qa_suite_bem.py", "bem/fmm.py", "bem/octree.py",
                   "solvers/operators.py", "solvers/sparse.py", "solvers/preconditioners/ilu.py",
                   "native/__init__.py", "bem/fmm_chip.py", "testfunctions/__init__.py",
                   "testfunctions/functions.py", "testfunctions/registry.py", "hull/__init__.py",
                   "hull/quickhull.py", "hull/export.py", "hull/testdata.py", "apps/run_de.py",
                   "apps/benchmark_convergence.py", "apps/plot_de.py", "apps/plot_functions.py",
                   "parallel/__init__.py", "parallel/mesh.py", "parallel/spmd.py",
                   "parallel/fmm_spmd.py", "parallel/de.py", "parallel/launch.py",
                   "parallel/dryrun.py"):
        assert f"mathaudio_tpu_torch/{module}" in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = sorted({root for root in _imported_roots(path) if root in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, mathaudio_tpu_torch, mathaudio_tpu_torch.convert, "
        "mathaudio_tpu_torch.models.room_sweep_nm, mathaudio_tpu_torch.bem.sweep, "
        "mathaudio_tpu_torch.bem, mathaudio_tpu_torch.bem.room_acoustics, "
        "mathaudio_tpu_torch.solvers.preconditioners.basic, mathaudio_tpu_torch.common.source, "
        "mathaudio_tpu_torch.dsp, mathaudio_tpu_torch.dsp.response, mathaudio_tpu_torch.optim, "
        "mathaudio_tpu_torch.optim.peq_fit, mathaudio_tpu_torch.apps.autoeq, "
        "mathaudio_tpu_torch.wave, mathaudio_tpu_torch.common, mathaudio_tpu_torch.utils, "
        "mathaudio_tpu_torch.bem.testing, mathaudio_tpu_torch.apps.roomsim_bem, "
        "mathaudio_tpu_torch.apps.qa_suite_bem, mathaudio_tpu_torch.bem.fmm, "
        "mathaudio_tpu_torch.bem.octree, mathaudio_tpu_torch.bem.fmm_chip, mathaudio_tpu_torch.native, "
        "mathaudio_tpu_torch.solvers.preconditioners.ilu, mathaudio_tpu_torch.fem, "
        "mathaudio_tpu_torch.models, mathaudio_tpu_torch.ops, mathaudio_tpu_torch.solvers, "
        "mathaudio_tpu_torch.models.helmholtz_room, mathaudio_tpu_torch.fem.multigrid, "
        "mathaudio_tpu_torch.testfunctions, mathaudio_tpu_torch.hull, "
        "mathaudio_tpu_torch.apps.run_de, mathaudio_tpu_torch.apps.benchmark_convergence, "
        "mathaudio_tpu_torch.apps.plot_de, mathaudio_tpu_torch.apps.plot_functions, "
        "mathaudio_tpu_torch.parallel, mathaudio_tpu_torch.parallel.spmd, "
        "mathaudio_tpu_torch.parallel.fmm_spmd, mathaudio_tpu_torch.parallel.launch, "
        "mathaudio_tpu_torch.parallel.dryrun; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mathaudio_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_refuse_to_drift_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is valid here")
    from mathaudio_tpu_torch.fem.multigrid import GeometricMultigrid, box_hierarchy
    from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel

    meshes = box_hierarchy(2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RoomSweepModel(meshes[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GeometricMultigrid(meshes)

    import numpy as np

    from mathaudio_tpu_torch.bem.postprocess import evaluate_field
    from mathaudio_tpu_torch.bem.room_acoustics import solve_room_bem
    from mathaudio_tpu_torch.bem.solver import BemProblem, BemSolver
    from mathaudio_tpu_torch.common.source import Source
    from mathaudio_tpu_torch.common.types import Point3D

    rigid = BemProblem.rigid_sphere(1.0, subdivisions=0)
    n = rigid.mesh.num_elements
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BemSolver().solve(rigid)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BemSolver().solve(BemProblem.radiating_sphere(1.0, subdivisions=0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_room_bem(rigid.mesh, 50.0, [Source.omnidirectional(Point3D(0.0, 0.0, 0.0))])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_field(rigid.mesh, np.ones(n, complex), np.array([[0.0, 0.0, 2.0]]), 1.0)

    from mathaudio_tpu_torch.bem import fmm
    from mathaudio_tpu_torch.bem.postprocess import evaluate_field_fmm
    from mathaudio_tpu_torch.bem.types import BemMethod, BemSolverConfig

    for call in (lambda: fmm.build_slfmm_system(rigid.mesh, 1.0),
                 lambda: fmm.build_room_fmm_system(rigid.mesh, 1.0),
                 lambda: fmm.translation_operator(1.0, np.ones((2, 3)), np.eye(3), 2),
                 lambda: evaluate_field_fmm(rigid.mesh, np.ones(n, complex),
                                            np.array([[0.0, 0.0, 2.0]]), 1.0),
                 lambda: BemSolver(BemSolverConfig(assembly=BemMethod.SLFMM)).solve(rigid),
                 lambda: fmm.build_mlfmm_tree_system(rigid.mesh, 1.0),
                 lambda: fmm.build_mlfmm_system(rigid.mesh, 1.0),
                 lambda: BemSolver(BemSolverConfig(assembly=BemMethod.MLFMM)).solve(rigid)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

    from mathaudio_tpu_torch.apps import autoeq
    from mathaudio_tpu_torch.dsp import Biquad, BiquadFilterType, peq_format_apo, peq_spl
    from mathaudio_tpu_torch.dsp.response import peq_response_db
    from mathaudio_tpu_torch.optim import differential_evolution, fit_peq

    peq = [(1.0, Biquad(BiquadFilterType.PEAK, 1000.0, 48000.0, 1.0, 3.0))]
    freqs = np.array([100.0, 1000.0])
    for call in (lambda: peq_spl(freqs, peq), lambda: peq[0][1].process_block(np.ones(4)),
                 lambda: peq_format_apo("# eq", peq),
                 lambda: peq_response_db(["PK"], [[3.0, 1.0, 2.0]], freqs),
                 lambda: differential_evolution(lambda x: (x * x).sum(), [(-1.0, 1.0)]),
                 lambda: fit_peq(freqs, np.zeros(2), n_filters=1, maxiter=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    from mathaudio_tpu_torch.apps.qa_suite_bem import sphere_case
    from mathaudio_tpu_torch.apps.roomsim_bem import run_bem_simulation
    from mathaudio_tpu_torch.common.output import create_default_config
    from mathaudio_tpu_torch.wave.analytical import sphere_scattering_3d
    from mathaudio_tpu_torch.wave.special import spherical_jn_all
    from mathaudio_tpu_torch.xtypes import log_space

    for call in (lambda: run_bem_simulation(create_default_config(), verbose=0),
                 lambda: sphere_case(1.0, 0, str(tmp_path), 0),
                 lambda: sphere_scattering_3d(1.0, 1.0, 10, [1.0], [0.0, 1.0]),
                 lambda: spherical_jn_all(3, [0.5]), lambda: log_space(20.0, 200.0, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    from mathaudio_tpu_torch.apps import benchmark_convergence, plot_functions, run_de

    for call in (lambda: run_de.main(["sphere", "--maxiter", "1"]),
                 lambda: benchmark_convergence.main(["-f", "booth_2d", "-o", str(tmp_path)]),
                 lambda: plot_functions.main(["booth", "-o", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    from mathaudio_tpu_torch.parallel import sweep_mesh
    from mathaudio_tpu_torch.parallel.dryrun import dryrun_multichip

    for call in (lambda: sweep_mesh(1), lambda: dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            call()
    meas = tmp_path / "speaker.csv"
    np.savetxt(meas, np.column_stack([np.geomspace(20.0, 20000.0, 8), np.zeros(8)]), delimiter=",")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autoeq.main([str(meas), "--maxiter", "1"])


def test_native_source_stands_alone():
    """The port's C++ is its own copy: it includes only the standard
    library, and the loader builds it inside the package."""
    src = (ROOT / "mathaudio_tpu_torch" / "native" / "kernels.cpp").read_text()
    includes = [ln.split()[1] for ln in src.splitlines() if ln.startswith("#include")]
    assert includes and all(inc.startswith("<") for inc in includes), includes
    from mathaudio_tpu_torch import native

    assert native.BUILD_DIR.parent == ROOT / "mathaudio_tpu_torch" / "native"
    assert "mathaudio_tpu_torch/native/_build/" in (ROOT / ".gitignore").read_text()


def test_package_inits_build_nothing():
    """The package ``__init__`` files re-export the reference's names and
    stay cheap: no triton, no CUDA initialisation, no kernel library."""
    code = (
        "import sys, torch, mathaudio_tpu_torch, mathaudio_tpu_torch.fem, "
        "mathaudio_tpu_torch.models, mathaudio_tpu_torch.ops, mathaudio_tpu_torch.solvers, "
        "mathaudio_tpu_torch.solvers.preconditioners, mathaudio_tpu_torch.parallel; "
        "from mathaudio_tpu_torch import kernels; "
        "bad = [m for m in sys.modules if m.split('.')[0] == 'triton']; "
        "bad += ['cuda initialised'] if torch.cuda.is_initialized() else []; "
        "bad += ['kernel loaded'] if kernels._loaded else []; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
