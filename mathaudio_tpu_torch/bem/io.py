"""BEM input formats (counterpart of mathaudio_tpu/bem/io.py; host Python):
the legacy NumCalc / Mesh2HRTF ``NC.inp`` parser with its node and element
files, and the native JSON/TOML ``BemConfig``, whose ``build_problem``
gives the port's ``BemProblem`` for ``BemSolver``."""

from __future__ import annotations

import dataclasses
import json
import os
import tomllib
from typing import Dict, List, Tuple

import numpy as np

from mathaudio_tpu_torch.bem.incident import plane_wave, point_source
from mathaudio_tpu_torch.bem.mesh import cylinder_mesh, icosphere, uv_sphere
from mathaudio_tpu_torch.bem.solver import BemProblem
from mathaudio_tpu_torch.bem.types import PhysicsParams


@dataclasses.dataclass
class MainParamsI:
    element_type: int = 2
    num_nodes: int = 0
    num_elements: int = 0
    solver_method: int = 1  # position 6 in the line (nc_format convention)


@dataclasses.dataclass
class MainParamsIV:
    speed_of_sound: float = 343.0
    density: float = 1.21


@dataclasses.dataclass
class BoundarySpec:
    elem_start: int
    elem_end: int
    bc_type: str  # VELO | PRES | ADMI
    value_re: float
    curve_re: int
    value_im: float
    curve_im: int


@dataclasses.dataclass
class PlaneWaveSource:
    direction: np.ndarray
    amplitude: complex


@dataclasses.dataclass
class PointSourceSpec:
    position: np.ndarray
    amplitude: complex


@dataclasses.dataclass
class NcInputConfig:
    """Parsed NC.inp."""

    version: str = ""
    description: str = ""
    control_params_i: List[int] = dataclasses.field(default_factory=list)
    control_params_ii: List[float] = dataclasses.field(default_factory=list)
    frequency_curve: List[Tuple[float, float, float]] = dataclasses.field(default_factory=list)
    main_params_i: MainParamsI = dataclasses.field(default_factory=MainParamsI)
    main_params_ii: List[float] = dataclasses.field(default_factory=list)
    main_params_iii: List[int] = dataclasses.field(default_factory=list)
    main_params_iv: MainParamsIV = dataclasses.field(default_factory=MainParamsIV)
    node_files: List[str] = dataclasses.field(default_factory=list)
    element_files: List[str] = dataclasses.field(default_factory=list)
    boundary_conditions: List[BoundarySpec] = dataclasses.field(default_factory=list)
    plane_waves: List[PlaneWaveSource] = dataclasses.field(default_factory=list)
    point_sources: List[PointSourceSpec] = dataclasses.field(default_factory=list)
    base_dir: str = "."

    def to_physics_params(self, frequency: float):
        return PhysicsParams(
            frequency=frequency,
            speed_of_sound=self.main_params_iv.speed_of_sound,
            density=self.main_params_iv.density,
        )

    def frequencies(self) -> np.ndarray:
        """Frequencies from the Load Frequency Curve (nonzero entries)."""
        return np.asarray([f for _, f, _ in self.frequency_curve if f > 0])


def _floats(line: str) -> List[float]:
    out = []
    for tok in line.split():
        try:
            out.append(float(tok))
        except ValueError:
            return out
    return out


def parse_nc_input_string(text: str, base_dir: str = ".") -> NcInputConfig:
    """Parse NC.inp text: sections separated by '##' comment markers,
    keyword blocks terminated by blank lines / '##' / RETU / END."""
    cfg = NcInputConfig(base_dir=base_dir)
    lines = text.splitlines()
    i = 0
    n = len(lines)
    # leading non-section content: version then description (the first two
    # non-comment lines before the Controlparameter sections)
    section = None
    pending_header = 2
    while i < n:
        raw = lines[i].strip()
        i += 1
        if raw == "END":
            break
        if raw.startswith("##"):
            low = raw.lower()
            if "controlparameter i" in low and "ii" not in low:
                section = "cpi"
            elif "controlparameter ii" in low:
                section = "cpii"
            elif "frequency curve" in low:
                section = "freq"
            elif "main parameters i" in low and "ii" not in low and "iv" not in low:
                section = "mpi"
            elif "main parameters ii" in low and "iii" not in low:
                section = "mpii"
            elif "main parameters iii" in low:
                section = "mpiii"
            elif "main parameters iv" in low:
                section = "mpiv"
            continue
        if not raw:
            continue
        if raw == "NODES":
            section = "nodes"
            continue
        if raw == "ELEMENTS":
            section = "elements"
            continue
        if raw == "BOUNDARY":
            section = "boundary"
            continue
        if raw == "PLANE WAVES":
            section = "planewaves"
            continue
        if raw == "POINT SOURCES":
            section = "pointsources"
            continue
        if raw == "RETU":
            section = None
            continue

        if section == "cpi":
            cfg.control_params_i = [int(float(x)) for x in raw.split()]
            section = None
        elif section == "cpii":
            cfg.control_params_ii = _floats(raw)
            section = None
        elif section == "freq":
            vals = _floats(raw)
            if len(vals) == 3:
                cfg.frequency_curve.append((vals[0], vals[1], vals[2]))
            # the '0 2' count line is ignored
        elif section == "mpi":
            vals = [int(float(x)) for x in raw.split()]
            cfg.main_params_i = MainParamsI(
                element_type=vals[0] if len(vals) > 0 else 2,
                num_nodes=vals[1] if len(vals) > 1 else 0,
                num_elements=vals[2] if len(vals) > 2 else 0,
                solver_method=vals[5] if len(vals) > 5 else 1,
            )
            section = None
        elif section == "mpii":
            cfg.main_params_ii = _floats(raw)
            section = None
        elif section == "mpiii":
            cfg.main_params_iii = [int(float(x)) for x in raw.split()]
            section = None
        elif section == "mpiv":
            vals = _floats(raw)
            cfg.main_params_iv = MainParamsIV(
                speed_of_sound=vals[0] if vals else 343.0,
                density=vals[1] if len(vals) > 1 else 1.21,
            )
            section = None
        elif section == "nodes":
            cfg.node_files.append(raw)
        elif section == "elements":
            cfg.element_files.append(raw)
        elif section == "boundary":
            parts = raw.split()
            if len(parts) >= 9 and parts[0] == "ELEM" and parts[2] == "TO":
                cfg.boundary_conditions.append(
                    BoundarySpec(
                        int(parts[1]), int(parts[3]), parts[4],
                        float(parts[5]), int(float(parts[6])),
                        float(parts[7]), int(float(parts[8])),
                    )
                )
        elif section == "planewaves":
            vals = _floats(raw)
            if len(vals) >= 8:
                cfg.plane_waves.append(
                    PlaneWaveSource(
                        np.asarray(vals[1:4]), complex(vals[4], vals[6])
                    )
                )
        elif section == "pointsources":
            vals = _floats(raw)
            if len(vals) >= 8:
                cfg.point_sources.append(
                    PointSourceSpec(np.asarray(vals[1:4]), complex(vals[4], vals[6]))
                )
        elif pending_header > 0:
            if pending_header == 2:
                cfg.version = raw
            else:
                cfg.description = raw
            pending_header -= 1
    return cfg


def parse_nc_input(path: str) -> NcInputConfig:
    with open(path) as fh:
        return parse_nc_input_string(fh.read(), base_dir=os.path.dirname(path) or ".")


def load_nc_nodes(path: str) -> np.ndarray:
    """NumCalc nodes file: first line = count, then 'id x y z'."""
    rows = []
    with open(path) as fh:
        lines = [ln.strip() for ln in fh if ln.strip() and not ln.startswith("#")]
    count = int(float(lines[0].split()[0]))
    for ln in lines[1: 1 + count]:
        vals = ln.split()
        rows.append([float(vals[1]), float(vals[2]), float(vals[3])])
    return np.asarray(rows)


def load_nc_elements(path: str) -> np.ndarray:
    """NumCalc elements file: first line = count, then
    'id n0 n1 n2 [n3] type group ...' — triangles returned (quads split)."""
    tris = []
    with open(path) as fh:
        lines = [ln.strip() for ln in fh if ln.strip() and not ln.startswith("#")]
    count = int(float(lines[0].split()[0]))
    for ln in lines[1: 1 + count]:
        vals = [int(float(v)) for v in ln.split()]
        conn = vals[1:]
        # heuristic: trailing metadata follows connectivity; tri if the
        # 4th entry looks like a type/group marker
        if len(conn) >= 4 and conn[3] not in (0, 1, 2) or len(conn) == 3:
            n = conn[:3]
            tris.append(n)
        elif len(conn) >= 4:
            a, b, c, d = conn[:4]
            tris.append([a, b, c])
            tris.append([a, c, d])
        else:
            tris.append(conn[:3])
    return np.asarray(tris, np.int64)


# ---------------------------------------------------------------- native

@dataclasses.dataclass
class BemConfig:
    """Native JSON/TOML config: frequency and medium, ``mesh`` ({"type":
    "icosphere" | "uv_sphere" | "cylinder", ...}) and ``incident`` ({"type":
    "plane" | "point", ...}); ``solver`` is carried for the caller."""

    frequency: float = 1000.0
    speed_of_sound: float = 343.0
    density: float = 1.204
    mesh: Dict = dataclasses.field(default_factory=dict)  # {"type": "sphere", ...}
    incident: Dict = dataclasses.field(default_factory=dict)
    solver: Dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_file(cls, path: str) -> "BemConfig":
        if path.endswith(".toml"):
            with open(path, "rb") as fb:
                d = tomllib.load(fb)
        else:
            with open(path) as fh:
                d = json.load(fh)
        return cls(**{k: d[k] for k in d if k in {f.name for f in dataclasses.fields(cls)}})

    def build_problem(self):
        """The configured ``BemProblem`` (host mesh; the solver moves it to
        its device)."""
        mt = self.mesh.get("type", "icosphere")
        if mt == "icosphere":
            mesh = icosphere(self.mesh.get("radius", 1.0), self.mesh.get("subdivisions", 2))
        elif mt == "uv_sphere":
            mesh = uv_sphere(
                self.mesh.get("radius", 1.0),
                self.mesh.get("n_theta", 12),
                self.mesh.get("n_phi", 24),
            )
        elif mt == "cylinder":
            mesh = cylinder_mesh(
                self.mesh.get("radius", 1.0), self.mesh.get("height", 2.0),
                self.mesh.get("n_circ", 24), self.mesh.get("n_height", 8),
            )
        else:
            raise ValueError(f"unknown mesh type {mt}")

        it = self.incident.get("type", "plane")
        if it == "plane":
            inc = plane_wave(self.incident.get("direction", (0, 0, 1)))
        else:
            inc = point_source(self.incident["position"], self.incident.get("amplitude", 1.0))

        phys = PhysicsParams(self.frequency, self.speed_of_sound, self.density)
        return BemProblem(mesh=mesh, physics=phys, incident=inc)
