"""Simulation output JSON (counterpart of mathaudio_tpu/common/output.py;
pure Python and numpy): FrequencyResult/SimulationResults containers,
key for key the reference's JSON, spatial SPL slices, and the
default-config factory."""

from __future__ import annotations

import dataclasses
import datetime
import json
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from mathaudio_tpu_torch.common.config import RoomConfig
from mathaudio_tpu_torch.common.types import pressure_to_spl


@dataclasses.dataclass
class FrequencyResult:
    """Per-frequency SPL at listening positions."""

    frequency: float
    spl_db: List[float]
    pressure_real: Optional[List[float]] = None
    pressure_imag: Optional[List[float]] = None
    converged: bool = True
    iterations: int = 0
    solve_time_s: float = 0.0


@dataclasses.dataclass
class SimulationResults:
    """Full run output."""

    config: Dict[str, Any]
    listening_positions: List[Dict[str, float]]
    results: List[FrequencyResult]
    slices: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "config": self.config,
            "listening_positions": self.listening_positions,
            "results": [dataclasses.asdict(r) for r in self.results],
            "slices": self.slices,
            "metadata": self.metadata,
        }

    def save(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2)


def create_output_json(
    config: RoomConfig,
    frequencies,
    spl_matrix,
    extra_metadata: Optional[Dict[str, Any]] = None,
) -> SimulationResults:
    """``spl_matrix`` is (F, L) dB."""
    spl_matrix = np.asarray(spl_matrix)
    results = [
        FrequencyResult(float(f), [float(v) for v in spl_matrix[i]])
        for i, f in enumerate(np.asarray(frequencies))
    ]
    meta = {
        "generated": datetime.datetime.now().isoformat(),
        "generator": "mathaudio_tpu_torch",
        **(extra_metadata or {}),
    }
    return SimulationResults(
        config=config.to_dict(),
        listening_positions=list(config.listening_positions),
        results=results,
        metadata=meta,
    )


def create_output_json_with_sources(
    config: RoomConfig, frequencies, spl_matrix, per_source_spl: Dict[str, Any], **kw
) -> SimulationResults:
    """Adds per-source SPL breakdowns to the metadata."""
    out = create_output_json(config, frequencies, spl_matrix, **kw)
    out.metadata["per_source_spl"] = per_source_spl
    return out


def generate_spatial_slices(
    pressure_fn: Callable,
    room_dims,
    z_height: float,
    resolution: int = 50,
) -> Dict[str, Any]:
    """Horizontal SPL slice at a height: evaluates
    ``pressure_fn((M, 3) points) -> complex (M,)`` (an array, or a tensor on
    any device) on a grid."""
    w, d, _ = room_dims
    xs = np.linspace(0, w, resolution)
    ys = np.linspace(0, d, resolution)
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([xx.reshape(-1), yy.reshape(-1), np.full(xx.size, z_height)], axis=1)
    p = torch.as_tensor(pressure_fn(pts)).cpu()
    spl = pressure_to_spl(torch.abs(p)).numpy().reshape(resolution, resolution)
    return {
        "z": z_height,
        "x": xs.tolist(),
        "y": ys.tolist(),
        "spl_db": spl.tolist(),
    }


def create_default_config() -> RoomConfig:
    """A small rectangular room."""
    return RoomConfig.from_dict(
        {
            "room": {"type": "rectangular", "width": 4.0, "depth": 5.0, "height": 2.7},
            "sources": [
                {
                    "name": "Speaker",
                    "position": {"x": 1.0, "y": 1.0, "z": 1.2},
                    "amplitude": 1.0,
                }
            ],
            "listening_positions": [{"x": 2.0, "y": 3.0, "z": 1.2}],
            "frequencies": {
                "min_freq": 20.0,
                "max_freq": 200.0,
                "num_points": 20,
                "spacing": "logarithmic",
            },
            "boundaries": {
                "floor": {"type": "absorption", "coefficient": 0.1},
                "ceiling": {"type": "absorption", "coefficient": 0.1},
                "walls": {"type": "absorption", "coefficient": 0.05},
            },
        }
    )
