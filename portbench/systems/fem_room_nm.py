"""The node-major FEM room sweep as a system under test: builds the
program's ``NodeMajorRoomSweep`` from the configuration, runs one sweep
per call (``sweep_fn``: DIA kernel, batched GMRES, geometric multigrid),
and checks a sample of the answers against the plain reference
(``reference/fem_room_nm.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference.fem_room_nm import RoomSystem


def program_ks(inputs) -> np.ndarray:
    """The band as the program receives it (float32), and as the
    reference is given it."""
    return np.asarray(inputs["ks"], np.float32)


class System:
    def __init__(self, config: dict, traffic, device):
        from mathaudio_tpu_torch.fem import dia
        from mathaudio_tpu_torch.fem.multigrid import GeometricMultigrid, box_hierarchy
        from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel
        from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorRoomSweep
        from mathaudio_tpu_torch.solvers.krylov import KrylovConfig

        self._dia = dia
        self.device = device
        room, p = config["room"], traffic.params
        t0 = time.perf_counter()
        meshes = box_hierarchy(int(p["mesh_cells"]), int(config["multigrid"]["levels"]))
        walls = tuple(room["wall_tags"])
        mg = GeometricMultigrid(meshes, robin_tags=walls, dtype=torch.float32, device=device)
        model = RoomSweepModel(meshes[0], wall_tags=walls, absorption=room["absorption"],
                               source_position=tuple(room["source_position"]),
                               source_width=room["source_width"],
                               listening_positions=tuple(map(tuple,
                                                             room["listening_positions"])),
                               assembler=mg.assemblers[0])
        nm = NodeMajorRoomSweep(model, mg)
        g = config["gmres"]
        self.fn = nm.sweep_fn(KrylovConfig(max_iterations=g["max_iterations"],
                                           tolerance=g["tolerance"], restart=g["restart"]),
                              **config["sweep_knobs"])
        self.params = nm.params()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.host_build_s = time.perf_counter() - t0
        self.nodes = meshes[0].num_nodes

    def run(self, inputs) -> dict:
        """One sweep, its answers on the host."""
        ks = torch.as_tensor(program_ks(inputs), device=self.device)
        p, its, conv = self.fn(self.params, ks)
        return {"p": p.cpu(), "iterations": its.cpu(), "converged": conv.cpu()}

    def summary(self, out: dict) -> dict:
        lanes = int(out["converged"].numel())
        done = int(out["converged"].sum())
        return {"lanes": lanes, "failed": lanes - done, "dof_solves": self.nodes * done,
                "iterations": float(out["iterations"].double().sum())}

    def reset_counters(self) -> None:
        self._dia.reset_launches()

    def counters(self) -> dict:
        return {"dia_launches_by_shape": [[*k, v] for k, v in
                                          self._dia.LAUNCHES_BY_SHAPE.items()]}


def reference(config: dict, traffic, device) -> RoomSystem:
    room = config["room"]
    return RoomSystem(int(traffic.params["mesh_cells"]), room["absorption"],
                      room["source_position"], room["source_width"],
                      room["listening_positions"], device)


def sample_ks(traffic, sample):
    return np.concatenate([program_ks(traffic.sweep(s))[lanes] for s, lanes in sample])


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Widest gap over lanes of max over listeners |got - want|, as a share
    of the lane's largest reference pressure."""
    got = got.to(torch.complex128).to(want.device)
    per_lane = (got - want).abs().amax(dim=1) / want.abs().amax(dim=1)
    return float(per_lane.max())


def check(config: dict, traffic, outputs: dict, sample, device) -> dict:
    """Compare the sampled lanes of the sampled sweeps with the float64
    reference solved at the same wavenumbers."""
    ref = reference(config, traffic, device)
    want, _, rel = ref.solve(torch.as_tensor(sample_ks(traffic, sample), dtype=torch.float64))
    if float(rel.max()) > 1e-9:
        raise RuntimeError(f"the reference solve stopped at residual {float(rel.max()):.3e}")
    got = torch.cat([outputs[s]["p"][lanes] for s, lanes in sample])
    return {"pressure_gap": gap(got, want)}


def control(config: dict, traffic, sample, device, round_operands) -> dict:
    """The check's reading of the reference put in the program's place and
    computed with ``round_operands`` on every product."""
    ref = reference(config, traffic, device)
    ks = torch.as_tensor(sample_ks(traffic, sample), dtype=torch.float64)
    want, _, _ = ref.solve(ks)
    got, _, _ = ref.solve(ks, round_operands=round_operands)
    return {"pressure_gap": gap(got, want)}
