"""The dense BEM scattering sweep of a rigid sphere as a system under
test: builds the program's mesh statics once, and per call forms the
band's right-hand sides for that sweep's plane wave (``sweep_inputs``)
and solves the band (``sweep_apply``: the pairwise kernel's assembly,
its epilogue, Jacobi GMRES). The check takes each sampled answer's relative residual in the
plain reference's float64 system (``reference/bem_sphere_dense.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference.bem_sphere_dense import SphereSystem, gmres


def program_ks(inputs) -> np.ndarray:
    return np.asarray(inputs["ks"], np.float32)


def _burton_miller(traffic) -> bool:
    form = traffic.params["formulation"]
    if form not in ("burton_miller", "double_layer"):
        raise ValueError(f"unknown formulation {form!r}")
    return form == "burton_miller"


class System:
    def __init__(self, config: dict, traffic, device):
        from mathaudio_tpu_torch.bem import sweep
        from mathaudio_tpu_torch.bem.incident import plane_wave
        from mathaudio_tpu_torch.bem.mesh import icosphere
        from mathaudio_tpu_torch.ops import bem_assembly

        self._sweep, self._plane_wave, self._ops = sweep, plane_wave, bem_assembly
        self.device = device
        self.bm = _burton_miller(traffic)
        self.solve = config["solve"]
        t0 = time.perf_counter()
        self.mesh = icosphere(config["sphere"]["radius"], int(traffic.params["subdivisions"]))
        self.statics = sweep.sweep_statics(self.mesh, quad_order=config["quad_order"],
                                           dtype=torch.float32, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.host_build_s = time.perf_counter() - t0
        if self.statics.qp.shape[1] != config["quad_points"]:
            raise ValueError(f"quad order {config['quad_order']} gives "
                             f"{self.statics.qp.shape[1]} points, the configuration states "
                             f"{config['quad_points']}")

    def run(self, inputs) -> dict:
        ks = torch.as_tensor(program_ks(inputs), device=self.device)
        betas, rhs = self._sweep.sweep_inputs(self.mesh, self.statics, ks,
                                              self._plane_wave(inputs["direction"]),
                                              burton_miller=self.bm,
                                              beta_scale=self.solve["beta_scale"])
        p = self._sweep.sweep_apply(self.statics, ks, betas, rhs, burton_miller=self.bm,
                                    solver="gmres", gmres_tol=self.solve["gmres_tol"],
                                    gmres_restart=self.solve["gmres_restart"])
        return {"p": p.cpu()}

    def summary(self, out: dict) -> dict:
        finite = torch.isfinite(out["p"]).all(dim=-1)
        lanes = int(finite.numel())
        return {"lanes": lanes, "failed": lanes - int(finite.sum()), "solves": int(finite.sum())}

    def reset_counters(self) -> None:
        self._ops.reset_launches()

    def counters(self) -> dict:
        return {"bem_launches": dict(self._ops.LAUNCHES)}


def reference(config: dict, traffic, device) -> SphereSystem:
    if config["sphere"]["radius"] != 1.0:
        raise ValueError("the reference's icosphere is the unit sphere")
    return SphereSystem(int(traffic.params["subdivisions"]), device)


def _pairs(traffic, sample):
    for s, lanes in sample:
        inputs = traffic.sweep(s)
        ks = program_ks(inputs)
        for lane in lanes:
            yield s, lane, float(ks[lane]), inputs["direction"]


def check(config: dict, traffic, outputs: dict, sample, device) -> dict:
    """Widest relative residual ||A p - b|| / ||b|| of the sampled answers
    in the reference's float64 system."""
    ref = reference(config, traffic, device)
    bm = _burton_miller(traffic)
    worst = 0.0
    for s, lane, k, d in _pairs(traffic, sample):
        res = ref.residual(k, bm, d, outputs[s]["p"][lane])
        worst = max(worst, res) if res == res else float("inf")
    return {"residual": worst}


def control(config: dict, traffic, sample, device, round_operands) -> dict:
    """The same reading of the reference put in the program's place: each
    sampled system assembled by the reference, its operands rounded by
    ``round_operands`` for every product, solved by Jacobi GMRES to the
    configuration's tolerance in complex64."""
    ref = reference(config, traffic, device)
    bm = _burton_miller(traffic)
    solve = config["solve"]
    worst = 0.0
    for _, _, k, d in _pairs(traffic, sample):
        a = round_operands(ref.matrix(k, bm).to(torch.complex64))
        inv_d = 1.0 / torch.diagonal(a)
        b = ref.rhs(k, d, bm).to(torch.complex64)
        x = gmres(lambda v: a @ round_operands(v), b, solve["gmres_tol"],
                  restart=solve["gmres_restart"], precondition=lambda v: inv_d * v)
        del a
        res = ref.residual(k, bm, d, x)
        worst = max(worst, res) if res == res else float("inf")
    return {"residual": worst}
