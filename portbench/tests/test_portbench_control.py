"""The check's control, the reference computed with TF32 operands in the
program's place, comes out not correct; a run whose timed path is broken
comes out not correct for each fault a cell can have."""

from __future__ import annotations

import pytest
import torch

from portbench import spec
from portbench.harness import run
from portbench.precision import tf32
from portbench.tests.conftest import TINY_BEM, TINY_FEM
from portbench.traffic import Traffic


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -3.0 - 2**-9],
                     dtype=torch.float32)
    assert tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0 - 2**-9]
    z = torch.complex(x, -x)
    assert torch.equal(tf32(z).imag, -tf32(x))


@pytest.mark.parametrize("cell", [TINY_FEM, TINY_BEM])
def test_control_is_not_correct(tiny_root, cpu, cell):
    c = spec.load(tiny_root, cell)
    sut = spec.system(tiny_root, c.config["system"])
    for seed in (1, 2, 3):
        traffic = Traffic(c.traffic, seed)
        readings = sut.control(c.config, traffic, traffic.check_sample(4), cpu, tf32)
        assert any(v > c.traffic["limits"][k] for k, v in readings.items()), readings


def _fem_fault(monkeypatch, kind):
    from mathaudio_tpu_torch.models import room_sweep_nm

    real = room_sweep_nm.gmres_batched

    def broken(a_mv, b, config, preconditioner=None, orth="cgs2", x0=None, a_res=None):
        if kind == "unchanged":  # the solve returns its start unchanged
            sol = real(a_mv, b, config=config._replace(max_iterations=0),
                       preconditioner=preconditioner, orth=orth, x0=x0, a_res=a_res)
            return sol._replace(converged=torch.ones_like(sol.converged))
        if kind == "half":  # half the lanes solved, the rest given their mean
            half = b.shape[1] // 2
            sol = real(a_mv, b, config=config, preconditioner=preconditioner, orth=orth,
                       x0=x0, a_res=a_res)
            x = sol.x.clone()
            x[:, half:] = x[:, :half].mean(dim=1, keepdim=True)
            return sol._replace(x=x)
        sol = real(a_mv, b, config=config, preconditioner=preconditioner, orth=orth, x0=x0,
                   a_res=a_res)
        return sol._replace(x=sol.x.conj().resolve_conj())  # the other time convention's answer

    monkeypatch.setattr(room_sweep_nm, "gmres_batched", broken)


def _bem_fault(monkeypatch, kind):
    from mathaudio_tpu_torch.bem import sweep

    real = sweep._solve_gmres

    def broken(a, r, gmres_tol, gmres_restart):
        x = real(a, r, gmres_tol, gmres_restart)
        if kind == "unchanged":
            return torch.zeros_like(x)
        if kind == "half":
            half = x.shape[0] // 2
            x = x.clone()
            x[half:] = x[:half].mean(dim=0, keepdim=True)
            return x
        return x.conj().resolve_conj()

    monkeypatch.setattr(sweep, "_solve_gmres", broken)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell,plant", [(TINY_FEM, _fem_fault), (TINY_BEM, _bem_fault)])
def test_broken_timed_path_is_not_correct(tiny_root, cpu, monkeypatch, cell, plant, kind):
    plant(monkeypatch, kind)
    result = run(tiny_root, cell, 2**31 + 5, 0.3, False, cpu, log=lambda m: None)
    assert result["correct"] is False, result["checks"]
