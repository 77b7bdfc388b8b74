"""Port vs reference: differential evolution, its recorder, the PEQ fit and
the auto-EQ CLI (mathaudio_tpu/optim and apps/autoeq.py vs
mathaudio_tpu_torch/optim and apps/autoeq.py), on the CPU in float64.

``jax.random`` streams cannot be reproduced in torch, so the deterministic
parts are held exactly (the 14 mutation strategies at 1e-15 given the same
population, indices and F; the penalty energy at 1e-12; fixed-variable
elimination; the all-fixed report) and the random parts by their
invariants (one Latin-hypercube sample per stratum, distinct donor indices,
a forced binomial j_rand, one contiguous wrap-around exponential run) and
by outcome: the port and the reference both reach the known minimum of
sphere and Rosenbrock in 4 dimensions for best1bin, rand1exp and adaptive,
with both ``jit_loop`` values. ``fit_peq`` recovers the auto-EQ test's PEQ
within its 0.35 dB. Tests marked ``cuda`` run DE on the card and skip
without one.
"""

import csv
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mathaudio_tpu.optim as joptim
import mathaudio_tpu.optim.de as jde
import mathaudio_tpu.optim.recorder as jrecorder
import mathaudio_tpu_torch.optim as optim
from mathaudio_tpu_torch.apps import autoeq
from mathaudio_tpu_torch.dsp import SRATE, Biquad, BiquadFilterType, peq_spl
from mathaudio_tpu_torch.optim import de, recorder

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these shapes more threads do not shorten
    the tests and only contend with the other workers of a parallel run."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gen(seed=0):
    return torch.Generator(device=CPU).manual_seed(seed)


# --------------------------------------------------------------------------
# Deterministic helpers: exact
# --------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", [s.value for s in jde.Strategy])
def test_mutant_matches_the_reference(strategy):
    rng = np.random.default_rng(1)
    npop, n = 12, 5
    pop = rng.uniform(-3, 3, (npop, n))
    best = pop[4]
    idx = np.stack([rng.choice(np.delete(np.arange(npop), i), 5, replace=False)
                    for i in range(npop)])
    for f in (0.7, rng.uniform(0.1, 1.2, (npop, 1))):
        ref = np.asarray(jde._mutant(jde.Strategy(strategy), jnp.asarray(pop), jnp.asarray(best),
                                     jnp.asarray(idx), jnp.asarray(f)))
        got = de._mutant(de.Strategy(strategy), torch.tensor(pop), torch.tensor(best),
                         torch.tensor(idx), torch.tensor(f, dtype=torch.float64))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-15)


def test_energy_with_penalties_matches_the_reference():
    rng = np.random.default_rng(2)
    cfgs = []
    for pkg, xp in ((jde, jnp), (de, torch)):
        cfg = pkg.DEConfig()
        cfg.penalty_ineq.append((lambda x, xp=xp: x[0] + x[1] - 0.5, 1e3))
        cfg.penalty_eq.append((lambda x, xp=xp: xp.sum(x * x) - 1.0, 10.0))
        pkg.LinearConstraintHelper(a=np.array([[1.0, -2.0, 0.5], [0.0, 1.0, 1.0]]),
                                   lb=np.array([-0.3, -np.inf]), ub=np.array([0.4, 0.2])
                                   ).apply_to(cfg, weight=1e4)
        pkg.NonlinearConstraintHelper(fun=lambda x, xp=xp: xp.stack([x[0] * x[2], x[1]]),
                                      lb=np.array([-0.1, 0.3]), ub=np.array([0.1, 0.3])
                                      ).apply_to(cfg, weight_ineq=50.0, weight_eq=70.0)
        cfgs.append(cfg)
    assert len(cfgs[1].penalty_ineq) == len(cfgs[0].penalty_ineq) == 3
    assert len(cfgs[1].penalty_eq) == len(cfgs[0].penalty_eq) == 2
    ref_e = jde._make_energy(lambda x: jnp.sum((x - 0.3) ** 2), cfgs[0])
    got_e = de._make_energy(lambda x: torch.sum((x - 0.3) ** 2), cfgs[1], device=CPU)
    pts = rng.uniform(-1.5, 1.5, (16, 3))
    want = np.array([float(ref_e(jnp.asarray(p))) for p in pts])
    got = torch.func.vmap(got_e)(torch.tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def _sphere(x):
    return torch.sum(x * x)


def _jsphere(x):
    return jnp.sum(x * x)


def _rosenbrock(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _jrosenbrock(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def test_fixed_variables_and_the_all_fixed_report():
    bounds = [(-5.0, 5.0), (2.0, 2.0), (-5.0, 5.0), (-1.5, -1.5)]
    got = de.differential_evolution(_sphere, bounds, maxiter=120, seed=2, tol=0.0, device=CPU)
    ref = jde.differential_evolution(_jsphere, bounds, maxiter=120, seed=2, tol=0.0)
    assert got.x[1] == ref.x[1] == 2.0 and got.x[3] == ref.x[3] == -1.5
    assert got.population.shape == ref.population.shape == (30, 4)
    assert (got.population[:, 1] == 2.0).all() and (got.population[:, 3] == -1.5).all()
    assert got.nfev == 30 * (got.nit + 1) and ref.nfev == 30 * (ref.nit + 1)
    assert abs(got.fun - 6.25) < 1e-6 and abs(ref.fun - 6.25) < 1e-6
    fixed = [(1.0, 1.0), (-2.0, -2.0)]
    got = de.differential_evolution(_sphere, fixed, device=CPU)
    ref = jde.differential_evolution(_jsphere, fixed)
    np.testing.assert_array_equal(got.x, ref.x)
    np.testing.assert_array_equal(got.population, ref.population)
    np.testing.assert_array_equal(got.population_energies, ref.population_energies)
    assert (got.fun, got.success, got.message, got.nit, got.nfev) == (
        ref.fun, ref.success, ref.message, ref.nit, ref.nfev)


# --------------------------------------------------------------------------
# Random helpers: invariants
# --------------------------------------------------------------------------


def test_latin_hypercube_one_sample_per_stratum():
    npop, n = 16, 4
    lb = torch.tensor([-2.0, 0.0, 1.0, -1.0], dtype=torch.float64)
    ub = torch.tensor([2.0, 10.0, 3.0, 0.0], dtype=torch.float64)
    pop = de._latin_hypercube(_gen(3), npop, n, lb, ub).numpy()
    assert pop.shape == (npop, n)
    assert (pop >= lb.numpy()).all() and (pop <= ub.numpy()).all()
    unit = (pop - lb.numpy()) / (ub - lb).numpy()
    for j in range(n):
        assert sorted(np.floor(unit[:, j] * npop).astype(int).tolist()) == list(range(npop))


@pytest.mark.parametrize("npop,k", [(6, 5), (40, 2), (315, 5)])
def test_distinct_indices(npop, k):
    idx = de._distinct_indices(_gen(npop), npop, k).numpy()
    assert idx.shape == (npop, k) and idx.min() >= 0 and idx.max() < npop
    for i, row in enumerate(idx):
        assert len(set(row)) == k and i not in row
    with pytest.raises(ValueError, match="distinct"):
        de._distinct_indices(_gen(), 5, 5)


@pytest.mark.parametrize("cr", [0.0, 0.3, 1.0])
def test_crossover_masks(cr):
    npop, n = 64, 7
    mask = de._crossover_mask_bin(_gen(1), npop, n, cr).numpy()
    assert mask.shape == (npop, n) and mask.any(axis=1).all()  # j_rand forced on
    if cr == 0.0:
        assert (mask.sum(axis=1) == 1).all()
    if cr == 1.0:
        assert mask.all()
    crs = torch.full((npop,), cr, dtype=torch.float64)
    mask = de._crossover_mask_exp(_gen(2), npop, n, crs).numpy()
    for row in mask:
        on = np.flatnonzero(row)
        assert len(on) >= 1
        # one contiguous run, wrapping around from the last dimension to the first
        assert np.count_nonzero(row != np.roll(row, 1)) in (0, 2)
    if cr == 0.0:
        assert (mask.sum(axis=1) == 1).all()
    if cr == 1.0:
        assert mask.all()
    wrapped = [row for row in mask if row[0] and row[-1] and not row.all()]
    assert cr != 0.3 or wrapped


# --------------------------------------------------------------------------
# Whole runs: both packages reach the known minimum
# --------------------------------------------------------------------------

PROBLEMS = {"sphere": (_sphere, _jsphere, (-5.0, 5.0), 0.0, 150),
            "rosenbrock": (_rosenbrock, _jrosenbrock, (-2.0, 2.0), 1.0, 600)}


@pytest.mark.parametrize("jit_loop", [False, True])
@pytest.mark.parametrize("strategy", ["best1bin", "rand1exp", "adaptivebin"])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_whole_run_reaches_the_minimum(problem, strategy, jit_loop):
    fn, jfn, box, x_star, maxiter = PROBLEMS[problem]
    kw = dict(maxiter=maxiter, seed=3, tol=0.0, strategy=strategy, jit_loop=jit_loop)
    for report in (de.differential_evolution(fn, [box] * 4, device=CPU, **kw),
                   jde.differential_evolution(jfn, [box] * 4, **kw)):
        assert report.fun <= 1e-8, report.fun
        assert np.abs(np.asarray(report.x) - x_star).max() <= 1e-3
        assert report.nfev == 60 * (report.nit + 1)


def test_jit_loop_matches_the_host_loop_and_seeds_repeat():
    kw = dict(maxiter=80, seed=11, tol=1e-10, device=CPU)
    host = de.differential_evolution(_sphere, [(-5.0, 5.0)] * 2, **kw)
    loop = de.differential_evolution(_sphere, [(-5.0, 5.0)] * 2, jit_loop=True, **kw)
    again = de.differential_evolution(_sphere, [(-5.0, 5.0)] * 2, jit_loop=True, **kw)
    assert loop.fun == host.fun and loop.nit == host.nit and loop.success == host.success
    np.testing.assert_array_equal(loop.population, again.population)
    with pytest.warns(UserWarning, match="callback/disp are ignored"):
        de.differential_evolution(_sphere, [(-1.0, 1.0)] * 2, maxiter=2, jit_loop=True,
                                  disp=True, device=CPU)


def test_callback_stop_as_the_reference():
    def cb(inter):
        assert isinstance(inter.x, np.ndarray) and inter.x.shape == (2,)
        return de.CallbackAction.STOP if inter.iter >= 3 else de.CallbackAction.CONTINUE

    def jcb(inter):
        return jde.CallbackAction.STOP if inter.iter >= 3 else jde.CallbackAction.CONTINUE

    got = de.differential_evolution(_sphere, [(-5.0, 5.0)] * 2, maxiter=100, seed=8, callback=cb,
                                    tol=0.0, device=CPU)
    ref = jde.differential_evolution(_jsphere, [(-5.0, 5.0)] * 2, maxiter=100, seed=8,
                                     callback=jcb, tol=0.0)
    assert (got.nit, got.message, got.nfev) == (ref.nit, ref.message, ref.nfev) == (
        3, "callback requested stop", 30 * 4)


def test_integrality_x0_polish_and_wls():
    r = de.differential_evolution(lambda x: torch.sum((x - 2.4) ** 2), [(-5.0, 5.0)] * 2,
                                  maxiter=150, seed=4, tol=0.0, integrality=[True, False],
                                  device=CPU)
    assert r.x[0] == 2.0 and abs(r.x[1] - 2.4) < 1e-4
    r = de.differential_evolution(_sphere, [(-5.0, 5.0)] * 2, maxiter=5, seed=6, tol=0.0,
                                  x0=[1e-8, -1e-8], device=CPU)
    assert r.fun < 1e-10
    r = de.differential_evolution(_rosenbrock, [(-2.0, 2.0)] * 2, maxiter=60, seed=10, tol=0.0,
                                  polish=de.PolishConfig(enabled=True), device=CPU)
    assert r.fun < 1e-6 and r.nfev > 60 * 20
    cfg = de.DEConfig(maxiter=150, seed=12, tol=0.0,
                      adaptive=de.AdaptiveConfig(wls_enabled=True, wls_prob=0.5, wls_scale=0.05))
    r = de.differential_evolution(_rosenbrock, [(-2.0, 2.0)] * 2, config=cfg, device=CPU)
    assert r.fun < 1e-3
    cfg = de.DEConfigBuilder().maxiter(50).popsize(10).strategy("rand2exp").seed(42).build()
    r = de.differential_evolution(_sphere, [(-5.0, 5.0)] * 3, config=cfg, device=CPU)
    assert cfg.strategy is de.Strategy.RAND2EXP and r.fun < 1e-2
    with pytest.raises(AttributeError):
        de.DEConfigBuilder().maxitr(5)
    with pytest.raises(TypeError, match="unknown config field"):
        de.differential_evolution(_sphere, [(-1.0, 1.0)], maxitr=5, device=CPU)


# --------------------------------------------------------------------------
# Recorder: the reference's CSV, character for character
# --------------------------------------------------------------------------


def test_recorder_csv_equals_the_reference(tmp_path):
    rows = [(1, 1, np.array([0.1, -2.0 / 3.0]), 1.25, 1.25, True),
            (2, 2, np.array([1e-17, 3.0]), 2.5, 1.25, False)]
    paths = {}
    for name, mod in (("port", recorder), ("ref", jrecorder)):
        paths[name] = tmp_path / f"{name}.csv"
        rec = mod.EvaluationRecorder(str(paths[name]), 2, flush_every=1)
        for row in rows:
            rec.record(mod.RecordedEvaluation(*row))
        rec.close()
        assert len(rec.rows) == 2
    assert paths["port"].read_text() == paths["ref"].read_text()

    csv_path = tmp_path / "trace.csv"
    report, recorded = optim.run_recorded_differential_evolution(
        _sphere, [(-5.0, 5.0)] * 2, str(csv_path), maxiter=20, seed=1, tol=0.0, device=CPU)
    assert len(recorded) == report.nit == 20
    bests = [r.best_so_far for r in recorded]
    assert all(b2 <= b1 for b1, b2 in zip(bests, bests[1:]))
    with open(csv_path) as fh:
        table = list(csv.reader(fh))
    assert table[0] == ["eval_id", "generation", "x0", "x1", "f", "best_so_far", "improvement"]
    assert len(table) == 21 and table[1][:2] == ["1", "1"] and table[1][-1] in ("0", "1")


# --------------------------------------------------------------------------
# The auto-EQ path
# --------------------------------------------------------------------------

TRUTH = [("LOWSHELF", 120.0, 0.9, 4.0), ("PEAK", 1800.0, 1.5, -5.0), ("HIGHSHELF", 9000.0, 0.8, 2.5)]


def test_fit_peq_recovers_the_target():
    truth = [(1.0, Biquad(BiquadFilterType[t], f, SRATE, q, g)) for t, f, q, g in TRUTH]
    freqs = np.logspace(np.log10(20.0), np.log10(20000.0), 96)
    target = peq_spl(freqs, truth, device=CPU).numpy()
    res = optim.fit_peq(freqs, target, n_filters=3, maxiter=500, seed=4, device=CPU)
    assert res.rms_error_db < 0.35, res.rms_error_db
    np.testing.assert_allclose(res.response_db(freqs, device=CPU).numpy(), target, atol=1.0)
    assert res.params.shape == (3, 3)
    assert [bq.filter_type.short_name for _, bq in res.peq] == ["LS", "PK", "HS"]


def test_autoeq_cli_on_the_cpu(tmp_path, capsys):
    freqs = np.logspace(np.log10(20.0), np.log10(20000.0), 60)
    spl = 80.0 + 3.0 * np.exp(-np.log(freqs / 150.0) ** 2) - 2.0 * np.exp(-np.log(freqs / 4000.0) ** 2)
    meas = tmp_path / "speaker.csv"
    np.savetxt(meas, np.column_stack([freqs, spl]), delimiter=",")
    out = {k: str(tmp_path / f"eq.{k}") for k in ("apo", "rme", "aupreset")}
    rc = autoeq.main([str(meas), "-n", "4", "--maxiter", "30", "--device", "cpu",
                      "--apo", out["apo"], "--rme", out["rme"], "--aupreset", out["aupreset"]])
    assert rc == 0
    result = json.loads(capsys.readouterr().out)
    assert set(result) == {"rms_error_db", "filters"} and len(result["filters"]) == 4
    assert set(result["filters"][0]) == {"type", "freq", "q", "gain_db"}
    apo = open(out["apo"]).read().splitlines()
    assert apo[0] == "# mathaudio_tpu autoeq" and apo[1].startswith("Preamp: ")
    assert sum(line.startswith("Filter ") for line in apo) == 4
    import plistlib
    import xml.etree.ElementTree as ET

    ET.parse(out["rme"])
    with open(out["aupreset"], "rb") as fh:
        assert plistlib.load(fh)["numberOfBands"] == 4


def test_package_exports():
    names = [n for n in dir(joptim) if not n.startswith("_") and n != "annotations"]
    assert not [n for n in names if not hasattr(optim, n)]


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["best1bin", "rand1exp", "adaptivebin"])
def test_de_on_the_card_reaches_what_the_cpu_does(cuda_device, strategy):
    kw = dict(maxiter=600, seed=3, tol=0.0, strategy=strategy)
    card = de.differential_evolution(_rosenbrock, [(-2.0, 2.0)] * 4, device=cuda_device, **kw)
    again = de.differential_evolution(_rosenbrock, [(-2.0, 2.0)] * 4, device=cuda_device, **kw)
    cpu = de.differential_evolution(_rosenbrock, [(-2.0, 2.0)] * 4, device=CPU, **kw)
    np.testing.assert_array_equal(card.population, again.population)
    for r in (card, cpu):
        assert r.fun <= 1e-8 and np.abs(r.x - 1.0).max() <= 1e-3
