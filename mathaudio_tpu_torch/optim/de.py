"""Differential evolution (counterpart of mathaudio_tpu/optim/de.py;
math-differential-evolution/src/mod.rs).

Semantics follow the reference: SciPy-style deferred updating, 14
strategies (mod.rs:139-168), binomial/exponential crossover, mutation
Factor/Range-dither/Adaptive (mod.rs:216), LHS/random init (mod.rs:260),
penalty constraints base + w*viol^2 (mod.rs:1052-1077), fixed-variable
elimination and npop = popsize * n_free (mod.rs:914-1000), convergence
std(E) <= atol + tol*|mean(E)| , JADE-style adaptation (mod.rs:479),
optional local polish (scipy Nelder-Mead replacing the reference's
NLopt, mod.rs:521).

The population is a float64 tensor on the device, and the objective is
evaluated over it at once with ``torch.func.vmap`` (the reference's
``jax.vmap``). Random numbers come from one ``torch.Generator`` on the
population's device, seeded from ``cfg.seed``: a run is reproducible on
one device, and the card's stream differs from the CPU's and from
``jax.random``'s. ``jit_loop=True`` keeps the reference's semantics (no
per-generation callback or disp, the while-loop's stopping rule, success
re-tested on the final population); nothing is compiled.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

import torch

from mathaudio_tpu_torch.xtypes import resolve_device


class Strategy(enum.Enum):
    BEST1BIN = "best1bin"
    BEST1EXP = "best1exp"
    RAND1BIN = "rand1bin"
    RAND1EXP = "rand1exp"
    RAND2BIN = "rand2bin"
    RAND2EXP = "rand2exp"
    CURRENTTOBEST1BIN = "currenttobest1bin"
    CURRENTTOBEST1EXP = "currenttobest1exp"
    BEST2BIN = "best2bin"
    BEST2EXP = "best2exp"
    RANDTOBEST1BIN = "randtobest1bin"
    RANDTOBEST1EXP = "randtobest1exp"
    ADAPTIVEBIN = "adaptivebin"
    ADAPTIVEEXP = "adaptiveexp"

    @classmethod
    def from_str(cls, s: str) -> "Strategy":
        t = s.lower().replace("_", "").replace("-", "")
        aliases = {"best1": "best1bin", "rand1": "rand1bin", "adaptive": "adaptivebin"}
        t = aliases.get(t, t)
        for m in cls:
            if m.value == t:
                return m
        raise ValueError(f"unknown strategy {s}")

    @property
    def is_exponential(self) -> bool:
        return self.value.endswith("exp")

    @property
    def is_adaptive(self) -> bool:
        return self.value.startswith("adaptive")


@dataclasses.dataclass
class Mutation:
    """Factor / dither Range / Adaptive (mod.rs:216)."""

    kind: str = "range"  # "factor" | "range" | "adaptive"
    factor: float = 0.8
    min: float = 0.0
    max: float = 2.0
    initial_f: float = 0.5

    @classmethod
    def factor_of(cls, f: float) -> "Mutation":
        return cls(kind="factor", factor=f)

    @classmethod
    def range_of(cls, lo: float, hi: float) -> "Mutation":
        return cls(kind="range", min=lo, max=hi)

    @classmethod
    def adaptive_of(cls, initial_f: float = 0.5) -> "Mutation":
        return cls(kind="adaptive", initial_f=initial_f)


class Init(enum.Enum):
    LATIN_HYPERCUBE = "latinhypercube"
    RANDOM = "random"


class Crossover(enum.Enum):
    BINOMIAL = "binomial"
    EXPONENTIAL = "exponential"


@dataclasses.dataclass
class LinearPenalty:
    """lb <= A x <= ub with quadratic penalty (mod.rs:278)."""

    a: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    weight: float = 1e6


@dataclasses.dataclass
class LinearConstraintHelper:
    a: np.ndarray
    lb: np.ndarray
    ub: np.ndarray

    def apply_to(self, cfg: "DEConfig", weight: float = 1e6):
        lp = LinearPenalty(np.asarray(self.a), np.asarray(self.lb), np.asarray(self.ub), weight)
        if cfg.linear_penalty is None:
            cfg.linear_penalty = lp
        else:
            ex = cfg.linear_penalty
            cfg.linear_penalty = LinearPenalty(
                np.vstack([ex.a, lp.a]),
                np.concatenate([ex.lb, lp.lb]),
                np.concatenate([ex.ub, lp.ub]),
                ex.weight,
            )


@dataclasses.dataclass
class NonlinearConstraintHelper:
    """lb <= fun(x) <= ub, applied as penalty closures (mod.rs:320)."""

    fun: Callable
    lb: np.ndarray
    ub: np.ndarray

    def apply_to(self, cfg: "DEConfig", weight_ineq: float = 1e6, weight_eq: float = 1e6):
        lb, ub = np.asarray(self.lb), np.asarray(self.ub)
        f = self.fun
        for i in range(min(len(lb), len(ub))):
            l, u = lb[i], ub[i]
            if l == u:
                cfg.penalty_eq.append((lambda x, i=i, l=l: f(x)[i] - l, weight_eq))
            else:
                if np.isfinite(u):
                    cfg.penalty_ineq.append((lambda x, i=i, u=u: f(x)[i] - u, weight_ineq))
                if np.isfinite(l):
                    cfg.penalty_ineq.append((lambda x, i=i, l=l: l - f(x)[i], weight_ineq))


@dataclasses.dataclass
class AdaptiveConfig:
    """JADE/SAM-style adaptation (mod.rs:479)."""

    adaptive_mutation: bool = False
    wls_enabled: bool = False
    w_max: float = 0.9
    w_min: float = 0.1
    w_f: float = 0.9
    w_cr: float = 0.9
    f_m: float = 0.5
    cr_m: float = 0.6
    wls_prob: float = 0.1
    wls_scale: float = 0.1


@dataclasses.dataclass
class PolishConfig:
    enabled: bool = True
    algo: str = "neldermead"
    maxeval: int = 0  # 0 -> 200 * n


@dataclasses.dataclass
class DEConfig:
    maxiter: int = 1000
    popsize: int = 15
    tol: float = 1e-2
    atol: float = 0.0
    mutation: Mutation = dataclasses.field(default_factory=Mutation)
    recombination: float = 0.7
    strategy: Strategy = Strategy.BEST1BIN
    init: Init = Init.LATIN_HYPERCUBE
    seed: Optional[int] = None
    integrality: Optional[Sequence[bool]] = None
    x0: Optional[Sequence[float]] = None
    disp: bool = False
    callback: Optional[Callable] = None
    penalty_ineq: List[Tuple[Callable, float]] = dataclasses.field(default_factory=list)
    penalty_eq: List[Tuple[Callable, float]] = dataclasses.field(default_factory=list)
    linear_penalty: Optional[LinearPenalty] = None
    polish: Optional[PolishConfig] = None
    adaptive: AdaptiveConfig = dataclasses.field(default_factory=AdaptiveConfig)


class DEConfigBuilder:
    """Fluent builder (mod.rs:624 DEConfigBuilder)."""

    def __init__(self):
        self.cfg = DEConfig()

    def __getattr__(self, name):
        # Reject unknown config fields at attribute access, not at call
        # time, so a typo like .maxitr(5) fails on the lookup itself.
        if not hasattr(self.cfg, name):
            raise AttributeError(name)

        def setter(value):
            setattr(self.cfg, name, value)
            return self

        return setter

    def build(self) -> DEConfig:
        return self.cfg


@dataclasses.dataclass
class DEReport:
    x: np.ndarray
    fun: float
    success: bool
    message: str
    nit: int
    nfev: int
    population: np.ndarray
    population_energies: np.ndarray


@dataclasses.dataclass
class DEIntermediate:
    x: np.ndarray
    fun: float
    convergence: float
    iter: int


class CallbackAction(enum.Enum):
    CONTINUE = 0
    STOP = 1


_F64 = torch.float64


def _uniform(key, shape, lo=0.0, hi=1.0):
    """Uniform float64 draws in [lo, hi) from the generator ``key``."""
    u = torch.rand(shape, generator=key, device=key.device, dtype=_F64)
    return u if (lo, hi) == (0.0, 1.0) else lo + u * (hi - lo)


def _latin_hypercube(key, npop, n, lb, ub):
    """One sample per 1/npop stratum in every dimension; ``key`` is a
    ``torch.Generator`` on the population's device."""
    perm = torch.argsort(_uniform(key, (n, npop)), dim=1).T
    unit = (perm + _uniform(key, (npop, n))) / npop
    return lb + unit * (ub - lb)


def _distinct_indices(key, npop, k):
    """(npop, k) indices, distinct in each row and never the row's own."""
    if k > npop - 1:
        raise ValueError(f"the strategy needs {k} distinct members besides each one; "
                         f"the population has {npop}")
    r = torch.argsort(_uniform(key, (npop, npop - 1)), dim=1)[:, :k]
    i = torch.arange(npop, device=key.device)[:, None]
    return torch.where(r >= i, r + 1, r)


def _crossover_mask_bin(key, npop, n, cr):
    u = _uniform(key, (npop, n))
    j_rand = torch.randint(0, n, (npop,), generator=key, device=key.device)
    mask = u < cr
    mask[torch.arange(npop, device=key.device), j_rand] = True
    return mask


def _crossover_mask_exp(key, npop, n, cr):
    dev = key.device
    starts = torch.randint(0, n, (npop,), generator=key, device=dev)
    u = _uniform(key, (npop, n))
    cr_arr = torch.as_tensor(cr, dtype=_F64, device=dev).expand(npop)
    cont = torch.cat([torch.ones((npop, 1), dtype=torch.bool, device=dev),
                      u[:, 1:] < cr_arr[:, None]], dim=1)
    keep = torch.cumprod(cont.to(torch.int64), dim=1) > 0  # offsets kept
    dims = (starts[:, None] + torch.arange(n, device=dev)[None, :]) % n
    return torch.zeros((npop, n), dtype=torch.bool, device=dev).scatter(1, dims, keep)


def _mutant(strategy, pop, best, idx, f):
    r = lambda j: pop[idx[:, j]]
    s = strategy.value
    if s.startswith("best1"):
        return best[None] + f * (r(0) - r(1))
    if s.startswith("rand1"):
        return r(0) + f * (r(1) - r(2))
    if s.startswith("rand2"):
        return r(0) + f * (r(1) + r(2) - r(3) - r(4))
    if s.startswith("best2"):
        return best[None] + f * (r(0) + r(1) - r(2) - r(3))
    if s.startswith("currenttobest1") or s.startswith("adaptive"):
        return pop + f * (best[None] - pop) + f * (r(0) - r(1))
    if s.startswith("randtobest1"):
        return r(0) + f * (best[None] - r(0)) + f * (r(1) - r(2))
    raise ValueError(s)


def _make_energy(func, cfg: DEConfig, *, device=None):
    """The objective plus the configured penalties, for one float64 point
    x on ``device``; ``torch.func.vmap`` batches it over a population."""
    lp = cfg.linear_penalty
    lp_arrs = None
    if lp is not None:
        lp_arrs = tuple(torch.as_tensor(np.asarray(t, float), dtype=_F64,
                                        device=resolve_device(device)) for t in (lp.a, lp.lb, lp.ub))
    ineq = list(cfg.penalty_ineq)
    eq = list(cfg.penalty_eq)

    def energy(x):
        e = func(x)
        for g, w in ineq:
            v = torch.clamp_min(g(x), 0.0)
            e = e + w * v * v
        for h, w in eq:
            v = h(x)
            e = e + w * v * v
        if lp_arrs is not None:
            a, lb, ub = lp_arrs
            ax = a @ x
            lo = torch.clamp_min(lb - ax, 0.0)
            hi = torch.clamp_min(ax - ub, 0.0)
            e = e + lp.weight * torch.sum(lo * lo + hi * hi)
        return e

    return energy


def _row(t, i):
    """Row ``i`` (a 0-d index tensor) of ``t`` without a host sync."""
    return t[i.reshape(1)][0]


def differential_evolution(
    func: Callable,
    bounds: Sequence[Tuple[float, float]],
    config: Optional[DEConfig] = None,
    jit_loop: bool = False,
    *,
    device=None,
    **kwargs,
) -> DEReport:
    """SciPy-style DE on an objective of one float64 tensor x that
    ``torch.func.vmap`` can batch (torch operations, no host reads).

    ``jit_loop=True`` runs the generation loop without per-generation
    hooks (no callback/disp) and stops on the reference's while-loop
    condition; otherwise callback and disp run every generation. The
    population lives on ``device`` (the GPU unless ``device="cpu"``)."""
    cfg = config or DEConfig()
    for k, v in kwargs.items():
        if not hasattr(cfg, k):
            raise TypeError(f"unknown config field {k}")
        setattr(cfg, k, v)
    if jit_loop and (cfg.callback is not None or cfg.disp):
        import warnings

        warnings.warn(
            "jit_loop=True runs the generation loop without host hooks: callback/disp are "
            "ignored; use jit_loop=False for per-generation hooks",
            stacklevel=2,
        )
    if isinstance(cfg.strategy, str):
        cfg.strategy = Strategy.from_str(cfg.strategy)
    dev = resolve_device(device)

    bounds = np.asarray(bounds, float)
    lb_full, ub_full = bounds[:, 0], bounds[:, 1]
    n_full = len(bounds)

    # Fixed-variable elimination (mod.rs:934-960)
    free = lb_full < ub_full
    n_free = int(free.sum())
    fixed_vals = torch.as_tensor(lb_full, dtype=_F64, device=dev)
    free_mask = torch.as_tensor(free, device=dev)
    free_pos = torch.as_tensor(np.maximum(np.cumsum(free) - 1, 0), device=dev)

    def expand(xf):
        return torch.where(free_mask, xf[..., free_pos], fixed_vals)

    raw_energy = _make_energy(func, cfg, device=dev)
    energy = lambda xf: raw_energy(expand(xf))

    if n_free == 0:
        f = float(raw_energy(fixed_vals))
        x = fixed_vals.cpu().numpy()
        return DEReport(x, f, True, "all variables fixed", 0, 1, x[None], np.asarray([f]))

    lb = torch.as_tensor(lb_full[free], dtype=_F64, device=dev)
    ub = torch.as_tensor(ub_full[free], dtype=_F64, device=dev)
    npop = max(cfg.popsize * n_free, 5)
    n = n_free

    integrality = None
    if cfg.integrality is not None:
        integrality = torch.as_tensor(np.asarray(cfg.integrality, bool)[free], device=dev)

    key = torch.Generator(device=dev)
    key.manual_seed(cfg.seed if cfg.seed is not None else 0)
    if cfg.init == Init.LATIN_HYPERCUBE:
        pop = _latin_hypercube(key, npop, n, lb, ub)
    else:
        pop = lb + _uniform(key, (npop, n)) * (ub - lb)
    if cfg.x0 is not None:
        pop[0] = torch.as_tensor(np.asarray(cfg.x0, float)[free], dtype=_F64, device=dev)
    if integrality is not None:
        pop = torch.where(integrality[None, :], torch.round(pop), pop)
        pop = torch.clamp(pop, lb, ub)

    venergy = torch.func.vmap(energy)
    energies = venergy(pop)
    nfev = npop

    strategy = cfg.strategy
    use_exp = strategy.is_exponential
    n_diff = {"best1": 2, "rand1": 3, "rand2": 5, "best2": 4,
              "currenttobest1": 2, "randtobest1": 3, "adaptive": 2}
    base = next(p for p in n_diff if strategy.value.startswith(p))
    k_idx = n_diff[base]

    mut = cfg.mutation
    adaptive_on = strategy.is_adaptive or mut.kind == "adaptive" or cfg.adaptive.adaptive_mutation
    ac = cfg.adaptive

    def gen_step(pop, energies, f_m, cr_m):
        best = _row(pop, torch.argmin(energies))

        if adaptive_on:
            # per-individual F ~ Cauchy(f_m, 0.1), CR ~ N(cr_m, 0.1)
            u = _uniform(key, (npop, 1), 1e-6, 1 - 1e-6)
            f = f_m + 0.1 * torch.tan(np.pi * (u - 0.5))
            f = torch.clamp(f, 0.05, 1.5)
            normal = torch.randn((npop,), generator=key, device=dev, dtype=_F64)
            cr_i = torch.clamp(cr_m + 0.1 * normal, 0.0, 1.0)
        elif mut.kind == "factor":
            f = torch.tensor(mut.factor, dtype=_F64, device=dev)
            cr_i = torch.full((npop,), cfg.recombination, dtype=_F64, device=dev)
        else:  # dither once per generation (scipy semantics)
            f = _uniform(key, (), mut.min, mut.max)
            cr_i = torch.full((npop,), cfg.recombination, dtype=_F64, device=dev)

        idx = _distinct_indices(key, npop, k_idx)
        mutant = _mutant(strategy, pop, best, idx, f)
        mutant = torch.clamp(mutant, lb, ub)

        if use_exp:
            mask = _crossover_mask_exp(key, npop, n, cr_i)
        else:
            mask = _crossover_mask_bin(key, npop, n, cr_i[:, None])
        trial = torch.where(mask, mutant, pop)
        if integrality is not None:
            trial = torch.where(integrality[None, :], torch.round(trial), trial)
            trial = torch.clamp(trial, lb, ub)

        trial_e = venergy(trial)
        improved = trial_e < energies
        pop_new = torch.where(improved[:, None], trial, pop)
        e_new = torch.where(improved, trial_e, energies)

        if ac.wls_enabled:
            # Wrapper Local Search (mod.rs:479 / apply_wls): Cauchy-perturb
            # the current best; replace the worst member on improvement.
            best_new = _row(pop_new, torch.argmin(e_new))
            u_w = _uniform(key, (n,), 1e-6, 1 - 1e-6)
            step_w = ac.wls_scale * (ub - lb) * torch.tan(np.pi * (u_w - 0.5))
            cand = torch.clamp(best_new + step_w, lb, ub)
            if integrality is not None:
                cand = torch.clamp(torch.where(integrality, torch.round(cand), cand), lb, ub)
            cand_e = energy(cand)
            do_wls = _uniform(key, ()) < ac.wls_prob
            worst = torch.argmax(e_new).reshape(1)
            accept = do_wls & (cand_e < e_new[worst][0])
            pop_new = torch.where(accept, pop_new.index_copy(0, worst, cand[None]), pop_new)
            e_new = torch.where(accept, e_new.index_copy(0, worst, cand_e.reshape(1)), e_new)

        if adaptive_on:
            # JADE-style location update from successful parameters
            sf = torch.where(improved[:, None], f * torch.ones((npop, 1), dtype=_F64, device=dev),
                             0.0).squeeze(-1)
            n_improved = torch.sum(improved)
            s_cnt = torch.clamp_min(n_improved, 1)
            lehmer = torch.sum(sf * sf) / torch.clamp_min(torch.sum(sf), 1e-12)
            f_m_new = torch.where(n_improved > 0, ac.w_f * f_m + (1 - ac.w_f) * lehmer, f_m)
            scr = torch.sum(torch.where(improved, cr_i, 0.0)) / s_cnt
            cr_m_new = torch.where(n_improved > 0, ac.w_cr * cr_m + (1 - ac.w_cr) * scr, cr_m)
        else:
            f_m_new, cr_m_new = f_m, cr_m
        return pop_new, e_new, f_m_new, cr_m_new, trial, trial_e

    f_m = torch.tensor(ac.f_m if adaptive_on else (mut.initial_f if mut.kind == "adaptive" else 0.5),
                       dtype=_F64, device=dev)
    cr_m = torch.tensor(ac.cr_m, dtype=_F64, device=dev)

    def converged(e_np):
        return e_np.std() <= cfg.atol + cfg.tol * abs(e_np.mean())

    message = "maximum iterations reached"
    success = False
    nit = 0

    if jit_loop:
        # the reference's while-loop: test, then step, until converged or maxiter
        while nit < cfg.maxiter and not converged(energies.cpu().numpy()):
            pop, energies, f_m, cr_m, _, _ = gen_step(pop, energies, f_m, cr_m)
            nit += 1
        nfev += nit * npop
        # Re-test the convergence predicate on the final population: a run
        # that converges exactly on its last allowed generation leaves the
        # loop with nit == maxiter and would read as failure if we
        # inferred success from the iteration count alone.
        success = bool(converged(energies.cpu().numpy()))
        if success:
            message = "converged (population std within tolerance)"
    else:
        for it in range(1, cfg.maxiter + 1):
            pop, energies, f_m, cr_m, _, _ = gen_step(pop, energies, f_m, cr_m)
            nfev += npop
            nit = it
            e_np = energies.cpu().numpy()
            best_i = int(e_np.argmin())
            conv = float(e_np.std())
            if cfg.disp:
                print(f"differential_evolution step {it}: f(x)= {e_np[best_i]:.6g}")
            if cfg.callback is not None:
                inter = DEIntermediate(
                    expand(pop[best_i]).cpu().numpy(), float(e_np[best_i]), conv, it
                )
                if cfg.callback(inter) == CallbackAction.STOP:
                    message = "callback requested stop"
                    break
            if converged(e_np):
                success = True
                message = "converged (population std within tolerance)"
                break

    e_np = energies.cpu().numpy()
    best_i = int(e_np.argmin())
    x_best = expand(pop[best_i]).cpu().numpy()
    f_best = float(e_np[best_i])

    if cfg.polish is not None and cfg.polish.enabled:
        from scipy import optimize as sciopt

        maxeval = cfg.polish.maxeval or 200 * n_full
        res = sciopt.minimize(
            lambda x: float(raw_energy(torch.as_tensor(x, dtype=_F64, device=dev))),
            x_best,
            method="Nelder-Mead",
            bounds=[(lb_full[i], ub_full[i]) for i in range(n_full)],
            options={"maxfev": maxeval, "xatol": 1e-10, "fatol": 1e-12},
        )
        nfev += res.nfev
        if res.fun < f_best:
            x_best, f_best = np.asarray(res.x), float(res.fun)

    pop_full = expand(pop).cpu().numpy()
    return DEReport(
        x=x_best,
        fun=f_best,
        success=success,
        message=message,
        nit=nit,
        nfev=nfev,
        population=pop_full,
        population_energies=e_np,
    )
