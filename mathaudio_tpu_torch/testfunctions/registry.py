"""Function registry + metadata (counterpart of
mathaudio_tpu/testfunctions/registry.py;
math-test-functions/src/lib.rs:14-40 FunctionMetadata + registry).

Bounds/minima are the standard literature values; ``dimensions`` is the
list of admissible dimensionalities (empty = any n). Constrained
problems reference their companion constraint functions (g(x) <= 0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from mathaudio_tpu_torch.testfunctions import functions as F

PI = math.pi


@dataclasses.dataclass
class FunctionMetadata:
    name: str
    bounds: List[Tuple[float, float]]
    global_minima: List[Tuple[List[float], float]]
    inequality_constraints: List[Callable] = dataclasses.field(default_factory=list)
    equality_constraints: List[Callable] = dataclasses.field(default_factory=list)
    description: str = ""
    multimodal: bool = False
    dimensions: List[int] = dataclasses.field(default_factory=list)


def _m(name, bounds, minima, multimodal=False, dims=(), ineq=(), desc=""):
    return FunctionMetadata(
        name=name,
        bounds=list(bounds),
        global_minima=[(list(x), f) for x, f in minima],
        inequality_constraints=list(ineq),
        multimodal=multimodal,
        dimensions=list(dims),
        description=desc,
    )


def _sym(b, n=2):
    return [(-b, b)] * n


_H3_XSTAR = [0.114614, 0.555649, 0.852547]
_H6_XSTAR = [0.20169, 0.150011, 0.476874, 0.275332, 0.311652, 0.6573]

REGISTRY: Dict[str, Tuple[Callable, FunctionMetadata]] = {}


def _reg(fn, meta: FunctionMetadata):
    REGISTRY[meta.name] = (fn, meta)


# --- unimodal / bowl-shaped ------------------------------------------------
_reg(F.sphere, _m("sphere", _sym(5.12), [([0.0, 0.0], 0.0)]))
_reg(F.quadratic, _m("quadratic", _sym(10), [([0.0, 0.0], 0.0)]))
_reg(F.sum_squares, _m("sum_squares", _sym(10), [([0.0, 0.0], 0.0)]))
_reg(
    F.rotated_hyper_ellipsoid,
    _m("rotated_hyper_ellipsoid", _sym(65.536), [([0.0, 0.0], 0.0)]),
)
_reg(F.schwefel2, _m("schwefel2", _sym(100), [([0.0, 0.0], 0.0)]))
_reg(F.cigar, _m("cigar", _sym(100), [([0.0, 0.0], 0.0)]))
_reg(F.bent_cigar, _m("bent_cigar", _sym(100), [([0.0, 0.0], 0.0)]))
_reg(F.bent_cigar_alt, _m("bent_cigar_alt", _sym(100), [([0.0, 0.0], 0.0)]))
_reg(F.tablet, _m("tablet", _sym(100), [([0.0, 0.0], 0.0)]))
_reg(F.discus, _m("discus", _sym(100), [([0.0, 0.0], 0.0)]))
_reg(F.elliptic, _m("elliptic", _sym(100), [([0.0, 0.0], 0.0)]))
_reg(F.sharp_ridge, _m("sharp_ridge", _sym(100), [([0.0, 0.0], 0.0)]))
_reg(
    F.ridge,
    _m("ridge", [(-5.0, 5.0)] * 2, [([-5.0, 0.0], -5.0)], desc="min at x0 lower bound"),
)
_reg(F.brown, _m("brown", [(-1.0, 4.0)] * 2, [([0.0, 0.0], 0.0)]))
_reg(F.chung_reynolds, _m("chung_reynolds", _sym(100), [([0.0, 0.0], 0.0)]))
_reg(F.quartic, _m("quartic", _sym(1.28), [([0.0, 0.0], 0.0)]))
_reg(F.step, _m("step", _sym(100), [([0.0, 0.0], 0.0)]))
_reg(F.de_jong_step2, _m("de_jong_step2", _sym(100), [([0.0, 0.0], 0.0)]))
_reg(F.sum_of_different_pow, _m("sum_of_different_pow", _sym(1), [([0.0, 0.0], 0.0)]))
_reg(F.different_pow, _m("different_pow", _sym(1), [([0.0, 0.0], 0.0)]))
_reg(F.zakharov, _m("zakharov", [(-5.0, 10.0)] * 2, [([0.0, 0.0], 0.0)]))
_reg(F.zakharov2, _m("zakharov2", [(-5.0, 10.0)] * 2, [([0.0, 0.0], 0.0)]))
_reg(
    F.trid,
    _m("trid", [(-4.0, 4.0)] * 2, [([2.0, 2.0], -2.0)], dims=[2], desc="2-D: f* = -2 at (2,2)"),
)
_reg(F.dixons_price, _m("dixons_price", _sym(10), [([1.0, 1.0 / math.sqrt(2.0)], 0.0)], dims=[2]))
_reg(F.powell, _m("powell", [(-4.0, 5.0)] * 4, [([0.0] * 4, 0.0)], dims=[4, 8, 12]))
_reg(F.rosenbrock, _m("rosenbrock", _sym(5), [([1.0, 1.0], 0.0)]))
_reg(F.booth, _m("booth", _sym(10), [([1.0, 3.0], 0.0)], dims=[2]))
_reg(F.matyas, _m("matyas", _sym(10), [([0.0, 0.0], 0.0)], dims=[2]))
_reg(F.beale, _m("beale", _sym(4.5), [([3.0, 0.5], 0.0)], dims=[2]))
_reg(F.colville, _m("colville", _sym(10, 4), [([1.0] * 4, 0.0)], dims=[4]))
_reg(
    F.freudenstein_roth,
    _m("freudenstein_roth", _sym(10), [([5.0, 4.0], 0.0)], dims=[2], multimodal=True),
)
_reg(F.power_sum, _m("power_sum", [(0.0, 4.0)] * 4, [([1.0, 2.0, 2.0, 3.0], 0.0)], dims=[4]))
_reg(F.perm_d_beta, _m("perm_d_beta", _sym(2), [([1.0, 2.0], 0.0)], dims=[2]))
_reg(F.perm_0_d_beta, _m("perm_0_d_beta", _sym(2), [([1.0, 0.5], 0.0)], dims=[2]))

# --- multimodal -------------------------------------------------------------
_reg(F.ackley, _m("ackley", _sym(32.768), [([0.0, 0.0], 0.0)], multimodal=True))
_reg(
    F.ackley_n2,
    _m("ackley_n2", _sym(32), [([0.0, 0.0], -200.0)], dims=[2], multimodal=False),
)
_reg(
    F.ackley_n3,
    _m(
        "ackley_n3",
        _sym(32),
        [([0.6826013, -0.36067291], -195.62902825253437)],
        dims=[2],
        multimodal=True,
    ),
)
_reg(F.alpine_n1, _m("alpine_n1", [(0.0, 10.0)] * 2, [([0.0, 0.0], 0.0)], multimodal=True))
_reg(
    F.alpine_n2,
    _m("alpine_n2", [(0.0, 10.0)] * 2, [([7.917, 7.917], -2.808**2)], multimodal=True,
       desc="f* = -2.808^n"),
)
_reg(F.rastrigin, _m("rastrigin", _sym(5.12), [([0.0, 0.0], 0.0)], multimodal=True))
_reg(F.griewank, _m("griewank", _sym(600), [([0.0, 0.0], 0.0)], multimodal=True))
_reg(F.griewank2, _m("griewank2", _sym(600), [([0.0, 0.0], 0.0)], multimodal=True))
_reg(
    F.schwefel,
    _m("schwefel", _sym(500), [([420.9687, 420.9687], 0.0)], multimodal=True),
)
_reg(F.levy, _m("levy", _sym(10), [([1.0, 1.0], 0.0)], multimodal=True))
_reg(F.levy_n13, _m("levy_n13", _sym(10), [([1.0, 1.0], 0.0)], dims=[2], multimodal=True))
_reg(F.levi13, _m("levi13", _sym(10), [([1.0, 1.0], 0.0)], dims=[2], multimodal=True))
_reg(
    F.michalewicz,
    _m("michalewicz", [(0.0, PI)] * 2, [([2.20, 1.57], -1.8013)], dims=[2], multimodal=True),
)
_reg(
    F.epistatic_michalewicz,
    _m("epistatic_michalewicz", [(0.0, PI)] * 2, [([0.0, 0.0], float("nan"))], dims=[2],
       multimodal=True, desc="minimum location nontrivial; value checked by search"),
)
_reg(
    F.branin,
    _m("branin", [(-5.0, 10.0), (0.0, 15.0)], [([PI, 2.275], 0.39788735772973816)],
       dims=[2], multimodal=True),
)
_reg(
    F.goldstein_price,
    _m("goldstein_price", _sym(2), [([0.0, -1.0], 3.0)], dims=[2], multimodal=True),
)
_reg(
    F.six_hump_camel,
    _m("six_hump_camel", [(-3.0, 3.0), (-2.0, 2.0)],
       [([0.0898, -0.7126], -1.0316), ([-0.0898, 0.7126], -1.0316)], dims=[2], multimodal=True),
)
_reg(
    F.three_hump_camel,
    _m("three_hump_camel", _sym(5), [([0.0, 0.0], 0.0)], dims=[2], multimodal=True),
)
_reg(F.easom, _m("easom", _sym(100), [([PI, PI], -1.0)], dims=[2], multimodal=True))
_reg(
    F.eggholder,
    _m("eggholder", _sym(512), [([512.0, 404.2319], -959.6407)], dims=[2], multimodal=True),
)
_reg(
    F.himmelblau,
    _m("himmelblau", _sym(5),
       [([3.0, 2.0], 0.0), ([-2.805118, 3.131312], 0.0),
        ([-3.779310, -3.283186], 0.0), ([3.584428, -1.848126], 0.0)],
       dims=[2], multimodal=True),
)
_reg(
    F.holder_table,
    _m("holder_table", _sym(10), [([8.05502, 9.66459], -19.2085)], dims=[2], multimodal=True),
)
_reg(
    F.cross_in_tray,
    _m("cross_in_tray", _sym(10), [([1.34941, 1.34941], -2.06261)], dims=[2], multimodal=True),
)
_reg(F.drop_wave, _m("drop_wave", _sym(5.12), [([0.0, 0.0], -1.0)], dims=[2], multimodal=True))
_reg(F.bohachevsky1, _m("bohachevsky1", _sym(100), [([0.0, 0.0], 0.0)], dims=[2], multimodal=True))
_reg(F.bohachevsky2, _m("bohachevsky2", _sym(100), [([0.0, 0.0], 0.0)], dims=[2], multimodal=True))
_reg(F.bohachevsky3, _m("bohachevsky3", _sym(100), [([0.0, 0.0], 0.0)], dims=[2], multimodal=True))
_reg(F.schaffer_n2, _m("schaffer_n2", _sym(100), [([0.0, 0.0], 0.0)], dims=[2], multimodal=True))
_reg(
    F.schaffer_n4,
    _m("schaffer_n4", _sym(100), [([0.0, 1.253115], 0.292579)], dims=[2], multimodal=True),
)
_reg(
    F.shubert,
    _m("shubert", _sym(10), [([-7.0835, 4.8580], -186.7309)], dims=[2], multimodal=True),
)
_reg(
    F.styblinski_tang2,
    _m("styblinski_tang2", _sym(5), [([-2.903534, -2.903534], -78.33233)], multimodal=True),
)
_reg(
    F.mccormick,
    _m("mccormick", [(-1.5, 4.0), (-3.0, 4.0)], [([-0.54719, -1.54719], -1.9133)],
       dims=[2], multimodal=True),
)
_reg(
    F.bukin_n6,
    _m("bukin_n6", [(-15.0, -5.0), (-3.0, 3.0)], [([-10.0, 1.0], 0.0)], dims=[2], multimodal=True),
)
_reg(
    F.bird,
    _m("bird", _sym(2 * PI), [([4.70104, 3.15294], -106.764537)], dims=[2], multimodal=True),
)
_reg(F.salomon, _m("salomon", _sym(100), [([0.0, 0.0], 0.0)], multimodal=True))
_reg(F.salomon_corrected, _m("salomon_corrected", _sym(100), [([0.0, 0.0], 0.0)], multimodal=True))
_reg(F.periodic, _m("periodic", _sym(10), [([0.0, 0.0], 0.9)], multimodal=True))
_reg(
    F.cosine_mixture,
    _m("cosine_mixture", _sym(1), [([0.0, 0.0], -0.2)], multimodal=True, desc="f* = -0.1 n"),
)
_reg(F.exponential, _m("exponential", _sym(1), [([0.0, 0.0], -1.0)], multimodal=False))
_reg(F.qing, _m("qing", _sym(500), [([1.0, math.sqrt(2.0)], 0.0)], multimodal=True))
_reg(F.katsuura, _m("katsuura", _sym(100), [([0.0, 0.0], 0.0)], multimodal=True))
_reg(F.whitley, _m("whitley", _sym(10.24), [([1.0, 1.0], 0.0)], multimodal=True))
_reg(
    F.vincent,
    _m("vincent", [(0.25, 10.0)] * 2, [([7.70628098, 7.70628098], -2.0)], multimodal=True,
       desc="f* = -n"),
)
_reg(F.pinter, _m("pinter", _sym(10), [([0.0, 0.0], 0.0)], multimodal=True))
_reg(F.xin_she_yang_n1, _m("xin_she_yang_n1", _sym(5), [([0.0, 0.0], 0.0)], multimodal=True))
_reg(F.xin_she_yang_n2, _m("xin_she_yang_n2", _sym(2 * PI), [([0.0, 0.0], 0.0)], multimodal=True))
_reg(
    F.xin_she_yang_n3,
    _m("xin_she_yang_n3", _sym(20), [([0.0, 0.0], -1.0)], multimodal=True),
)
_reg(
    F.xin_she_yang_n4,
    _m("xin_she_yang_n4", _sym(10), [([0.0, 0.0], -1.0)], multimodal=True),
)
_reg(F.happycat, _m("happycat", _sym(2), [([-1.0, -1.0], 0.0)], multimodal=True))
_reg(F.happy_cat, _m("happy_cat", _sym(2), [([-1.0, -1.0], 0.0)], multimodal=True))
_reg(
    F.expanded_griewank_rosenbrock,
    _m("expanded_griewank_rosenbrock", _sym(5), [([1.0, 1.0], 0.0)], multimodal=True),
)
_reg(
    F.forrester_2008,
    _m("forrester_2008", [(0.0, 1.0)], [([0.757249], -6.02074)], dims=[1], multimodal=True),
)
_reg(
    F.gramacy_lee_2012,
    _m("gramacy_lee_2012", [(0.5, 2.5)], [([0.548563444114526], -0.869011134989500)],
       dims=[1], multimodal=True),
)
_reg(
    F.gramacy_lee_function,
    _m("gramacy_lee_function", [(0.5, 2.5)], [([0.548563444114526], -0.869011134989500)],
       dims=[1], multimodal=True),
)
_reg(
    F.langermann,
    _m("langermann", [(0.0, 10.0)] * 2, [([2.00299219, 1.006096], -5.1621259)],
       dims=[2], multimodal=True),
)
_reg(
    F.dejong_f5_foxholes,
    _m("dejong_f5_foxholes", _sym(65.536), [([-32.0, -32.0], 0.998003838)],
       dims=[2], multimodal=True),
)
_reg(
    F.shekel,
    _m("shekel", [(0.0, 10.0)] * 4, [([4.0, 4.0, 4.0, 4.0], -10.5364)], dims=[4], multimodal=True),
)
_reg(
    F.hartman_3d,
    _m("hartman_3d", [(0.0, 1.0)] * 3, [(_H3_XSTAR, -3.86278)], dims=[3], multimodal=True),
)
_reg(
    F.hartman_6d,
    _m("hartman_6d", [(0.0, 1.0)] * 6, [(_H6_XSTAR, -3.32237)], dims=[6], multimodal=True),
)
_reg(
    F.hartman_4d,
    _m("hartman_4d", [(0.0, 1.0)] * 4,
       [([0.18739527, 0.19415153, 0.55791778, 0.26477962], -3.7298405844855935)],
       dims=[4], multimodal=True, desc="4-D slice of Hartmann-6 (first four columns)"),
)

# --- constrained family ------------------------------------------------------
_reg(
    F.binh_korn_weighted,
    _m("binh_korn_weighted", [(0.0, 5.0), (0.0, 3.0)], [([1.875, 1.875], float("nan"))],
       dims=[2], ineq=[F.binh_korn_constraint1, F.binh_korn_constraint2],
       desc="scalarized Binh-Korn with disk constraints"),
)
_reg(F.binh_korn_constraint1, _m("binh_korn_constraint1", [(0.0, 5.0), (0.0, 3.0)], []))
_reg(F.binh_korn_constraint2, _m("binh_korn_constraint2", [(0.0, 5.0), (0.0, 3.0)], []))
_reg(
    F.keanes_bump_objective,
    _m("keanes_bump_objective", [(0.0, 10.0)] * 2, [([1.60086, 0.468498], -0.364979)],
       dims=[2], multimodal=True,
       ineq=[F.keanes_bump_constraint1, F.keanes_bump_constraint2]),
)
_reg(F.keanes_bump_constraint1, _m("keanes_bump_constraint1", [(0.0, 10.0)] * 2, []))
_reg(F.keanes_bump_constraint2, _m("keanes_bump_constraint2", [(0.0, 10.0)] * 2, []))
_reg(
    F.mishras_bird_objective,
    _m("mishras_bird_objective", [(-10.0, 0.0), (-6.5, 0.0)],
       [([-3.1302468, -1.5821422], -106.7645367)], dims=[2], multimodal=True,
       ineq=[F.mishras_bird_constraint]),
)
_reg(F.mishras_bird_constraint, _m("mishras_bird_constraint", [(-10.0, 0.0), (-6.5, 0.0)], []))
_reg(
    F.rosenbrock_objective,
    _m("rosenbrock_objective", [(-1.5, 1.5)] * 2, [([1.0, 1.0], 0.0)], dims=[2],
       ineq=[F.rosenbrock_disk_constraint]),
)
_reg(F.rosenbrock_disk_constraint, _m("rosenbrock_disk_constraint", [(-1.5, 1.5)] * 2, []))
_reg(
    F.lampinen_simplified,
    _m("lampinen_simplified", [(0.0, 5.0)] * 6, [([2.5, 2.5, 2.5, 2.5, 5.0, 5.0], float("nan"))],
       desc="maximization-negated quadratic with linear tail"),
)

FUNCTIONS = REGISTRY


def list_functions() -> List[str]:
    return sorted(REGISTRY)


def get_function(name: str) -> Callable:
    return REGISTRY[name][0]


def get_function_metadata(name: Optional[str] = None):
    if name is None:
        return {k: v[1] for k, v in REGISTRY.items()}
    return REGISTRY[name][1]
