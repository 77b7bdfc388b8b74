"""Benchmark objective functions, pure torch (counterpart of
mathaudio_tpu/testfunctions/functions.py).

Standard formulas (Jamil & Yang 2013 survey, al-Roomi archive, SciPy /
CEC conventions), matching the reference suite's function set
(math-test-functions/src/functions/*.rs). Signature: f(x: (n,)) -> scalar,
for one float tensor x. Each function reads no value back to the host,
branches only on the static width ``x.shape[0]`` and never writes into x,
so ``torch.func.vmap`` batches it over a population on any device; table
constants are made on ``x.device`` in ``x.dtype``.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def _n(x):
    return x.shape[0]


def _i1(x):
    return torch.arange(1, x.shape[0] + 1, dtype=x.dtype, device=x.device)


def _const(values, x):
    return torch.tensor(values, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------- unimodal

def sphere(x):
    return torch.sum(x**2)


def sum_squares(x):
    return torch.sum(_i1(x) * x**2)


def rotated_hyper_ellipsoid(x):
    return torch.sum(torch.cumsum(x**2, 0))


def schwefel2(x):
    """Schwefel 1.2: sum of squared prefix sums."""
    return torch.sum(torch.cumsum(x, 0) ** 2)


def cigar(x):
    return x[0] ** 2 + 1e6 * torch.sum(x[1:] ** 2)


def bent_cigar(x):
    return x[0] ** 2 + 1e6 * torch.sum(x[1:] ** 2)


def bent_cigar_alt(x):
    return x[0] ** 2 + 1e6 * torch.sum(x[1:] ** 2)


def tablet(x):
    return 1e6 * x[0] ** 2 + torch.sum(x[1:] ** 2)


def discus(x):
    return 1e6 * x[0] ** 2 + torch.sum(x[1:] ** 2)


def elliptic(x):
    n = _n(x)
    i = torch.arange(n, dtype=x.dtype, device=x.device)
    expo = 6.0 * i / (n - 1) if n > 1 else torch.zeros_like(i)
    return torch.sum(10.0**expo * x**2)


def ridge(x):
    return x[0] + 2.0 * torch.sum(x[1:] ** 2) ** 0.5


def sharp_ridge(x):
    return x[0] ** 2 + 100.0 * torch.sqrt(torch.sum(x[1:] ** 2))


def brown(x):
    x2 = x**2
    a, b = x2[:-1], x2[1:]
    return torch.sum(a ** (b + 1.0) + b ** (a + 1.0))


def chung_reynolds(x):
    return torch.sum(x**2) ** 2


def quadratic(x):
    return torch.sum(x**2)


def quartic(x):
    """De Jong F4 without noise."""
    return torch.sum(_i1(x) * x**4)


def step(x):
    return torch.sum(torch.floor(x + 0.5) ** 2)


def de_jong_step2(x):
    return torch.sum(torch.floor(x + 0.5) ** 2)


def sum_of_different_pow(x):
    i = _i1(x)
    return torch.sum(torch.abs(x) ** (i + 1.0))


def different_pow(x):
    return sum_of_different_pow(x)


def zakharov(x):
    s1 = torch.sum(x**2)
    s2 = torch.sum(0.5 * _i1(x) * x)
    return s1 + s2**2 + s2**4


def zakharov2(x):
    return zakharov(x)


def trid(x):
    return torch.sum((x - 1.0) ** 2) - torch.sum(x[1:] * x[:-1])


def dixons_price(x):
    i = torch.arange(2, x.shape[0] + 1, dtype=x.dtype, device=x.device)
    return (x[0] - 1.0) ** 2 + torch.sum(i * (2.0 * x[1:] ** 2 - x[:-1]) ** 2)


def powell(x):
    """Powell singular function; dims multiple of 4."""
    x4 = x.reshape(-1, 4)
    a, b, c, d = x4[:, 0], x4[:, 1], x4[:, 2], x4[:, 3]
    return torch.sum(
        (a + 10 * b) ** 2 + 5 * (c - d) ** 2 + (b - 2 * c) ** 4 + 10 * (a - d) ** 4
    )


def rosenbrock(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def booth(x):
    return (x[0] + 2 * x[1] - 7) ** 2 + (2 * x[0] + x[1] - 5) ** 2


def matyas(x):
    return 0.26 * (x[0] ** 2 + x[1] ** 2) - 0.48 * x[0] * x[1]


def beale(x):
    a, b = x[0], x[1]
    return (
        (1.5 - a + a * b) ** 2
        + (2.25 - a + a * b**2) ** 2
        + (2.625 - a + a * b**3) ** 2
    )


def colville(x):
    a, b, c, d = x[0], x[1], x[2], x[3]
    return (
        100 * (a**2 - b) ** 2
        + (a - 1) ** 2
        + (c - 1) ** 2
        + 90 * (c**2 - d) ** 2
        + 10.1 * ((b - 1) ** 2 + (d - 1) ** 2)
        + 19.8 * (b - 1) * (d - 1)
    )


def freudenstein_roth(x):
    a, b = x[0], x[1]
    t1 = -13 + a + ((5 - b) * b - 2) * b
    t2 = -29 + a + ((b + 1) * b - 14) * b
    return t1**2 + t2**2


def power_sum(x):
    """Power sum with b = (8, 18, 44, 114), 4-D."""
    b = _const([8.0, 18.0, 44.0, 114.0], x)
    k = torch.arange(1, 5, dtype=x.dtype, device=x.device)
    inner = torch.sum(x[None, :] ** k[:, None], dim=1)
    return torch.sum((inner - b) ** 2)


def perm_d_beta(x, beta=0.5):
    i = _i1(x)
    j = _i1(x)
    inner = torch.sum(
        (j[None, :] ** i[:, None] + beta) * ((x[None, :] / j[None, :]) ** i[:, None] - 1.0),
        dim=1,
    )
    return torch.sum(inner**2)


def perm_0_d_beta(x, beta=10.0):
    i = _i1(x)
    j = _i1(x)
    inner = torch.sum(
        (j[None, :] + beta) * (x[None, :] ** i[:, None] - (1.0 / j[None, :]) ** i[:, None]),
        dim=1,
    )
    return torch.sum(inner**2)


# -------------------------------------------------------------- multimodal

def ackley(x):
    n = _n(x)
    s1 = torch.sum(x**2) / n
    s2 = torch.sum(torch.cos(2 * PI * x)) / n
    return -20.0 * torch.exp(-0.2 * torch.sqrt(s1)) - torch.exp(s2) + 20.0 + math.e


def ackley_n2(x):
    return -200.0 * torch.exp(-0.02 * torch.sqrt(x[0] ** 2 + x[1] ** 2))


def ackley_n3(x):
    r = torch.sqrt(x[0] ** 2 + x[1] ** 2)
    return -200.0 * torch.exp(-0.02 * r) + 5.0 * torch.exp(torch.cos(3 * x[0]) + torch.sin(3 * x[1]))


def alpine_n1(x):
    return torch.sum(torch.abs(x * torch.sin(x) + 0.1 * x))


def alpine_n2(x):
    """Maximization form negated: min f = -prod sqrt(x) sin(x)."""
    return -torch.prod(torch.sqrt(x) * torch.sin(x))


def rastrigin(x):
    return 10.0 * _n(x) + torch.sum(x**2 - 10.0 * torch.cos(2 * PI * x))


def griewank(x):
    i = _i1(x)
    return torch.sum(x**2) / 4000.0 - torch.prod(torch.cos(x / torch.sqrt(i))) + 1.0


def griewank2(x):
    return griewank(x)


def schwefel(x):
    """Schwefel 2.26: 418.9829 n - sum x sin(sqrt|x|)."""
    return 418.9829 * _n(x) - torch.sum(x * torch.sin(torch.sqrt(torch.abs(x))))


def levy(x):
    w = 1.0 + (x - 1.0) / 4.0
    t1 = torch.sin(PI * w[0]) ** 2
    t2 = torch.sum((w[:-1] - 1) ** 2 * (1 + 10 * torch.sin(PI * w[:-1] + 1) ** 2))
    t3 = (w[-1] - 1) ** 2 * (1 + torch.sin(2 * PI * w[-1]) ** 2)
    return t1 + t2 + t3


def levy_n13(x):
    a, b = x[0], x[1]
    return (
        torch.sin(3 * PI * a) ** 2
        + (a - 1) ** 2 * (1 + torch.sin(3 * PI * b) ** 2)
        + (b - 1) ** 2 * (1 + torch.sin(2 * PI * b) ** 2)
    )


def levi13(x):
    return levy_n13(x)


def michalewicz(x, m=10.0):
    i = _i1(x)
    return -torch.sum(torch.sin(x) * torch.sin(i * x**2 / PI) ** (2 * m))


def epistatic_michalewicz(x, m=10.0, theta=PI / 6):
    n = _n(x)
    idx = torch.arange(n, device=x.device)
    x_next = torch.cat([x[1:], x[:1]])
    y_odd = x * math.cos(theta) - x_next * math.sin(theta)
    y_even = x * math.sin(theta) + x_next * math.cos(theta)
    is_last = idx == n - 1
    is_odd_pos = (idx % 2 == 0) & ~is_last  # 1-based odd
    y = torch.where(is_last, x, torch.where(is_odd_pos, y_odd, y_even))
    i = _i1(x)
    return -torch.sum(torch.sin(y) * torch.sin(i * y**2 / PI) ** (2 * m))


def branin(x):
    a, b = x[0], x[1]
    return (
        (b - 5.1 / (4 * PI**2) * a**2 + 5.0 / PI * a - 6.0) ** 2
        + 10.0 * (1 - 1 / (8 * PI)) * torch.cos(a)
        + 10.0
    )


def goldstein_price(x):
    a, b = x[0], x[1]
    t1 = 1 + (a + b + 1) ** 2 * (19 - 14 * a + 3 * a**2 - 14 * b + 6 * a * b + 3 * b**2)
    t2 = 30 + (2 * a - 3 * b) ** 2 * (
        18 - 32 * a + 12 * a**2 + 48 * b - 36 * a * b + 27 * b**2
    )
    return t1 * t2


def six_hump_camel(x):
    a, b = x[0], x[1]
    return (4 - 2.1 * a**2 + a**4 / 3) * a**2 + a * b + (-4 + 4 * b**2) * b**2


def three_hump_camel(x):
    a, b = x[0], x[1]
    return 2 * a**2 - 1.05 * a**4 + a**6 / 6 + a * b + b**2


def easom(x):
    a, b = x[0], x[1]
    return -torch.cos(a) * torch.cos(b) * torch.exp(-((a - PI) ** 2 + (b - PI) ** 2))


def eggholder(x):
    a, b = x[0], x[1]
    return -(b + 47) * torch.sin(torch.sqrt(torch.abs(b + a / 2 + 47))) - a * torch.sin(
        torch.sqrt(torch.abs(a - (b + 47)))
    )


def himmelblau(x):
    a, b = x[0], x[1]
    return (a**2 + b - 11) ** 2 + (a + b**2 - 7) ** 2


def holder_table(x):
    a, b = x[0], x[1]
    return -torch.abs(
        torch.sin(a) * torch.cos(b) * torch.exp(torch.abs(1 - torch.sqrt(a**2 + b**2) / PI))
    )


def cross_in_tray(x):
    a, b = x[0], x[1]
    t = torch.abs(
        torch.sin(a) * torch.sin(b) * torch.exp(torch.abs(100 - torch.sqrt(a**2 + b**2) / PI))
    )
    return -0.0001 * (t + 1) ** 0.1


def drop_wave(x):
    r2 = x[0] ** 2 + x[1] ** 2
    return -(1 + torch.cos(12 * torch.sqrt(r2))) / (0.5 * r2 + 2)


def bohachevsky1(x):
    a, b = x[0], x[1]
    return a**2 + 2 * b**2 - 0.3 * torch.cos(3 * PI * a) - 0.4 * torch.cos(4 * PI * b) + 0.7


def bohachevsky2(x):
    a, b = x[0], x[1]
    return a**2 + 2 * b**2 - 0.3 * torch.cos(3 * PI * a) * torch.cos(4 * PI * b) + 0.3


def bohachevsky3(x):
    a, b = x[0], x[1]
    return a**2 + 2 * b**2 - 0.3 * torch.cos(3 * PI * a + 4 * PI * b) + 0.3


def schaffer_n2(x):
    a, b = x[0], x[1]
    num = torch.sin(a**2 - b**2) ** 2 - 0.5
    den = (1 + 0.001 * (a**2 + b**2)) ** 2
    return 0.5 + num / den


def schaffer_n4(x):
    a, b = x[0], x[1]
    num = torch.cos(torch.sin(torch.abs(a**2 - b**2))) ** 2 - 0.5
    den = (1 + 0.001 * (a**2 + b**2)) ** 2
    return 0.5 + num / den


def shubert(x):
    i = torch.arange(1.0, 6.0, dtype=x.dtype, device=x.device)
    s1 = torch.sum(i * torch.cos((i + 1) * x[0] + i))
    s2 = torch.sum(i * torch.cos((i + 1) * x[1] + i))
    return s1 * s2


def styblinski_tang2(x):
    return 0.5 * torch.sum(x**4 - 16 * x**2 + 5 * x)


def mccormick(x):
    a, b = x[0], x[1]
    return torch.sin(a + b) + (a - b) ** 2 - 1.5 * a + 2.5 * b + 1.0


def bukin_n6(x):
    a, b = x[0], x[1]
    return 100 * torch.sqrt(torch.abs(b - 0.01 * a**2)) + 0.01 * torch.abs(a + 10)


def bird(x):
    a, b = x[0], x[1]
    return (
        torch.sin(a) * torch.exp((1 - torch.cos(b)) ** 2)
        + torch.cos(b) * torch.exp((1 - torch.sin(a)) ** 2)
        + (a - b) ** 2
    )


def salomon(x):
    r = torch.sqrt(torch.sum(x**2))
    return 1.0 - torch.cos(2 * PI * r) + 0.1 * r


def salomon_corrected(x):
    return salomon(x)


def periodic(x):
    s = torch.sum(torch.sin(x) ** 2)
    return 1.0 + s - 0.1 * torch.exp(-torch.sum(x**2))


def cosine_mixture(x):
    return -(0.1 * torch.sum(torch.cos(5 * PI * x)) - torch.sum(x**2))


def exponential(x):
    return -torch.exp(-0.5 * torch.sum(x**2))


def qing(x):
    i = _i1(x)
    return torch.sum((x**2 - i) ** 2)


def katsuura(x):
    k = torch.arange(1, 33, dtype=x.dtype, device=x.device)
    two_k = 2.0**k
    # torch.round, like jnp.round, rounds half to even
    term = torch.sum(
        torch.abs(two_k[None, :] * x[:, None] - torch.round(two_k[None, :] * x[:, None]))
        / two_k[None, :],
        dim=1,
    )
    i = _i1(x)
    return torch.prod(1.0 + i * term) - 1.0


def whitley(x):
    xi = x[:, None]
    xj = x[None, :]
    t = 100 * (xi**2 - xj) ** 2 + (1 - xj) ** 2
    return torch.sum(t**2 / 4000.0 - torch.cos(t) + 1.0)


def vincent(x):
    return -torch.sum(torch.sin(10.0 * torch.log(x)))


def pinter(x):
    i = _i1(x)
    x_prev = torch.cat([x[-1:], x[:-1]])
    x_next = torch.cat([x[1:], x[:1]])
    a = x_prev * torch.sin(x) + torch.sin(x_next)
    b = x_prev**2 - 2 * x + 3 * x_next - torch.cos(x) + 1.0
    return (
        torch.sum(i * x**2)
        + torch.sum(20.0 * i * torch.sin(a) ** 2)
        + torch.sum(i * torch.log10(1.0 + i * b**2))
    )


def xin_she_yang_n1(x):
    i = _i1(x)
    # deterministic variant (reference uses eps_i = 1)
    return torch.sum(torch.abs(x) ** i)


def xin_she_yang_n2(x):
    return torch.sum(torch.abs(x)) * torch.exp(-torch.sum(torch.sin(x**2)))


def xin_she_yang_n3(x, m=5.0, beta=15.0):
    t1 = torch.exp(-torch.sum((x / beta) ** (2 * m)))
    t2 = 2.0 * torch.exp(-torch.sum(x**2)) * torch.prod(torch.cos(x) ** 2)
    return t1 - t2


def xin_she_yang_n4(x):
    t1 = torch.sum(torch.sin(x) ** 2)
    t2 = torch.exp(-torch.sum(x**2))
    t3 = torch.exp(-torch.sum(torch.sin(torch.sqrt(torch.abs(x))) ** 2))
    return (t1 - t2) * t3


def happycat(x, alpha=0.125):
    n = _n(x)
    r2 = torch.sum(x**2)
    s = torch.sum(x)
    return torch.abs(r2 - n) ** (2 * alpha) + (0.5 * r2 + s) / n + 0.5


def happy_cat(x):
    """Reference's happycat.rs uses |r2-n|^0.25 — alpha = 0.125."""
    return happycat(x, alpha=0.125)


def expanded_griewank_rosenbrock(x):
    x_next = torch.cat([x[1:], x[:1]])
    t = 100.0 * (x**2 - x_next) ** 2 + (x - 1.0) ** 2
    return torch.sum(t**2 / 4000.0 - torch.cos(t) + 1.0)


def forrester_2008(x):
    a = x[0]
    return (6 * a - 2) ** 2 * torch.sin(12 * a - 4)


def gramacy_lee_2012(x):
    a = x[0]
    return torch.sin(10 * PI * a) / (2 * a) + (a - 1) ** 4


def gramacy_lee_function(x):
    return gramacy_lee_2012(x)


def langermann(x):
    a = _const([[3.0, 5.0], [5.0, 2.0], [2.0, 1.0], [1.0, 4.0], [7.0, 9.0]], x)
    c = _const([1.0, 2.0, 5.0, 2.0, 3.0], x)
    d2 = torch.sum((x[None, :] - a) ** 2, dim=1)
    return -torch.sum(c * torch.exp(-d2 / PI) * torch.cos(PI * d2))


def dejong_f5_foxholes(x):
    a_row = _const([-32.0, -16.0, 0.0, 16.0, 32.0], x)
    a1 = a_row.repeat(5)  # jnp.tile
    a2 = torch.repeat_interleave(a_row, 5)  # jnp.repeat
    j = torch.arange(1.0, 26.0, dtype=x.dtype, device=x.device)
    denom = j + (x[0] - a1) ** 6 + (x[1] - a2) ** 6
    return 1.0 / (0.002 + torch.sum(1.0 / denom))


def shekel(x, m=10):
    a = _const(
        [
            [4, 4, 4, 4], [1, 1, 1, 1], [8, 8, 8, 8], [6, 6, 6, 6], [3, 7, 3, 7],
            [2, 9, 2, 9], [5, 5, 3, 3], [8, 1, 8, 1], [6, 2, 6, 2], [7, 3.6, 7, 3.6],
        ],
        x,
    )[:m]
    c = _const([0.1, 0.2, 0.2, 0.4, 0.4, 0.6, 0.3, 0.7, 0.5, 0.5], x)[:m]
    return -torch.sum(1.0 / (torch.sum((x[None, :] - a) ** 2, dim=1) + c))


_HARTMAN3_A = [[3, 10, 30], [0.1, 10, 35], [3, 10, 30], [0.1, 10, 35]]
_HARTMAN3_P = [
    [0.3689, 0.117, 0.2673],
    [0.4699, 0.4387, 0.747],
    [0.1091, 0.8732, 0.5547],
    [0.03815, 0.5743, 0.8828],
]
_HARTMAN6_A = [
    [10, 3, 17, 3.5, 1.7, 8],
    [0.05, 10, 17, 0.1, 8, 14],
    [3, 3.5, 1.7, 10, 17, 8],
    [17, 8, 0.05, 10, 0.1, 14],
]
_HARTMAN6_P = [
    [0.1312, 0.1696, 0.5569, 0.0124, 0.8283, 0.5886],
    [0.2329, 0.4135, 0.8307, 0.3736, 0.1004, 0.9991],
    [0.2348, 0.1451, 0.3522, 0.2883, 0.3047, 0.6650],
    [0.4047, 0.8828, 0.8732, 0.5743, 0.1091, 0.0381],
]
_HARTMAN_C = [1.0, 1.2, 3.0, 3.2]


def _hartman(x, a, p):
    a = _const(a, x)
    p = _const(p, x)
    c = _const(_HARTMAN_C, x)
    inner = torch.sum(a * (x[None, :] - p) ** 2, dim=1)
    return -torch.sum(c * torch.exp(-inner))


def hartman_3d(x):
    return _hartman(x, _HARTMAN3_A, _HARTMAN3_P)


def hartman_6d(x):
    return _hartman(x, _HARTMAN6_A, _HARTMAN6_P)


def hartman_4d(x):
    """4-D slice of the 6-D Hartmann family (first four columns)."""
    a = _const(_HARTMAN6_A, x)[:, :4]
    p = _const(_HARTMAN6_P, x)[:, :4]
    c = _const(_HARTMAN_C, x)
    inner = torch.sum(a * (x[None, :] - p) ** 2, dim=1)
    return -torch.sum(c * torch.exp(-inner))


# ------------------------------------------------------ constrained family

def binh_korn_weighted(x):
    """Binh–Korn bi-objective scalarized (equal weights)."""
    f1 = 4 * x[0] ** 2 + 4 * x[1] ** 2
    f2 = (x[0] - 5) ** 2 + (x[1] - 5) ** 2
    return 0.5 * f1 + 0.5 * f2


def binh_korn_constraint1(x):
    """(x-5)^2 + y^2 <= 25 -> g <= 0."""
    return (x[0] - 5) ** 2 + x[1] ** 2 - 25.0


def binh_korn_constraint2(x):
    """(x-8)^2 + (y+3)^2 >= 7.7 -> g <= 0."""
    return 7.7 - (x[0] - 8) ** 2 - (x[1] + 3) ** 2


def keanes_bump_objective(x):
    num = torch.abs(torch.sum(torch.cos(x) ** 4) - 2.0 * torch.prod(torch.cos(x) ** 2))
    den = torch.sqrt(torch.sum(_i1(x) * x**2))
    return -num / torch.clamp_min(den, 1e-30)


def keanes_bump_constraint1(x):
    """prod x > 0.75 -> g <= 0."""
    return 0.75 - torch.prod(x)


def keanes_bump_constraint2(x):
    """sum x < 7.5 n -> g <= 0."""
    return torch.sum(x) - 7.5 * _n(x)


def mishras_bird_objective(x):
    a, b = x[0], x[1]
    return (
        torch.sin(b) * torch.exp((1 - torch.cos(a)) ** 2)
        + torch.cos(a) * torch.exp((1 - torch.sin(b)) ** 2)
        + (a - b) ** 2
    )


def mishras_bird_constraint(x):
    """(x+5)^2 + (y+5)^2 < 25 -> g <= 0."""
    return (x[0] + 5) ** 2 + (x[1] + 5) ** 2 - 25.0


def rosenbrock_objective(x):
    return rosenbrock(x)


def rosenbrock_disk_constraint(x):
    """x^2 + y^2 <= 2 -> g <= 0."""
    return x[0] ** 2 + x[1] ** 2 - 2.0


def lampinen_simplified(x):
    head = torch.sum(5.0 * x[:4] - x[:4] ** 2)
    tail = -torch.sum(x[4:])
    return -(head + tail)
