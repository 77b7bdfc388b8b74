"""Port vs reference: the optimizer test-function registry (slice 7b).

Each registered function of mathaudio_tpu_torch.testfunctions, batched by
``torch.func.vmap`` in float64 on the CPU, against the JAX package's, batched
eagerly by ``jax.vmap`` (no jit: one compile per function would cost more
than the evaluations), at 16 seeded points uniform in its bounds: at its
registered width, and at width 10 where any width is admitted. Then the
registered minima (the port against the reference there, the registered
value, and the companion constraints), the metadata field for field and
the registry's order. A ``cuda`` case holds the card against the CPU.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mathaudio_tpu.testfunctions import FUNCTIONS as REF
from mathaudio_tpu.testfunctions import functions as ref_functions
from mathaudio_tpu.testfunctions import list_functions as ref_list_functions
from mathaudio_tpu_torch.testfunctions import (
    FUNCTIONS,
    FunctionMetadata,
    functions,
    get_function,
    get_function_metadata,
    list_functions,
)

NAMES = list(REF)
TOL = 1e-12  # |port - reference| <= TOL * max(1, |reference|), float64
POINTS = 16
ANY_WIDTH = 10
# tests/test_testfunctions.py: registered minima rounded to 4-6 digits
ROUNDED_REL, EXACT_REL = 2.5e-4, 1e-9
ROUNDED = {
    "alpine_n2", "michalewicz", "mccormick", "six_hump_camel", "schwefel", "shekel",
    "cross_in_tray", "keanes_bump_objective", "hartman_3d", "hartman_4d", "hartman_6d",
    "schaffer_n4", "holder_table", "langermann", "eggholder", "styblinski_tang2",
    "forrester_2008", "shubert", "bird", "dejong_f5_foxholes", "mishras_bird_objective",
    "ackley_n3", "branin", "gramacy_lee_2012", "gramacy_lee_function", "goldstein_price",
    "drop_wave", "easom", "himmelblau", "vincent", "whitley", "qing",
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _widths(meta):
    """(width, bounds) pairs: the registered width, and 10 where any width
    is admitted (run_de's ``--dims``: the first bound repeated)."""
    out = [(len(meta.bounds), list(meta.bounds))]
    if not meta.dimensions:
        out.append((ANY_WIDTH, [meta.bounds[0]] * ANY_WIDTH))
    return out


def _minima(meta):
    """The registered minima whose position is known, as rows."""
    return [list(map(float, x)) for x, _ in meta.global_minima
            if not any(math.isnan(v) for v in x)]


@functools.lru_cache(maxsize=None)
def _points(name, width):
    """16 rows: at the registered width the known minima first, then seeded
    points uniform in the bounds (one batch shape per width, so the eager
    reference compiles each primitive once for all of a width's tests)."""
    meta = REF[name][1]
    bounds = dict(_widths(meta))[width]
    lo, hi = np.array(bounds).T
    head = [x for x in _minima(meta) if len(x) == width] if width == len(meta.bounds) else []
    rng = np.random.default_rng(1000 * NAMES.index(name) + width)
    return np.vstack([np.array(head).reshape(-1, width),
                      rng.uniform(lo, hi, size=(POINTS - len(head), width))])


@functools.lru_cache(maxsize=None)
def _ref_values(name, width, fn_name=None):
    """The reference's values of ``name``'s batch at ``width``, or of its
    constraint ``fn_name`` on that batch."""
    ref_fn = getattr(ref_functions, fn_name) if fn_name else REF[name][0]
    return _ref(ref_fn, _points(name, width))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, float), np.asarray(want, float)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert np.all(err <= tol), (float(np.max(err)), got, want)


def _port(fn, pts, device="cpu"):
    return torch.func.vmap(fn)(torch.tensor(pts, dtype=torch.float64, device=device)).cpu().numpy()


def _ref(fn, pts):
    return np.asarray(jax.vmap(fn)(jnp.asarray(pts, dtype=jnp.float64)))


@pytest.mark.parametrize("name", NAMES)
def test_values_match_the_reference(name):
    port_fn = FUNCTIONS[name][0]
    for width, _ in _widths(REF[name][1]):
        got = _port(port_fn, _points(name, width))
        assert got.shape == (POINTS,) and got.dtype == np.float64
        _close(got, _ref_values(name, width))


@pytest.mark.parametrize("name", NAMES)
def test_registered_minima(name):
    """At each registered minimum the port agrees with the reference and
    reproduces the registered value (tests/test_testfunctions.py's
    tolerances); the companion constraints agree there too, and hold."""
    port_fn, meta = FUNCTIONS[name]
    width = len(meta.bounds)
    pts = _points(name, width)
    minima = [(x, f) for x, f in meta.global_minima if list(map(float, x)) in _minima(meta)
              and len(x) == width]
    got = _port(port_fn, pts)
    for row, (x_star, f_star) in enumerate(minima):
        assert list(pts[row]) == list(map(float, x_star))
        _close(got[row], _ref_values(name, width)[row])
        if not math.isnan(f_star):
            rel = ROUNDED_REL if name in ROUNDED else EXACT_REL
            assert abs(got[row] - f_star) / max(1.0, abs(f_star)) < rel, (got[row], f_star)
    for g in meta.inequality_constraints:
        g_vals = _port(g, pts)
        _close(g_vals, _ref_values(name, width, g.__name__))
        assert np.all(g_vals[:len(minima)] <= 1e-6), f"{name}: an optimum breaks {g.__name__}"


def _fields(meta):
    out = {}
    for field in (f.name for f in FunctionMetadata.__dataclass_fields__.values()):
        value = getattr(meta, field)
        if field.endswith("_constraints"):
            value = [g.__name__ for g in value]
        out[field] = repr(value)  # repr: NaN minima compare equal
    return out


@pytest.mark.parametrize("name", NAMES)
def test_metadata_is_the_reference(name):
    port_fn, meta = FUNCTIONS[name]
    ref_fn, ref_meta = REF[name]
    assert [f.name for f in FunctionMetadata.__dataclass_fields__.values()] == list(
        type(ref_meta).__dataclass_fields__)
    assert _fields(meta) == _fields(ref_meta)
    assert port_fn.__name__ == ref_fn.__name__
    for fn in [port_fn] + meta.inequality_constraints + meta.equality_constraints:
        assert getattr(functions, fn.__name__) is fn  # the port's own functions
    assert get_function(name) is port_fn and get_function_metadata(name) is meta


def test_registry_order_and_listing():
    assert len(FUNCTIONS) == 105
    assert list(FUNCTIONS) == NAMES
    assert list_functions() == ref_list_functions()
    assert list(get_function_metadata()) == NAMES


def test_round_half_to_even_as_the_reference():
    """katsuura and step round at halves: torch.round and jnp.round both
    round half to even (katsuura's 2^k x lands on halves at dyadic x)."""
    halves = np.array([0.5, -1.5, 2.5, 0.25, 1.0 / 3.0, -0.125, 0.375, 3.5, -0.5, 1.5])
    x = np.stack([np.roll(halves, i) * 2.0 ** -(i % 4) for i in range(POINTS)])
    for name in ("katsuura", "step", "de_jong_step2"):
        _close(_port(FUNCTIONS[name][0], x), _ref(REF[name][0], x))


@pytest.mark.cuda
def test_card_matches_the_cpu():
    """chip_smoke.py phase 20 (a) at a small size: every function at 256
    seeded points on the card against the CPU, within 1e-10 of max(1, |f|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (evaluates the registry on the card)")
    rng = np.random.default_rng(20)
    for name in NAMES:
        fn, meta = FUNCTIONS[name]
        width, bounds = _widths(meta)[-1]
        lo, hi = np.array(bounds).T
        pts = rng.uniform(lo, hi, size=(256, width))
        _close(_port(fn, pts, "cuda"), _port(fn, pts, "cpu"), tol=1e-10)
