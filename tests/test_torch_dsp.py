"""Port vs reference: slice 3, the IIR/FIR DSP engine (mathaudio_tpu/dsp vs
mathaudio_tpu_torch/dsp), on the CPU in float64.

Host math (RBJ coefficients, builders, band selection, exporters) must be
equal: the same floats and the same strings. Tensor paths are held to the
JAX package at 1e-12 (responses, preamp, loudness, scan blocks, FIR), the
biquad cascade at 1e-10, and the differentiable responses' autograd
gradients to ``jax.grad`` at 1e-9. The scan also meets scipy's sequential
``lfilter`` on the low, resonant stages of the bench's PEQ: float32 within
1e-3 of max|y| (the scan factors each stage at its poles; a 2x2-state
doubling loses 1e-2 there), float64 within 1e-9. Tests marked ``cuda`` run
the cascade on the card against the CPU and skip without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

import mathaudio_tpu.dsp as jdsp
import mathaudio_tpu.dsp.fir as jfir
import mathaudio_tpu.dsp.formats as jformats
import mathaudio_tpu.dsp.iir as jiir
import mathaudio_tpu.dsp.jax_response as jresp
import mathaudio_tpu.dsp.scan as jscan
import mathaudio_tpu_torch.dsp as dsp
from mathaudio_tpu_torch.convert import peq_from_numpy
from mathaudio_tpu_torch.dsp import fir, formats, iir, response, scan

CPU = "cpu"
JFT = jiir.BiquadFilterType
FT = iir.BiquadFilterType
FREQS = np.logspace(np.log10(20.0), np.log10(20000.0), 97)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these shapes more threads do not shorten
    the tests and only contend with the other workers of a parallel run."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_peq(jpeq):
    return peq_from_numpy([(w, bq.filter_type.name, bq.freq, bq.srate, bq.q, bq.db_gain)
                           for w, bq in jpeq])


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# The reference's scan, jitted: run eagerly, its associative scan compiles
# each of its many small operations for every new block length.
_ref_block = jax.jit(jscan.biquad_process_block)
_ref_block_vmapped = jax.jit(jax.vmap(jscan.biquad_process_block, in_axes=(0, None, 0)))


# Three PEQs for the exporters and the response paths: every filter type,
# Q defaults, and the RME room slot rules (one low and one high non-PK
# filter, a notch that becomes PK, more than 7 PK bands to drop).
PEQ_ROWS = {
    "shelves": [(1.0, "LOWSHELF", 105.0, 48000.0, 0.0, 4.5), (1.0, "PEAK", 820.0, 48000.0, 1.4, -3.25),
                (0.5, "PEAK", 2400.0, 48000.0, 2.2, 2.0), (1.0, "HIGHSHELF", 8000.0, 48000.0, 0.7, -2.5)],
    "mixed": [(1.0, "HIGHPASS", 35.0, 48000.0, 0.0, 0.0), (1.0, "NOTCH", 3150.0, 48000.0, 0.0, 0.0),
              (1.0, "BANDPASS", 440.0, 48000.0, 1.1, 0.0), (1.0, "LOWPASS", 16000.0, 48000.0, 0.9, 0.0),
              (1.0, "HIGHPASS_VARIABLE_Q", 60.0, 48000.0, 1.3, 0.0),
              (1.0, "PEAK", 1200.0, 48000.0, 3.0, 6.0)],
    "many_pk": [(1.0, "PEAK", 60.0 * 1.6**i, 48000.0, 0.8 + 0.3 * i, (-1.0) ** i * (1.0 + i))
                for i in range(10)] + [(1.0, "LOWSHELF", 80.0, 48000.0, 0.9, 3.0),
                                       (1.0, "LOWPASS", 18000.0, 48000.0, 0.0, 0.0),
                                       (1.0, "HIGHSHELF", 12000.0, 48000.0, 0.8, -1.0)],
}


def _jax_peq(rows):
    return [(w, jiir.Biquad(JFT[name], f, sr, q, g)) for w, name, f, sr, q, g in rows]


# --------------------------------------------------------------------------
# Host math: equal floats and equal structure
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", [t.name for t in JFT])
@pytest.mark.parametrize("q,gain", [(0.0, 0.0), (0.0, 4.0), (1.7, -6.5), (-1.0, 2.0)])
def test_coefficients_equal_the_reference(name, q, gain):
    ref = jiir.Biquad(JFT[name], 1234.5, 44100.0, q, gain)
    got = iir.Biquad(FT[name], 1234.5, 44100.0, q, gain)
    for attr in ("q", "b0", "b1", "b2", "a1", "a2", "r_up0", "r_up1", "r_up2",
                 "r_dw0", "r_dw1", "r_dw2"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    assert got.constants() == ref.constants()
    assert str(got) == str(ref)
    assert got.filter_type.short_name == ref.filter_type.short_name
    assert got.filter_type.long_name == ref.filter_type.long_name


@pytest.mark.parametrize("args", [(1000.0, 48000.0, 2.0, 3.0), (30000.0, 48000.0, 2.0, 0.0),
                                  (1000.0, -1.0, 2.0, 0.0), (1000.0, 48000.0, -2.0, 0.0),
                                  (1000.0, 48000.0, 2.0, float("inf"))])
def test_try_new_validates_as_the_reference(args):
    try:
        jiir.Biquad.try_new(JFT.PEAK, *args)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[1]):
            iir.Biquad.try_new(FT.PEAK, *args)
    else:
        assert iir.Biquad.try_new(FT.PEAK, *args).b0 == jiir.Biquad.try_new(JFT.PEAK, *args).b0


def test_builders_and_band_selection_equal_the_reference():
    assert iir.bw2q(0.9) == jiir.bw2q(0.9) and iir.q2bw(1.3) == jiir.q2bw(1.3)
    for order in range(1, 9):
        assert iir.peq_butterworth_q(order) == jiir.peq_butterworth_q(order)
        assert iir.peq_linkwitzriley_q(2 * order) == jiir.peq_linkwitzriley_q(2 * order)
        for fn in ("peq_butterworth_lowpass", "peq_butterworth_highpass",
                   "peq_linkwitzriley_lowpass", "peq_linkwitzriley_highpass"):
            got, ref = getattr(iir, fn)(order * 2, 500.0), getattr(jiir, fn)(order * 2, 500.0)
            assert iir.peq_equal(got, _port_peq(ref)), (fn, order)
            assert [bq.b0 for _, bq in got] == [bq.b0 for _, bq in ref]
    for t in JFT:
        assert iir.get_filter_priority(FT[t.name]) == jiir.get_filter_priority(t)
    for rows in PEQ_ROWS.values():
        jpeq = _jax_peq(rows)
        for count in (0, 2, 5, 9, 20):
            got = iir.filter_peqs_by_gain(_port_peq(jpeq), count)
            assert iir.peq_equal(got, _port_peq(jiir.filter_peqs_by_gain(jpeq, count)))
        assert iir.peq_print(_port_peq(jpeq)) == jiir.peq_print(jpeq)
        assert iir.peq_equal(_port_peq(jpeq), _port_peq(jpeq))
    assert not iir.peq_equal(_port_peq(_jax_peq(PEQ_ROWS["mixed"])), _port_peq(_jax_peq(PEQ_ROWS["shelves"])))


# --------------------------------------------------------------------------
# Responses, preamp and loudness (1e-12)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("which", sorted(PEQ_ROWS))
def test_responses_match_the_reference(which):
    jpeq = _jax_peq(PEQ_ROWS[which])
    peq = _port_peq(jpeq)
    f = torch.tensor(FREQS)
    for (_, got), (_, ref) in zip(peq, jpeq):
        for m in ("result", "log_result", "np_log_result"):
            np.testing.assert_allclose(_np(getattr(got, m)(f)), np.asarray(getattr(ref, m)(FREQS)),
                                       rtol=0, atol=1e-12, err_msg=m)
    np.testing.assert_allclose(_np(iir.peq_spl(FREQS, peq, device=CPU)),
                               np.asarray(jiir.peq_spl(FREQS, jpeq)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(iir.compute_peq_response(f, peq, 44100.0)),
                               np.asarray(jiir.compute_peq_response(FREQS, jpeq, 44100.0)),
                               rtol=0, atol=1e-12)
    for fn in ("peq_preamp_gain", "peq_preamp_gain_max"):
        assert abs(getattr(iir, fn)(peq, device=CPU) - getattr(jiir, fn)(jpeq)) <= 1e-12, fn
    for weighting in ("a", "k", "none"):
        # NaN where the reference's is (a notch's zero makes 1 + avg negative)
        np.testing.assert_allclose(iir.peq_loudness_gain(peq, weighting, device=CPU),
                                   jiir.peq_loudness_gain(jpeq, weighting), rtol=0, atol=1e-12,
                                   err_msg=weighting)


def test_empty_peq_gains_and_weightings():
    assert iir.peq_preamp_gain_max([], device=CPU) == jiir.peq_preamp_gain_max([]) == 0.0
    assert iir.peq_loudness_gain([], device=CPU) == 0.0
    f = np.array([10.0, 1000.0, 3000.0, 15000.0])
    for name in ("_a_weighting_db", "_k_weighting_db"):
        np.testing.assert_allclose(_np(getattr(iir, name)(torch.tensor(f))),
                                   np.asarray(getattr(jiir, name)(jnp.asarray(f))), rtol=0, atol=1e-12)


# --------------------------------------------------------------------------
# The scan: blocks, state, batches, the cascade
# --------------------------------------------------------------------------

SCAN_FILTERS = {  # complex-pole and real-pole stages
    "peak_1k": (JFT.PEAK, 1000.0, 2.0, 5.0),
    "notch_2k": (JFT.NOTCH, 2000.0, 0.0, 0.0),
    "lowpass_q05": (JFT.LOWPASS, 3000.0, 0.5, 0.0),
    "highpass_q03": (JFT.HIGHPASS, 1500.0, 0.3, 0.0),
}


def _coeffs(name):
    ft, f, q, g = SCAN_FILTERS[name]
    bq = jiir.Biquad(ft, f, 48000.0, q, g)
    return (bq.b0, bq.b1, bq.b2, bq.a1, bq.a2)


@pytest.mark.parametrize("name", sorted(SCAN_FILTERS))
@pytest.mark.parametrize("t", [1, 2, 3, 257, 300])
@pytest.mark.parametrize("stateful", [False, True])
def test_process_block_matches_the_reference(name, t, stateful):
    rng = np.random.default_rng(t + 7 * stateful)
    x = rng.standard_normal(t)
    state = tuple(rng.standard_normal(4)) if stateful else None
    c = _coeffs(name)
    y_ref, s_ref = _ref_block(jnp.asarray(x), c, state)
    y, s = scan.biquad_process_block(torch.tensor(x), c, state)
    assert y.shape == (t,) and y.dtype == torch.float64
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), rtol=0, atol=1e-12)
    assert len(s) == 4 and all(v.shape == () for v in s)
    # the carried inputs are the reference's; the outputs are y's own last samples
    assert float(s[0]) == float(s_ref[0]) and float(s[1]) == float(s_ref[1])
    assert float(s[2]) == float(y[-1])
    assert float(s[3]) == (float(y[-2]) if t >= 2 else state[2] if stateful else 0.0)
    np.testing.assert_allclose(_np(torch.stack(s[2:])), np.asarray(s_ref[2:]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("stateful", [False, True])
def test_batched_block_matches_the_reference_vmapped(stateful):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 300))
    c = _coeffs("peak_1k")
    state = tuple(rng.standard_normal((4, 3))) if stateful else None
    y_ref, s_ref = _ref_block_vmapped(jnp.asarray(x), c, state)
    y, s = scan.biquad_process_block(torch.tensor(x), c,
                                     state and tuple(torch.tensor(v) for v in state))
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), rtol=0, atol=1e-12)
    for got, ref in zip(s, s_ref):
        assert got.shape == (3,)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=1e-12)


def test_half_blocks_with_state_equal_the_whole_block():
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.standard_normal((2, 1000)))
    c = _coeffs("highpass_q03")
    whole, _ = scan.biquad_process_block(x, c)
    first, st = scan.biquad_process_block(x[:, :437], c)
    second, _ = scan.biquad_process_block(x[:, 437:], c, st)
    np.testing.assert_allclose(_np(torch.cat([first, second], 1)), _np(whole), rtol=0, atol=1e-12)


def test_biquad_process_block_method():
    jbq = jiir.Biquad(JFT.PEAK, 700.0, 48000.0, 1.5, -4.0)
    bq = _port_peq([(1.0, jbq)])[0][1]
    x = np.random.default_rng(2).standard_normal(128)
    y, _ = bq.process_block(x, device=CPU)
    ref, _ = _ref_block(jnp.asarray(x), (jbq.b0, jbq.b1, jbq.b2, jbq.a1, jbq.a2))
    np.testing.assert_allclose(_np(y), np.asarray(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("which", sorted(PEQ_ROWS))
def test_cascade_matches_the_reference(which):
    jpeq = _jax_peq(PEQ_ROWS[which])
    cm_ref = jscan.peq_coeff_matrix(jpeq, dtype=jnp.float64)
    cm = scan.peq_coeff_matrix(_port_peq(jpeq), torch.float64, device=CPU)
    np.testing.assert_array_equal(_np(cm), np.asarray(cm_ref))
    x = np.random.default_rng(3).standard_normal(2000)
    y = scan.biquad_cascade_block(torch.tensor(x), cm)
    y_ref = jscan.biquad_cascade_block(jnp.asarray(x), cm_ref)
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), rtol=0, atol=1e-10)
    assert scan.peq_coeff_matrix(_port_peq(jpeq), device=CPU).dtype == torch.float32


def _bench_peq(stages=10):
    """bench.py ``run_iir``'s cascade: PEAK at 100 (i + 1) Hz, Q 1, +-3 dB."""
    return [(1.0, iir.Biquad(FT.PEAK, 100.0 * (i + 1), 48000.0, 1.0, (-1.0) ** i * 3.0))
            for i in range(stages)]


def _lfilter_cascade(peq, x):
    y = x
    for _, bq in peq:
        y = sps.lfilter([bq.b0, bq.b1, bq.b2], [1.0, bq.a1, bq.a2], y, axis=-1)
    return y


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-9)])
def test_bench_cascade_meets_scipy(dtype, tol):
    peq = _bench_peq()
    x = np.random.default_rng(0).standard_normal((4, 48000))
    want = _lfilter_cascade(peq, x)
    got = scan.biquad_cascade_block(torch.tensor(x, dtype=dtype),
                                    scan.peq_coeff_matrix(peq, dtype, device=CPU))
    assert got.dtype == dtype and got.shape == x.shape
    assert np.abs(_np(got) - want).max() <= tol * np.abs(want).max()


# --------------------------------------------------------------------------
# FIR
# --------------------------------------------------------------------------

FIRS = [("LOWPASS", 2000.0, 63, "HAMMING", 0.0), ("HIGHPASS", 500.0, 40, "HANN", 0.0),
        ("BANDPASS", 3000.0, 81, "BLACKMAN", 1000.0), ("BANDSTOP", 1000.0, 51, "KAISER", 0.0),
        ("LOWPASS", 8000.0, 17, "RECTANGULAR", 0.0)]


def _firs(spec):
    ftype, freq, taps, window, bw = spec
    ref = jfir.Fir(jfir.FirFilterType[ftype], freq, 48000.0, taps, jfir.WindowType[window], bw)
    got = fir.Fir(fir.FirFilterType[ftype], freq, 48000.0, taps, fir.WindowType[window], bw)
    return got, ref


def _same_magnitude(got_db, ref_db):
    """dB responses compared as magnitudes, to 1e-12: deep in a stopband
    the DTFT's O(1) terms cancel to ~1e-10, where float64 rounding moves
    the dB value by ~1e-7."""
    np.testing.assert_allclose(10.0 ** (_np(got_db) / 20.0), 10.0 ** (np.asarray(ref_db) / 20.0),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("spec", FIRS, ids=lambda s: f"{s[0]}-{s[3]}")
def test_fir_matches_the_reference(spec):
    got, ref = _firs(spec)
    np.testing.assert_array_equal(got.taps, ref.taps)
    assert got.num_taps == ref.num_taps
    x = np.random.default_rng(4).standard_normal(300)
    y1, s1 = got.process_block(x[:120], device=CPU)
    y2, s2 = got.process_block(x[120:], state=s1, device=CPU)
    r1, q1 = ref.process_block(x[:120])
    r2, q2 = ref.process_block(x[120:], state=q1)
    np.testing.assert_allclose(_np(torch.cat([y1, y2])), np.concatenate([r1, r2]), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(_np(s2), np.asarray(q2))
    np.testing.assert_allclose(_np(got.process(x, device=CPU)), np.asarray(ref.process(x)),
                               rtol=0, atol=1e-12)
    _same_magnitude(got.np_log_result(FREQS, device=CPU), ref.np_log_result(FREQS))


def test_fir_bank_and_windows_match_the_reference():
    pairs = [_firs(spec) for spec in FIRS[:3]]
    bank = fir.FirBank([(0.5 + i, got) for i, (got, _) in enumerate(pairs)])
    ref = jfir.FirBank([(0.5 + i, r) for i, (_, r) in enumerate(pairs)])
    _same_magnitude(bank.np_log_result(FREQS, device=CPU), ref.np_log_result(FREQS))
    assert abs(bank.preamp_gain(device=CPU) - ref.preamp_gain()) <= 1e-12
    for w in jfir.WindowType:
        np.testing.assert_array_equal(fir.generate_window(fir.WindowType[w.name], 33),
                                      jfir.generate_window(w, 33))


# --------------------------------------------------------------------------
# Exporters: the reference's strings, character for character
# --------------------------------------------------------------------------


@pytest.mark.parametrize("which", sorted(PEQ_ROWS))
@pytest.mark.parametrize("fmt", ["apo", "rme_channel", "rme_room", "aupreset"])
def test_exporters_equal_the_reference(which, fmt):
    jpeq = _jax_peq(PEQ_ROWS[which])
    peq = _port_peq(jpeq)
    if fmt == "apo":
        got, ref = formats.peq_format_apo("# eq", peq, device=CPU), jformats.peq_format_apo("# eq", jpeq)
    elif fmt == "rme_channel":
        got, ref = formats.peq_format_rme_channel(peq), jformats.peq_format_rme_channel(jpeq)
    elif fmt == "rme_room":
        other = _jax_peq(PEQ_ROWS["mixed"])
        got = formats.peq_format_rme_room(peq, _port_peq(other))
        ref = jformats.peq_format_rme_room(jpeq, other)
        assert formats.peq_format_rme_room(peq) == jformats.peq_format_rme_room(jpeq)
        slots = formats._enforce_rme_room_constraints(peq)
        assert iir.peq_equal(slots, _port_peq(jformats._enforce_rme_room_constraints(jpeq)))
    else:
        got = formats.peq_format_aupreset(peq, "eq", device=CPU)
        ref = jformats.peq_format_aupreset(jpeq, "eq")
    assert got == ref


def test_rme_room_pads_an_empty_eq():
    assert iir.peq_equal(formats._enforce_rme_room_constraints([]),
                         _port_peq(jformats._enforce_rme_room_constraints([])))


# --------------------------------------------------------------------------
# Differentiable responses (dsp/response.py vs dsp/jax_response.py)
# --------------------------------------------------------------------------

KINDS = ["LS", "PK", "PK", "HS"]
PARAMS = np.array([[2.1, 0.8, 4.0], [2.9, 1.6, -5.0], [3.4, 3.0, 2.5], [3.95, 0.9, -1.5]])


@pytest.mark.parametrize("kind", ["PK", "LS", "HS"])
def test_response_values_match_the_reference(kind):
    fn = {"PK": "peak_coeffs", "LS": "lowshelf_coeffs", "HS": "highshelf_coeffs"}[kind]
    got = getattr(response, fn)(1500.0, 1.1, 5.5, 44100.0, device=CPU)
    ref = getattr(jresp, fn)(1500.0, 1.1, 5.5, 44100.0)
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in ref], rtol=0, atol=1e-12)
    got = response.biquad_response_db(kind, 1500.0, 1.1, 5.5, FREQS, device=CPU)
    ref = jresp.biquad_response_db(kind, 1500.0, 1.1, 5.5, jnp.asarray(FREQS))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=1e-12)


def test_peq_response_batched_and_differentiable():
    f = torch.tensor(FREQS)
    # values from the eager reference (jit lets XLA round 10**x its own way)
    ref_fn = lambda p: jresp.peq_response_db(KINDS, p, jnp.asarray(FREQS))  # noqa: E731
    ref = np.asarray(ref_fn(jnp.asarray(PARAMS)))
    np.testing.assert_allclose(_np(response.peq_response_db(KINDS, torch.tensor(PARAMS), f)), ref,
                               rtol=0, atol=1e-12)
    pop = PARAMS[None] + np.random.default_rng(8).uniform(-0.2, 0.2, (5, *PARAMS.shape))
    ref_b = np.asarray(jax.vmap(ref_fn)(jnp.asarray(pop)))
    got_b = response.peq_response_db(KINDS, torch.tensor(pop), f)
    assert got_b.shape == (5, len(FREQS))
    np.testing.assert_allclose(_np(got_b), ref_b, rtol=0, atol=1e-12)
    got_v = torch.func.vmap(lambda p: response.peq_response_db(KINDS, p, f))(torch.tensor(pop))
    np.testing.assert_allclose(_np(got_v), ref_b, rtol=0, atol=1e-12)

    target = np.sin(np.linspace(0, 6, len(FREQS)))

    def jloss(p):
        return jnp.sum((jresp.peq_response_db(KINDS, p, jnp.asarray(FREQS)) - target) ** 2)

    g_ref = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(PARAMS)))
    p = torch.tensor(PARAMS, requires_grad=True)
    torch.sum((response.peq_response_db(KINDS, p, f) - torch.tensor(target)) ** 2).backward()
    np.testing.assert_allclose(p.grad.numpy(), g_ref, rtol=0, atol=1e-9 * np.abs(g_ref).max())


def test_package_exports_and_denormals():
    # every name the reference package exports, bar its submodule jax_response
    # (the port's is dsp/response.py)
    names = [n for n in dir(jdsp) if not n.startswith("_") and n not in ("annotations", "jax_response")]
    missing = [n for n in names if not hasattr(dsp, n)]
    assert not missing
    with dsp.ScopedFlushToZero() as guard, dsp.flush_denormals():
        assert guard is not None


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cascade_on_the_card_matches_the_cpu(cuda_device):
    peq = _bench_peq()
    x = np.random.default_rng(0).standard_normal((16, 48000))
    want = _lfilter_cascade(peq, x)
    for dtype, tol in ((torch.float32, 1e-3), (torch.float64, 1e-9)):
        cm = scan.peq_coeff_matrix(peq, dtype, device=cuda_device)
        got = scan.biquad_cascade_block(torch.tensor(x, dtype=dtype, device=cuda_device), cm)
        assert got.device.type == "cuda"
        assert np.abs(got.cpu().numpy() - want).max() <= tol * np.abs(want).max()
    x64 = torch.tensor(x)
    cpu = scan.biquad_cascade_block(x64, scan.peq_coeff_matrix(peq, torch.float64, device=CPU))
    card = scan.biquad_cascade_block(x64.to(cuda_device),
                                     scan.peq_coeff_matrix(peq, torch.float64, device=cuda_device))
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0, atol=1e-12)
