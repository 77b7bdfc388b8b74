"""Port vs reference: the host C++ library's Python contract (native/).

``load_native()`` builds and returns the loaded library, as the
reference's does (the port's raises where the reference's would return
None after a failed build). ``ilu0_factor_inplace`` returns True, the
reference's "the native path ran", and its factors on a seeded 50 x 50
complex CSR equal the reference's to 1e-12 (both run the same C++ loop:
the difference is 0.0 on one host). ``pmis_coarsen`` and
``greedy_coloring`` are held against the reference in
tests/test_torch_preconditioners.py.
"""

import ctypes

import numpy as np
import pytest
import scipy.sparse

import mathaudio_tpu.native as jax_native
import mathaudio_tpu_torch.native as native

N = 50
ATOL = 1e-12


def _csr(seed=0):
    """A diagonally dominant complex CSR with sorted, unique columns."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))) * 0.1
    a[rng.random((N, N)) < 0.8] = 0.0
    a[np.arange(N), np.arange(N)] = 4.0 + 1j * rng.standard_normal(N)
    m = scipy.sparse.csr_matrix(a)
    m.sort_indices()
    return m


def test_load_native_builds_and_returns_the_library():
    lib = native.load_native()
    assert isinstance(lib, ctypes.CDLL) and lib is native.load()
    for name in ("ilu0_factor_complex", "pmis_coarsen", "greedy_coloring"):
        assert hasattr(lib, name)
    assert jax_native.load_native() is not None


def test_ilu0_returns_true_and_matches_the_reference():
    m = _csr()
    data = np.ascontiguousarray(m.data, np.complex128).copy()
    ref = data.copy()
    assert native.ilu0_factor_inplace(m.indptr, m.indices, data) is True
    assert jax_native.ilu0_factor_inplace(m.indptr, m.indices, ref) is True
    assert not np.array_equal(data, m.data)  # factored in place
    np.testing.assert_allclose(data, ref, rtol=0, atol=ATOL)


def test_ilu0_still_raises_on_data_it_cannot_factor_in_place():
    m = _csr()
    with pytest.raises(ValueError, match="complex128"):
        native.ilu0_factor_inplace(m.indptr, m.indices, np.abs(m.data))
    with pytest.raises(ValueError, match="disagree"):
        native.ilu0_factor_inplace(m.indptr, m.indices,
                                   np.ascontiguousarray(m.data[:-1], np.complex128))
