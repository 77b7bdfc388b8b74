"""Port vs reference: the host builders of parallel/spmd.py and
parallel/fmm_spmd.py, index for index, with no process group.

On the same seeded numpy inputs in float64: ``shard_ell`` (with its
wide-bandwidth ValueError), ``DeviceSchwarz.from_csr`` (with its block-size
warning), ``build_sharded_system``, ``shard_dense_rows``, and, on the
reference's own operator data carried across as numpy arrays,
``shard_slfmm`` and ``shard_mlfmm_tree``. Index tables are equal; values
agree within 1e-12 of their largest entry (the Schwarz inverses come from
two LAPACKs).
"""

import numpy as np
import pytest
import torch

from _torch_parallel_ranks import slfmm_data, tree_data
from mathaudio_tpu.bem.fmm import MlfmmLevel, build_mlfmm_tree_system, build_slfmm_system
from mathaudio_tpu.bem.mesh import icosphere
from mathaudio_tpu.parallel import fmm_spmd as jax_fmm_spmd
from mathaudio_tpu.parallel import spmd as jax_spmd
from mathaudio_tpu.solvers.sparse import CsrMatrix as JaxCsr
from mathaudio_tpu_torch.parallel import fmm_spmd, spmd
from mathaudio_tpu_torch.solvers.preconditioners import schwarz as port_schwarz
from mathaudio_tpu_torch.solvers.sparse import CsrMatrix

N = 50
CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tridiagonal(n, k=2.0):
    h = 1.0 / (n + 1)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([(2.0 / h**2 - k**2) * np.ones(n), (-1.0 / h**2) * np.ones(n - 1),
                           (-1.0 / h**2) * np.ones(n - 1)]).astype(complex)
    vals[:n] += 1j * 0.3 * k
    return rows, cols, vals


def _pair(rows, cols, vals, n):
    """(reference CSR, port CSR) of the same triplets."""
    return (JaxCsr.from_triplets(rows, cols, vals, (n, n)),
            CsrMatrix.from_triplets(rows, cols, vals, (n, n)))


def _equal(got, want, tol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if tol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        scale = np.abs(want).max() if want.size else 1.0
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_partition_and_ring():
    for n, s in ((50, 4), (48, 4), (7, 8), (1, 1)):
        assert spmd.partition_rows(n, s) == jax_spmd.partition_rows(n, s)
    for s in (1, 2, 5):
        for shift in (1, -1):
            assert spmd._neighbor_perm(s, shift) == jax_spmd._neighbor_perm(s, shift)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_shard_ell_index_for_index(n_shards):
    ref_csr, csr = _pair(*_tridiagonal(N), N)
    want, got = jax_spmd.shard_ell(ref_csr, n_shards), spmd.shard_ell(csr, n_shards, **CPU)
    assert (got.halo, got.n, got.n_shards, got.rows_per_shard) == (
        want.halo, want.n, want.n_shards, want.rows_per_shard)
    _equal(got.indices, want.indices)
    _equal(got.values, want.values)


def test_shard_ell_rejects_wide_bandwidth():
    n = 32
    rows = np.concatenate([np.arange(n), np.arange(n)])
    cols = np.concatenate([np.arange(n), (np.arange(n) + n // 2) % n])
    ref_csr, csr = _pair(rows, cols, np.ones(2 * n), n)
    with pytest.raises(ValueError, match="bandwidth") as want:
        jax_spmd.shard_ell(ref_csr, 8)
    with pytest.raises(ValueError, match="bandwidth") as got:
        spmd.shard_ell(csr, 8, **CPU)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_shards,overlap", [(2, 1), (4, 2), (8, 1)])
def test_device_schwarz_index_for_index(n_shards, overlap):
    ref_csr, csr = _pair(*_tridiagonal(N), N)
    want = jax_spmd.DeviceSchwarz.from_csr(ref_csr, n_shards, overlap)
    got = spmd.DeviceSchwarz.from_csr(csr, n_shards, overlap, **CPU)
    assert got.overlap == want.overlap
    for f in ("gather_idx", "valid", "weights"):
        _equal(getattr(got, f), getattr(want, f))
    _equal(got.inv_blocks, want.inv_blocks, 1e-12)


def test_device_schwarz_warns_on_a_large_block(monkeypatch):
    """One subdomain of 8200 rows: the reference's warning, before any
    dense block is formed (the blocks are stubbed to 1 x 1)."""
    rows, cols, vals = _tridiagonal(8200)
    csr = CsrMatrix.from_triplets(rows, cols, vals, (8200, 8200))
    monkeypatch.setattr(port_schwarz, "csr_diag_blocks",
                        lambda csr, parts, bs: np.ones((len(parts), 1, 1), complex))
    with pytest.warns(UserWarning, match="block size 8200 requires dense 8200x8200"):
        spmd.DeviceSchwarz.from_csr(csr, 1, 1, **CPU)


@pytest.mark.parametrize("overlap", [None, 2])
def test_build_sharded_system_index_for_index(overlap):
    ref_csr, csr = _pair(*_tridiagonal(N), N)
    rhs = np.random.default_rng(3).normal(size=N) + 0.5j
    want = jax_spmd.build_sharded_system(ref_csr, rhs, 4, schwarz_overlap=overlap)
    got = spmd.build_sharded_system(csr, rhs, 4, schwarz_overlap=overlap, **CPU)
    _equal(got.rhs, want.rhs)
    _equal(got.ell.indices, want.ell.indices)
    assert got.ell.halo == want.ell.halo
    assert (got.schwarz is None) == (want.schwarz is None)
    if overlap is not None:
        _equal(got.schwarz.gather_idx, want.schwarz.gather_idx)
        _equal(got.schwarz.inv_blocks, want.schwarz.inv_blocks, 1e-12)


def test_shard_dense_rows_index_for_index():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(30, 30)) + 1j * rng.normal(size=(30, 30))
    rhs = rng.normal(size=30) + 1j * rng.normal(size=30)
    for n_shards in (2, 4, 7):
        for g, w in zip(spmd.shard_dense_rows(a, rhs, n_shards, **CPU),
                        jax_spmd.shard_dense_rows(a, rhs, n_shards)):
            _equal(g, w)
    # a tensor input (the port's) pads the same way
    _equal(spmd.shard_dense_rows(torch.tensor(a), torch.tensor(rhs), 4, **CPU)[0],
           jax_spmd.shard_dense_rows(a, rhs, 4)[0])


def _numpy(data):
    out = {f: (None if getattr(data, f) is None else np.asarray(getattr(data, f)))
           for f in data._fields if f != "levels"}
    if "levels" in data._fields:
        out["levels"] = [{g: (None if getattr(lv, g) is None else np.asarray(getattr(lv, g)))
                          for g in MlfmmLevel._fields} for lv in data.levels]
    return out


def _equal_fields(got, want):
    assert got._fields == want._fields
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if f == "levels":
            assert len(g) == len(w)
            for gl, wl in zip(g, w):
                _equal_fields(gl, wl)
        elif np.issubdtype(np.asarray(w).dtype, np.integer):
            _equal(g, w)
        else:
            _equal(g, w, 1e-15)


@pytest.fixture(scope="module")
def fmm_data():
    slfmm = build_slfmm_system(icosphere(1.0, 2), 2.0, beta=0.5j, stability_tau=1e4).data
    tree = build_mlfmm_tree_system(icosphere(1.0, 3), 4.0, max_per_leaf=16,
                                   stability_tau=1e4).data
    return slfmm, tree


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_shard_slfmm_index_for_index(fmm_data, n_shards):
    ref = fmm_data[0]
    got = fmm_spmd.shard_slfmm(slfmm_data(_numpy(ref)), n_shards)
    _equal_fields(got, jax_fmm_spmd.shard_slfmm(ref, n_shards))
    assert got.t_tensor.shape[0] == n_shards


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_shard_mlfmm_tree_index_for_index(fmm_data, n_shards):
    ref = fmm_data[1]
    assert len(ref.levels) >= 2
    got = fmm_spmd.shard_mlfmm_tree(tree_data(_numpy(ref)), n_shards)
    _equal_fields(got, jax_fmm_spmd.shard_mlfmm_tree(ref, n_shards))
    assert got.levels[-1].trans_op.shape[0] == n_shards


def test_sharded_fmm_casts_like_its_data(fmm_data):
    got = fmm_spmd.shard_slfmm(slfmm_data(_numpy(fmm_data[0])), 2).to(torch.complex64)
    assert got.t_tensor.dtype == torch.complex64 and got.cluster_mask.dtype == torch.float32
    assert got.clusters.dtype == torch.int64
    tree = fmm_spmd.shard_mlfmm_tree(tree_data(_numpy(fmm_data[1])), 2).to(torch.complex64)
    assert all(lv.trans_op.dtype == torch.complex64 for lv in tree.levels)
