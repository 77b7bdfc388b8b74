// Host-side setup kernels of the port (C ABI, loaded through ctypes).
//
// The device owns the solve; this file holds the sequential
// pointer-chasing setup that Python loops handle poorly: the ILU(0)
// factorization of the FMM near-field matrix and of the general FEM
// problem (math-solvers/src/preconditioners/ilu.rs:16), in place on a CSR
// matrix; PMIS coarsening for AMG (amg.rs PMIS variant); greedy
// multicoloring for the colored ILU.
//
// Built at first use by mathaudio_tpu_torch/native/__init__.py:
//   g++ -O3 -march=native -shared -fPIC kernels.cpp -o libmathaudio_native.so

#include <cstdint>
#include <cstring>
#include <complex>
#include <vector>

extern "C" {

// In-place ILU(0) on a CSR matrix with complex128 values (IKJ variant,
// no fill). A zero or missing pivot skips its column update, as the
// Python twin (preconditioners/ilu.py::_ilu0_factor_python) does. Returns 0.
int ilu0_factor_complex(
    const int64_t* indptr,
    const int32_t* indices,
    std::complex<double>* data,
    int64_t n)
{
    // column -> slot of the current row, rebuilt as a scatter array
    std::vector<int64_t> pos(n, -1);
    // slot of each row's diagonal entry (-1: none)
    std::vector<int64_t> diag(n, -1);
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t q = indptr[i]; q < indptr[i + 1]; ++q) {
            if (indices[q] == i) { diag[i] = q; break; }
        }
    }
    for (int64_t i = 1; i < n; ++i) {
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) pos[indices[p]] = p;

        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            int64_t k = indices[p];
            if (k >= i) continue;
            int64_t dk_slot = diag[k];
            if (dk_slot < 0 || data[dk_slot] == std::complex<double>(0.0, 0.0)) continue;
            data[p] /= data[dk_slot];
            std::complex<double> lik = data[p];
            for (int64_t q = indptr[k]; q < indptr[k + 1]; ++q) {
                int64_t j = indices[q];
                if (j <= k) continue;
                int64_t pij = pos[j];
                if (pij >= 0) data[pij] -= lik * data[q];
            }
        }
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) pos[indices[p]] = -1;
    }
    return 0;
}

// PMIS independent-set coarsening on a symmetrized strength graph.
// state_out: 1 = coarse, -1 = fine. weights: degree + random tiebreak.
// Each pass marks every undecided node that no undecided neighbour
// outweighs as coarse and its undecided neighbours as fine; a pass that
// finds none promotes the heaviest undecided node. The Python twin is
// preconditioners/amg.py::_pmis_python.
void pmis_coarsen(
    const int64_t* indptr,
    const int32_t* indices,
    const double* weights,
    int8_t* state_out,
    int64_t n)
{
    std::memset(state_out, 0, n * sizeof(int8_t));
    int64_t undecided = n;
    std::vector<int64_t> new_coarse;
    new_coarse.reserve(256);
    while (undecided > 0) {
        new_coarse.clear();
        for (int64_t i = 0; i < n; ++i) {
            if (state_out[i] != 0) continue;
            bool wmax = true;
            for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
                int64_t j = indices[p];
                if (state_out[j] == 0 && weights[j] > weights[i]) { wmax = false; break; }
            }
            if (wmax) new_coarse.push_back(i);
        }
        if (new_coarse.empty()) {
            int64_t best = -1;
            double wbest = -1.0;
            for (int64_t i = 0; i < n; ++i)
                if (state_out[i] == 0 && weights[i] > wbest) { wbest = weights[i]; best = i; }
            if (best < 0) break;
            new_coarse.push_back(best);
        }
        for (int64_t i : new_coarse) {
            state_out[i] = 1;
            for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
                int64_t j = indices[p];
                if (state_out[j] == 0) state_out[j] = -1;
            }
        }
        undecided = 0;
        for (int64_t i = 0; i < n; ++i) if (state_out[i] == 0) ++undecided;
    }
}

// Greedy multicoloring of a (symmetrized) sparsity graph in row order:
// each row takes the smallest color none of its already colored
// neighbours has. The Python twin is
// preconditioners/ilu.py::_greedy_coloring_python.
void greedy_coloring(
    const int64_t* indptr,
    const int32_t* indices,
    int32_t* colors_out,
    int64_t n)
{
    for (int64_t i = 0; i < n; ++i) colors_out[i] = -1;
    std::vector<int64_t> stamp(256, -1);  // stamp[c] == i: color c is taken at row i
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            int32_t cj = colors_out[indices[p]];
            if (cj >= 0) {
                if ((size_t)cj >= stamp.size()) stamp.resize(cj + 64, -1);
                stamp[cj] = i;
            }
        }
        int32_t c = 0;
        while ((size_t)c < stamp.size() && stamp[c] == i) ++c;
        colors_out[i] = c;
    }
}

}  // extern "C"
