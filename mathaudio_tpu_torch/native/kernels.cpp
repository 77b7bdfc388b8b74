// Host-side setup kernels of the port (C ABI, loaded through ctypes).
//
// The device owns the solve; this file holds the sequential
// pointer-chasing setup that Python loops handle poorly: the ILU(0)
// factorization of the FMM near-field matrix (math-solvers/src/
// preconditioners/ilu.rs:16), in place on a CSR matrix.
//
// Built at first use by mathaudio_tpu_torch/native/__init__.py:
//   g++ -O3 -march=native -shared -fPIC kernels.cpp -o libmathaudio_native.so

#include <cstdint>
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

}  // extern "C"
