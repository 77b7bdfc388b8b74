// DIA stencil of the node-major Helmholtz operator, for Hopper (sm_90a).
//
// Replaces the TPU kernel mathaudio_tpu/fem/dia.py::_dia_kernel
// (dia_matvec_pallas) and fuses the two epilogues the batched V-cycle
// and GMRES wrap around it (mathaudio_tpu/fem/multigrid_batched.py:301-335,
// mathaudio_tpu/solvers/krylov_batched.py:97,198):
//
//   (Ax)[n, f] = sum_d (K_d[n] - cm_f M_d[n] + cb_f B_d[n]) x[n + off_d, f]
//
//   MATVEC    y = A x
//   RESIDUAL  y = r - A x
//   JACOBI    y = x + omega inv_diag (r - A x),
//             inv_diag = 1/diag where |diag| > 1e-30 else 1,
//             diag = dk - cm dm + cb db (recomputed from the (N,) tables);
//             x == nullptr is the x = 0 pre-smooth: y = omega inv_diag r.
//
// x, r, y are (N, F) complex, row-major, frequencies minor; K/M/B are the
// frequency-shared real (D, N) diagonal tables; cm, cb are (F,) complex.
//
// Bound on the card: bytes. Per output the kernel does ~15 flops per
// diagonal (D = 15 on box meshes) against 16 bytes of x and y (complex64),
// below the H100's flop:byte balance, so the design aims at reading x once
// from HBM and writing y once:
// - one thread per (n, f) output, f fastest across the warp, so each
//   warp's reads of x[n + off, f0:f0+32] are one coalesced 256-byte row
//   segment, and the table reads K_d[n] are warp-wide broadcasts;
// - blocks are ordered frequency-tile fastest, so the rows n + off that
//   neighbouring node tiles share (the halo is up to (n+1)^2+(n+1)+1 rows)
//   are still in the 50 MB L2 when the next node tile reads them;
// - the complex per-lane coefficient is formed in registers; the TPU
//   kernel's interleaved-lane rolls have no counterpart here;
// - rows with n + off outside [0, N) are skipped (their table entries are
//   zero), so x needs no padded copy.
// Shared-memory tile+halo staging and TMA are left to a later change.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxDiagonals = 32;
constexpr int kBlockF = 32;  // frequencies per block: one warp row
constexpr int kBlockN = 8;   // nodes per block

enum Mode : int { kMatvec = 0, kResidual = 1, kJacobi = 2 };

template <typename R> struct ComplexOf;
template <> struct ComplexOf<float> { using type = float2; };
template <> struct ComplexOf<double> { using type = double2; };

__device__ __forceinline__ float magnitude(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double magnitude(double a, double b) { return hypot(a, b); }

struct Offsets {
  int v[kMaxDiagonals];
};

template <typename R>
struct Args {
  using C = typename ComplexOf<R>::type;
  int n, f, d, f_blocks;
  Offsets off;
  const R* k;   // (D, N)
  const R* m;
  const R* b;
  const R* dk;  // (N,) main diagonals, JACOBI only
  const R* dm;
  const R* db;
  const C* cm;  // (F,)
  const C* cb;
  const C* x;   // (N, F); nullptr in JACOBI means x = 0
  const C* r;   // (N, F); unused by MATVEC
  C* y;         // (N, F)
  R omega;
};

template <typename R, int MODE>
__global__ void __launch_bounds__(kBlockF * kBlockN) dia_stencil_kernel(const Args<R> a) {
  using C = typename ComplexOf<R>::type;
  const int f = (blockIdx.x % a.f_blocks) * kBlockF + threadIdx.x;
  const int n = (blockIdx.x / a.f_blocks) * kBlockN + threadIdx.y;
  if (f >= a.f || n >= a.n) return;
  const C cm = a.cm[f];
  const C cb = a.cb[f];

  R acc_re = 0, acc_im = 0;
  if (a.x != nullptr) {
    for (int d = 0; d < a.d; ++d) {
      const int j = n + a.off.v[d];
      if (j < 0 || j >= a.n) continue;
      const size_t t = static_cast<size_t>(d) * a.n + n;
      const R kv = a.k[t], mv = a.m[t], bv = a.b[t];
      const R c_re = kv - cm.x * mv + cb.x * bv;
      const R c_im = -(cm.y * mv) + cb.y * bv;
      const C xv = a.x[static_cast<size_t>(j) * a.f + f];
      acc_re += c_re * xv.x - c_im * xv.y;
      acc_im += c_re * xv.y + c_im * xv.x;
    }
  }

  const size_t o = static_cast<size_t>(n) * a.f + f;
  C out;
  if (MODE == kMatvec) {
    out.x = acc_re;
    out.y = acc_im;
  } else {
    const C rv = a.r[o];
    const R s_re = rv.x - acc_re;
    const R s_im = rv.y - acc_im;
    if (MODE == kResidual) {
      out.x = s_re;
      out.y = s_im;
    } else {
      const R g_re = a.dk[n] - cm.x * a.dm[n] + cb.x * a.db[n];
      const R g_im = -(cm.y * a.dm[n]) + cb.y * a.db[n];
      R i_re = 1, i_im = 0;
      const R mag = magnitude(g_re, g_im);
      if (mag > static_cast<R>(1e-30)) {
        // 1/g = conj(g/|g|)/|g|, scaled so |g|^2 never under/overflows
        const R s = static_cast<R>(1) / mag;
        i_re = (g_re * s) * s;
        i_im = -(g_im * s) * s;
      }
      const R w_re = a.omega * i_re;
      const R w_im = a.omega * i_im;
      out.x = w_re * s_re - w_im * s_im;
      out.y = w_re * s_im + w_im * s_re;
      if (a.x != nullptr) {
        const C xo = a.x[o];
        out.x += xo.x;
        out.y += xo.y;
      }
    }
  }
  a.y[o] = out;
}

template <typename R>
int launch(int mode, int n, int f, int d, const int* offsets, const void* k,
           const void* m, const void* b, const void* dk, const void* dm,
           const void* db, const void* cm, const void* cb, const void* x,
           const void* r, void* y, double omega, void* stream) {
  using C = typename ComplexOf<R>::type;
  if (n <= 0 || f <= 0) return static_cast<int>(cudaSuccess);
  if (d < 1 || d > kMaxDiagonals) return static_cast<int>(cudaErrorInvalidValue);
  Args<R> a;
  a.n = n;
  a.f = f;
  a.d = d;
  a.f_blocks = (f + kBlockF - 1) / kBlockF;
  for (int i = 0; i < kMaxDiagonals; ++i) a.off.v[i] = i < d ? offsets[i] : 0;
  a.k = static_cast<const R*>(k);
  a.m = static_cast<const R*>(m);
  a.b = static_cast<const R*>(b);
  a.dk = static_cast<const R*>(dk);
  a.dm = static_cast<const R*>(dm);
  a.db = static_cast<const R*>(db);
  a.cm = static_cast<const C*>(cm);
  a.cb = static_cast<const C*>(cb);
  a.x = static_cast<const C*>(x);
  a.r = static_cast<const C*>(r);
  a.y = static_cast<C*>(y);
  a.omega = static_cast<R>(omega);
  const long long blocks = static_cast<long long>(a.f_blocks) * ((n + kBlockN - 1) / kBlockN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kBlockF, kBlockN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kMatvec:
      dia_stencil_kernel<R, kMatvec><<<grid, block, 0, s>>>(a);
      break;
    case kResidual:
      dia_stencil_kernel<R, kResidual><<<grid, block, 0, s>>>(a);
      break;
    case kJacobi:
      dia_stencil_kernel<R, kJacobi><<<grid, block, 0, s>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers
// except ``offsets`` (host, d ints); ``stream`` is a cudaStream_t. Returns
// the cudaError_t of the launch (0 = success).
extern "C" {

int dia_stencil_c64(int mode, int n, int f, int d, const int* offsets,
                    const void* k, const void* m, const void* b,
                    const void* dk, const void* dm, const void* db,
                    const void* cm, const void* cb, const void* x,
                    const void* r, void* y, double omega, void* stream) {
  return launch<float>(mode, n, f, d, offsets, k, m, b, dk, dm, db, cm, cb, x,
                       r, y, omega, stream);
}

int dia_stencil_c128(int mode, int n, int f, int d, const int* offsets,
                     const void* k, const void* m, const void* b,
                     const void* dk, const void* dm, const void* db,
                     const void* cm, const void* cb, const void* x,
                     const void* r, void* y, double omega, void* stream) {
  return launch<double>(mode, n, f, d, offsets, k, m, b, dk, dm, db, cm, cb, x,
                        r, y, omega, stream);
}

}  // extern "C"
