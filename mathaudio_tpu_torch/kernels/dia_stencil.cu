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
// What bounds it on this card. Per output the stencil does ~15 flops per
// diagonal (D = 15 on box meshes) against 16-24 bytes of x, r and y
// (complex64) from device memory: by the roofline the bound is bytes. But
// every row of x feeds D outputs at D node offsets, and x (152 MB at 9261 x
// 2048) does not fit the 50 MB L2, so what the kernel pays for is how often
// each row of x crosses L2 -> SM, the load instructions that carry it, and
// the latency of those loads, which only resident warps hide. The first
// design (one output per thread, a load of x and of K/M/B per diagonal)
// moved each row of x about 8 times and issued 60 loads per output.
//
// The design:
// - A block owns a tile of T = 16 P consecutive nodes and 256 bytes of
//   lanes (32 complex64 or 16 complex128 lanes). Its 256 threads are 16
//   node groups x 16 units of 16 bytes (two complex64 lanes or one
//   complex128 lane); each thread computes P consecutive nodes of one unit.
// - The windows of x the tile needs, [n0 + off, n0 + off + T) for every
//   offset, merge into a few intervals: on the box stencil the z-1, z and
//   z+1 planes of the 3D neighbourhood once T >= 22. The host merges them
//   (fem/dia.py stencil_plan) and the block stages them into shared memory
//   with cp.async, 16 bytes a copy: a row of x crosses L2 -> SM (3T + 88)/T
//   times per lane tile (5.75 at T = 32) instead of ~8. Blocks run
//   node-tile fastest, so the rows a tile re-reads were fetched from device
//   memory by its neighbours moments before and are still in L2.
// - Each plane is its own cp.async group: the block works through the z-1
//   plane's diagonals while the z and z+1 planes are still arriving.
// - The block's K/M/B come into shared memory once, packed as (k, m, b) per
//   (diagonal, node): one broadcast load per diagonal and node, shared by a
//   unit's lanes, instead of three per output.
// - The diagonal count and the runs of consecutive offsets are compile-time
//   (the box stencil's 15 diagonals in runs 2,2,2,3,2,2,2; a generic
//   instantiation takes any 1 <= D <= 32 with runs of 1): the loop is fully
//   unrolled, and inside a run a thread keeps the P + len - 1 rows of x it
//   needs in registers, so a row loaded once serves len diagonals.
// - Latency is hidden by resident blocks, so registers and shared memory
//   are budgeted for four blocks (32 warps) per SM at P = 2; the host picks
//   P by the launch's block count, so the 32-lane anchor launches still
//   fill 132 SMs.
// - Rows outside [0, N) and lanes beyond F are staged as zeros (their
//   table entries are zero too), so x needs no padded copy; tiles whose
//   windows stay inside the band and whose lanes are whole skip the checks.
// - The complex per-lane coefficient is formed in registers; the TPU
//   kernel's interleaved-lane rolls have no counterpart here. The Jacobi
//   epilogue reads x[n] from the staged offset-0 row and takes 1/|diag|
//   from rhypot, which neither over- nor underflows.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxDiagonals = 32;
constexpr int kMaxWindows = 32;
constexpr int kUnits = 16;   // 16-byte units of a row per block: 256 bytes of lanes
constexpr int kGroups = 16;  // node groups per block
constexpr int kThreads = kUnits * kGroups;
constexpr int kSharedLimit = 232448;  // dynamic shared memory a block may use

enum Mode : int { kMatvec = 0, kResidual = 1, kJacobi = 2 };
// kBoxPlanes: the box stencil whose three windows hold runs {0, 1}, {2, 3, 4}
// and {5, 6}, staged as three cp.async groups.
enum Kind : int { kGeneric = 0, kBox = 1, kBoxPlanes = 2 };

// Runs of consecutive offsets, in diagonal order.
struct Generic {
  static constexpr int kRuns = kMaxDiagonals;
  static constexpr int kMaxRun = 1;
  __host__ __device__ static constexpr int run(int) { return 1; }
};
struct Box {  // (-s^2-s-1, -s^2-s) (-s^2-1, -s^2) (-s-1, -s) (-1, 0, 1) (s, s+1) ...
  static constexpr int kRuns = 7;
  static constexpr int kMaxRun = 3;
  __host__ __device__ static constexpr int run(int i) { return i == 3 ? 3 : 2; }
};

template <typename R> struct Traits;

template <> struct Traits<float> {
  using C = float2;
  using V = float4;  // one 16-byte unit: two lanes
  static constexpr int kLanes = 2;
  static constexpr int kTabBytes = 16;
  __device__ static C lane(const V& v, int l) {
    return l == 0 ? make_float2(v.x, v.y) : make_float2(v.z, v.w);
  }
  __device__ static V pack(const C* c) { return make_float4(c[0].x, c[0].y, c[1].x, c[1].y); }
  __device__ static void store_tab(unsigned char* t, int i, float k, float m, float b) {
    reinterpret_cast<float4*>(t)[i] = make_float4(k, m, b, 0.f);
  }
  __device__ static void load_tab(const unsigned char* t, int i, float& k, float& m, float& b) {
    const float4 v = reinterpret_cast<const float4*>(t)[i];
    k = v.x;
    m = v.y;
    b = v.z;
  }
};

template <> struct Traits<double> {
  using C = double2;
  using V = double2;  // one 16-byte unit: one lane
  static constexpr int kLanes = 1;
  static constexpr int kTabBytes = 32;
  __device__ static C lane(const V& v, int) { return v; }
  __device__ static V pack(const C* c) { return c[0]; }
  __device__ static void store_tab(unsigned char* t, int i, double k, double m, double b) {
    double2* p = reinterpret_cast<double2*>(t) + 2 * i;
    p[0] = make_double2(k, m);
    p[1] = make_double2(b, 0.0);
  }
  __device__ static void load_tab(const unsigned char* t, int i, double& k, double& m, double& b) {
    const double2* p = reinterpret_cast<const double2*>(t) + 2 * i;
    const double2 km = p[0];
    k = km.x;
    m = km.y;
    b = p[1].x;
  }
};

__device__ __forceinline__ float inv_magnitude(float a, float b) { return rhypotf(a, b); }
__device__ __forceinline__ double inv_magnitude(double a, double b) { return rhypot(a, b); }

// Blocks per SM the registers are budgeted for: four in float (at P = 2 the
// bench tile's shared memory allows as many), three in double.
template <typename R>
constexpr int min_blocks() {
  return sizeof(R) == 8 ? 3 : 4;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename R>
struct Args {
  using C = typename Traits<R>::C;
  int n, f, nd;
  int node_tiles;
  int planes;     // kind kBoxPlanes: wait for x plane by plane
  int vec16;      // x, r, y rows start 16-byte aligned: whole units move as one 16-byte access
  int rows;       // staged rows of x in all windows
  int self_base;  // staged row of offset 0 for the tile's first node, or -1
  int lo, hi;     // least and greatest offset
  int nw;         // windows
  int base[kMaxDiagonals];    // staged row of diagonal d for the tile's first node
  int win_off[kMaxWindows];   // first row of window w, relative to the tile's first node
  int win_base[kMaxWindows];  // its first staged row
  int win_len[kMaxWindows];   // its rows
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

// The lanes [f, f + kLanes) of one row at p (lanes at or beyond nf read 0).
template <typename R>
__device__ __forceinline__ void load_lanes(const typename Traits<R>::C* p, int f, int nf,
                                           bool vec16, typename Traits<R>::C* out) {
  using Tr = Traits<R>;
  if (vec16 && f + Tr::kLanes <= nf) {
    const typename Tr::V v = *reinterpret_cast<const typename Tr::V*>(p);
#pragma unroll
    for (int l = 0; l < Tr::kLanes; ++l) out[l] = Tr::lane(v, l);
  } else {
#pragma unroll
    for (int l = 0; l < Tr::kLanes; ++l) {
      out[l] = typename Tr::C{};
      if (f + l < nf) out[l] = p[l];
    }
  }
}

template <typename R>
__device__ __forceinline__ void store_lanes(typename Traits<R>::C* p, int f, int nf, bool vec16,
                                            const typename Traits<R>::C* in) {
  using Tr = Traits<R>;
  if (vec16 && f + Tr::kLanes <= nf) {
    *reinterpret_cast<typename Tr::V*>(p) = Tr::pack(in);
  } else {
#pragma unroll
    for (int l = 0; l < Tr::kLanes; ++l)
      if (f + l < nf) p[l] = in[l];
  }
}

// Copy one 16-byte unit of x (row ``row``, first lane ``f``) into shared
// memory, with zeros for rows outside [0, N) and lanes beyond F.
template <typename R>
__device__ __forceinline__ void stage_unit(typename Traits<R>::V* dst, const Args<R>& a, int row,
                                           int f) {
  using Tr = Traits<R>;
  using C = typename Tr::C;
  C* lanes = reinterpret_cast<C*>(dst);
  if (row < 0 || row >= a.n) {
#pragma unroll
    for (int l = 0; l < Tr::kLanes; ++l) lanes[l] = C{};
    return;
  }
  const C* src = a.x + static_cast<size_t>(row) * a.f + f;
  if (a.vec16 && f + Tr::kLanes <= a.f) {
    cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int l = 0; l < Tr::kLanes; ++l) {
    if (f + l >= a.f) {
      lanes[l] = C{};
    } else if (sizeof(C) == 16) {
      cp_async16(lanes + l, src + l);
    } else {
      cp_async8(lanes + l, src + l);
    }
  }
}

// Wait for the windows run ``run`` reads, and make every thread's copies
// visible. With planes, the three windows are three cp.async groups that
// runs 0, 2 and 5 open; otherwise run 0 waits for all.
template <class Runs>
__device__ __forceinline__ void wait_for_run(int run, bool planes) {
  if (planes) {
    if (run == 0) cp_async_wait_group<2>();
    if (run == 2) cp_async_wait_group<1>();
    if (run == 5) cp_async_wait_group<0>();
    if (run == 0 || run == 2 || run == 5) __syncthreads();
  } else if (run == 0) {
    cp_async_wait_group<0>();
    __syncthreads();
  }
}

template <typename R, int MODE, int P, class Runs>
__global__ void __launch_bounds__(kThreads, min_blocks<R>())
    dia_stencil_kernel(const __grid_constant__ Args<R> a) {
  using Tr = Traits<R>;
  using C = typename Tr::C;
  using V = typename Tr::V;
  constexpr int T = kGroups * P;  // nodes per tile
  constexpr int L = Tr::kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  V* xs = reinterpret_cast<V*>(smem);
  unsigned char* tab = smem + static_cast<size_t>(a.rows) * kUnits * sizeof(V);

  const int node_tile = blockIdx.x % a.node_tiles;  // node tiles fastest: L2 reuse of x
  const int lane_tile = blockIdx.x / a.node_tiles;
  const int n0 = node_tile * T;
  const int u = threadIdx.x % kUnits;
  const int t0 = (threadIdx.x / kUnits) * P;  // this thread's first node in the tile
  const int lane0 = lane_tile * kUnits * L;   // the block's first lane
  const int f0 = lane0 + u * L;               // this thread's first lane
  const bool have_x = a.x != nullptr;
  const bool planes = a.planes != 0;

  if (have_x) {
    // x windows, asynchronously; interior tiles skip every check
    const bool interior =
        n0 + a.lo >= 0 && n0 + T + a.hi <= a.n && lane0 + kUnits * L <= a.f && a.vec16;
    for (int w = 0; w < a.nw; ++w) {
      const int row0 = n0 + a.win_off[w];
      V* dst = xs + static_cast<size_t>(a.win_base[w]) * kUnits;
      const int count = a.win_len[w] * kUnits;
      if (interior) {
        const C* src = a.x + static_cast<size_t>(row0) * a.f + lane0;
        for (int i = threadIdx.x; i < count; i += kThreads)
          cp_async16(dst + i, src + static_cast<size_t>(i / kUnits) * a.f + (i % kUnits) * L);
      } else {
        for (int i = threadIdx.x; i < count; i += kThreads)
          stage_unit<R>(dst + i, a, row0 + i / kUnits, lane0 + (i % kUnits) * L);
      }
      if (planes) cp_async_commit();
    }
    if (!planes) cp_async_commit();
    // the tile's K/M/B, packed, while the copies fly
    for (int i = threadIdx.x; i < a.nd * T; i += kThreads) {
      const int d = i / T;
      const int node = n0 + i % T;
      R kv = 0, mv = 0, bv = 0;
      if (node < a.n) {
        const size_t o = static_cast<size_t>(d) * a.n + node;
        kv = a.k[o];
        mv = a.m[o];
        bv = a.b[o];
      }
      Tr::store_tab(tab, i, kv, mv, bv);
    }
  }

  C cm[L], cb[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    cm[l] = C{};
    cb[l] = C{};
    if (f0 + l < a.f) {
      cm[l] = a.cm[f0 + l];
      cb[l] = a.cb[f0 + l];
    }
  }

  C acc[P][L];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int l = 0; l < L; ++l) acc[p][l] = C{};

  if (have_x) {
    int d = 0;
#pragma unroll
    for (int run = 0; run < Runs::kRuns; ++run) {
      constexpr int kMaxWin = P + Runs::kMaxRun - 1;
      const int len = Runs::run(run);
      if (d >= a.nd) break;  // generic instantiation: fewer than 32 diagonals
      wait_for_run<Runs>(run, planes);
      const V* xrow = xs + static_cast<size_t>(a.base[d] + t0) * kUnits + u;
      V xw[kMaxWin];
#pragma unroll
      for (int i = 0; i < kMaxWin; ++i)
        if (i < P + len - 1) xw[i] = xrow[i * kUnits];
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int j = 0; j < Runs::kMaxRun; ++j) {
          if (j >= len) break;
          R kv, mv, bv;
          Tr::load_tab(tab, (d + j) * T + t0 + p, kv, mv, bv);
#pragma unroll
          for (int l = 0; l < L; ++l) {
            const C xv = Tr::lane(xw[p + j], l);
            const R c_re = kv - cm[l].x * mv + cb[l].x * bv;
            const R c_im = -(cm[l].y * mv) + cb[l].y * bv;
            acc[p][l].x += c_re * xv.x - c_im * xv.y;
            acc[p][l].y += c_re * xv.y + c_im * xv.x;
          }
        }
      }
      d += len;
    }
  }

  const bool vec16 = a.vec16 != 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int n = n0 + t0 + p;
    if (n >= a.n || f0 >= a.f) continue;
    const size_t o = static_cast<size_t>(n) * a.f + f0;
    C out[L];
    if (MODE == kMatvec) {
#pragma unroll
      for (int l = 0; l < L; ++l) out[l] = acc[p][l];
    } else {
      C rv[L];
      load_lanes<R>(a.r + o, f0, a.f, vec16, rv);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        out[l].x = rv[l].x - acc[p][l].x;
        out[l].y = rv[l].y - acc[p][l].y;
      }
      if (MODE == kJacobi) {
        const R dkv = a.dk[n], dmv = a.dm[n], dbv = a.db[n];
        C xo[L];
        if (have_x) {
          if (a.self_base >= 0) {
            const V v = xs[static_cast<size_t>(a.self_base + t0 + p) * kUnits + u];
#pragma unroll
            for (int l = 0; l < L; ++l) xo[l] = Tr::lane(v, l);
          } else {
            load_lanes<R>(a.x + o, f0, a.f, vec16, xo);
          }
        }
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const R g_re = dkv - cm[l].x * dmv + cb[l].x * dbv;
          const R g_im = -(cm[l].y * dmv) + cb[l].y * dbv;
          R i_re = 1, i_im = 0;
          const R s = inv_magnitude(g_re, g_im);  // 1/|g|; inf at g = 0
          if (s < static_cast<R>(1e30)) {
            // 1/g = conj(g/|g|)/|g|, scaled so |g|^2 never under/overflows
            i_re = (g_re * s) * s;
            i_im = -(g_im * s) * s;
          }
          const R w_re = a.omega * i_re;
          const R w_im = a.omega * i_im;
          const R s_re = out[l].x, s_im = out[l].y;
          out[l].x = w_re * s_re - w_im * s_im;
          out[l].y = w_re * s_im + w_im * s_re;
          if (have_x) {
            out[l].x += xo[l].x;
            out[l].y += xo[l].y;
          }
        }
      }
    }
    store_lanes<R>(a.y + o, f0, a.f, vec16, out);
  }
}

template <typename R, int MODE, int P, class Runs>
cudaError_t launch_one(const Args<R>& a, unsigned grid, size_t shared, cudaStream_t s) {
  auto kernel = dia_stencil_kernel<R, MODE, P, Runs>;
  static bool configured = false;  // per instantiation: lift the 48 KB default once
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedLimit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<grid, kThreads, shared, s>>>(a);
  return cudaGetLastError();
}

template <typename R, int P, class Runs>
cudaError_t launch_mode(int mode, const Args<R>& a, unsigned grid, size_t shared,
                        cudaStream_t s) {
  switch (mode) {
    case kMatvec:
      return launch_one<R, kMatvec, P, Runs>(a, grid, shared, s);
    case kResidual:
      return launch_one<R, kResidual, P, Runs>(a, grid, shared, s);
    case kJacobi:
      return launch_one<R, kJacobi, P, Runs>(a, grid, shared, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename R, class Runs>
cudaError_t launch_rows(int mode, int p, const Args<R>& a, unsigned grid, size_t shared,
                        cudaStream_t s) {
  switch (p) {
    case 1:
      return launch_mode<R, 1, Runs>(mode, a, grid, shared, s);
    case 2:
      return launch_mode<R, 2, Runs>(mode, a, grid, shared, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename R>
int launch(int mode, const int* plan, int n, int f, int d, int vec16, const void* k,
           const void* m, const void* b, const void* dk, const void* dm, const void* db,
           const void* cm, const void* cb, const void* x, const void* r, void* y, double omega,
           void* stream) {
  using Tr = Traits<R>;
  using C = typename Tr::C;
  if (n <= 0 || f <= 0) return static_cast<int>(cudaSuccess);
  // plan: kind, rows per thread, staged rows, staged row of offset 0, least
  // and greatest offset, windows; then base[d], win_off[nw], win_base[nw],
  // win_len[nw]
  const int kind = plan[0], p = plan[1], nw = plan[6];
  if (d < 1 || d > kMaxDiagonals || nw < 1 || nw > kMaxWindows || plan[2] < 1 ||
      (kind != kGeneric && d != 15) || (kind == kBoxPlanes && nw != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<R> a{};
  a.n = n;
  a.f = f;
  a.nd = d;
  a.planes = kind == kBoxPlanes;
  a.vec16 = vec16;
  a.rows = plan[2];
  a.self_base = plan[3];
  a.lo = plan[4];
  a.hi = plan[5];
  a.nw = nw;
  const int* tail = plan + 7;
  for (int i = 0; i < d; ++i) a.base[i] = tail[i];
  for (int w = 0; w < nw; ++w) {
    a.win_off[w] = tail[d + w];
    a.win_base[w] = tail[d + nw + w];
    a.win_len[w] = tail[d + 2 * nw + w];
  }
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
  const int tile = kGroups * p;
  const int lanes_per_tile = kUnits * Tr::kLanes;
  a.node_tiles = (n + tile - 1) / tile;
  const long long blocks =
      static_cast<long long>(a.node_tiles) * ((f + lanes_per_tile - 1) / lanes_per_tile);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = x == nullptr ? 0
                                     : static_cast<size_t>(a.rows) * kUnits * sizeof(typename Tr::V) +
                                           static_cast<size_t>(d) * tile * Tr::kTabBytes;
  if (shared > static_cast<size_t>(kSharedLimit)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  const cudaError_t err = kind == kGeneric
                              ? launch_rows<R, Generic>(mode, p, a, grid, shared, s)
                              : launch_rows<R, Box>(mode, p, a, grid, shared, s);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers
// except ``plan``, a host int array that fem/dia.py stencil_plan builds
// once per launch shape: kind (0 generic, 1 box, 2 box staged plane by
// plane), rows per thread (1 or 2), staged rows, staged row of offset 0
// (-1 without one), least and greatest offset, window count, then the
// staged row of each diagonal and each window's first row, staged row and
// length. ``stream`` is a cudaStream_t. Returns the cudaError_t of the
// launch (0 = success).
extern "C" {

int dia_stencil_c64(int mode, const int* plan, int n, int f, int d, int vec16, const void* k,
                    const void* m, const void* b, const void* dk, const void* dm, const void* db,
                    const void* cm, const void* cb, const void* x, const void* r, void* y,
                    double omega, void* stream) {
  return launch<float>(mode, plan, n, f, d, vec16, k, m, b, dk, dm, db, cm, cb, x, r, y, omega,
                       stream);
}

int dia_stencil_c128(int mode, const int* plan, int n, int f, int d, int vec16, const void* k,
                     const void* m, const void* b, const void* dk, const void* dm,
                     const void* db, const void* cm, const void* cb, const void* x,
                     const void* r, void* y, double omega, void* stream) {
  return launch<double>(mode, plan, n, f, d, vec16, k, m, b, dk, dm, db, cm, cb, x, r, y, omega,
                        stream);
}

}  // extern "C"
