// K1's node-block mode, bsr_spmv: the assembled node blocks of a P1
// tetrahedral operator (4 x 4, d = 3) as a block-CSR matrix, for Hopper.
//
// Counterpart of cfdtpu's per-node layout (cfdtpu/la/nodebsr.py, g = 1:
// _ell_gather, _ell_cols and the einsums of apply_element_matrices,
// apply_sub_block and apply_p_coupled over vals["ell"]). It replaces,
// on tetrahedra, K1 (csrc/sup_spmv.cu) on the 16 x 16 supernode layout
// of g = 4 consecutive nodes, which on the DFG 3D-1Z mesh holds 11.6x
// the node blocks' values: each 16 x 16 slot holds 2.7 of its 16
// possible node blocks (mean degree 14.5, 21 slots of 42 filled). Here
// the operator is the node blocks themselves, `vals` (n_blocks, 4, 4)
// row-major, node row i owning blocks rowptr[i] .. rowptr[i+1]-1 with
// block columns cols[k] (int32 both), in the order NodeBSR.assemble
// makes them.
//
//   Y[i, r] = sum_{k in row i} sum_{c in CS} vals[k, r, c] X[cols[k], c]
//   r in RS; RS, CS each all (0..3), u (0..2) or p (3)
//   out[pos(i, r)] = Y                                 mode 0
//                  = b[pos] - Y                        mode 1 (residual)
//                  = x[pos] + dn[pos]                  mode 3 (Chebyshev)
//     dn = ca * (dprev or x)[pos] + cc * (w[pos] * (b[pos] - Y))
// with K1's options around the modes, in K1's order (the row sum, the
// mode, the add, the mask): SCALE (a template parameter: X gathered as
// sc[j] * x[j], and mode 3's x too), the row mask with its values or
// zero (mode 3: identity rows, Y = x there), add (mode 3). These are
// the epilogues NodeBSR's callers pass (la/schur.py, solvers/
// stabilized_schur.py): the outer operator with its Dirichlet rows,
// Auu with its rows and in the chebyshev method's sweep, Aup's zero
// rows, Apu's residual with diag(Auu)^-1 or the 0/1 mask as its scale
// and S's pressure rows, and the plain App and p-column applies.
// X and out are the solver's flat vectors: [u (3n); p (n)] for the
// view all, u (3n) for u, p (n) for p; node c's values are u[3c + j]
// and p[c].
//
// Bound: device memory. Each value is read once and used in one FMA
// (0.5 flop a byte in float32). The outer operator on the DFG 3D-1Z
// mesh (243,018 nodes, 3,523,932 blocks) reads 225.5 MB of values, 14.1
// MB of columns, 1 MB of row pointers, x and y once: 248.4 MB, 74 us at
// 3.35 TB/s; a view reads the 32-byte sectors of its rows (u rows: the
// whole block; the p row: half). x (3.9 MB) stays in the 50 MB L2: its
// gather costs load instructions and latency, not HBM bytes.
//
// Design:
// - A block row is one 16-byte chunk in float32 (two in float64), and a
//   node row's ~14.5 blocks are ~930 contiguous bytes. Four neighbouring
//   lanes take one block, lane r its row r, so a warp load is 512
//   contiguous bytes (whole blocks, evict-first); 2**lg lanes (16) take
//   a node row, the j-th group of four its blocks j, j + 4, ... . A view
//   of the p row alone gives each lane one block (8 lanes a node row):
//   a lane's rows are only those the view reads.
// - Bytes in flight: a lane issues the loads of kUnroll of its blocks
//   (values and columns) before it gathers their x and sums; the grid
//   is persistent, from the occupancy calculator times the SM count.
// - The four lanes of a block read the same x values (one broadcast
//   load each); x and the scale through the read-only cache.
// - Each lane's sum runs over its blocks in order; the lanes of one row
//   r meet in a fixed xor-shuffle tree and the lane of the block group
//   0 stores it: no atomics, two calls bitwise equal.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // blocks a lane loads before it sums

template <typename T>
struct Args {
  const T* vals;
  const int* rowptr;
  const int* cols;
  int n;  // node rows (and node columns)
  const T* x;
  T* out;
  int mode;
  const T* b;
  const T* sc;                // SCALE: x's twin
  const unsigned char* mask;  // one byte an output row, or null
  const T* mv;                // the masked rows' values, or null
  const T* cw;                // mode 3: the sweep's scale w
  const T* dprev;             // mode 3: the previous step's d, or null
  T* dout;                    // mode 3: this step's d, or null
  const T* add;               // mode 3: added to the output, or null
  T ca, cc;                   // mode 3: the step's coefficients
  int lg;                     // log2 of the lanes a node row
  int64_t n_lanes;            // n << lg
};

template <typename T>
struct Row4 {
  T v[4];
};

// row r of block k: 16 bytes in float32, 32 in float64; read once
template <typename T>
__device__ __forceinline__ Row4<T> load_row(const T* p) {
  Row4<T> a;
  if constexpr (sizeof(T) == 4) {
    const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
    a.v[0] = f.x;
    a.v[1] = f.y;
    a.v[2] = f.z;
    a.v[3] = f.w;
  } else {
    const double2 f0 = __ldcs(reinterpret_cast<const double2*>(p));
    const double2 f1 = __ldcs(reinterpret_cast<const double2*>(p) + 1);
    a.v[0] = f0.x;
    a.v[1] = f0.y;
    a.v[2] = f1.x;
    a.v[3] = f1.y;
  }
  return a;
}

// flat index of value j (0..3) of node c in a vector of view V
template <int V>
__device__ __forceinline__ int64_t pos_of(int64_t c, int j, int64_t n) {
  if constexpr (V == 0) return j < 3 ? 3 * c + j : 3 * n + c;
  if constexpr (V == 1) return 3 * c + j;
  return c;  // V == 2: j == 3
}

// the epilogue of row j (a block row, 0..3) of node i
template <typename T, int RS, int CS, bool SCALE>
__device__ __forceinline__ void store_row(const Args<T>& p, int64_t i,
                                          int j, T acc) {
  const int64_t pos = pos_of<RS>(i, j, p.n);
  T y = acc;
  if (p.mode == 1) {
    y = p.b[pos] - acc;
  } else if (p.mode == 3) {  // a square view: x has out's layout
    const T xv = SCALE ? p.sc[pos] * p.x[pos] : p.x[pos];
    T yp = acc;
    if (p.mask != nullptr && p.mask[pos]) yp = xv;  // identity rows
    const T dp = p.dprev != nullptr ? p.dprev[pos] : xv;
    const T dn = p.ca * dp + p.cc * (p.cw[pos] * (p.b[pos] - yp));
    if (p.dout != nullptr) p.dout[pos] = dn;
    y = xv + dn;
  }
  if (p.add != nullptr) y = y + p.add[pos];
  if (p.mode != 3 && p.mask != nullptr && p.mask[pos]) {
    y = p.mv != nullptr ? p.mv[pos] : T(0);
  }
  p.out[pos] = y;
}

template <typename T, int RS, int CS, bool SCALE>
__global__ void __launch_bounds__(kThreads) bsr_spmv_kernel(const Args<T> p) {
  // lanes a block: one a row it reads (the u rows take four lanes, the
  // fourth idle, so a group's lanes stay on a 16-byte grid)
  constexpr int LPB = RS == 2 ? 1 : 4;
  constexpr int R_LO = RS == 2 ? 3 : 0;
  constexpr int R_HI = RS == 1 ? 3 : 4;
  constexpr int C_LO = CS == 2 ? 3 : 0;
  constexpr int C_HI = CS == 1 ? 3 : 4;
  const int G = 1 << p.lg;
  const int BPP = G / LPB;  // blocks a pass of the group
  for (int64_t t0 = (int64_t)blockIdx.x * kThreads; t0 < p.n_lanes;
       t0 += (int64_t)gridDim.x * kThreads) {
    const int64_t t = t0 + threadIdx.x;  // the whole block takes each step
    const int64_t i = t >> p.lg;
    const int g = (int)(t & (G - 1));
    const int r = LPB == 1 ? R_LO : (g & 3);
    const int m = g / LPB;
    T acc = T(0);
    if (t < p.n_lanes && r < R_HI) {
      const int kb = __ldg(p.rowptr + i), ke = __ldg(p.rowptr + i + 1);
      const T* a = p.vals + 4 * r;
      for (int k = kb + m; k < ke; k += kUnroll * BPP) {
        Row4<T> av[kUnroll];
        int cv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int kk = k + u * BPP;
          if (kk < ke) {
            cv[u] = __ldg(p.cols + kk);
            av[u] = load_row<T>(a + (int64_t)kk * 16);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k + u * BPP < ke) {
            const int64_t c = cv[u];
#pragma unroll
            for (int j = C_LO; j < C_HI; ++j) {
              const int64_t q = pos_of<CS>(c, j, p.n);
              const T xv = SCALE ? __ldg(p.sc + q) * __ldg(p.x + q)
                                 : __ldg(p.x + q);
              acc = fma(av[u].v[j], xv, acc);
            }
          }
        }
      }
    }
    for (int off = G >> 1; off >= LPB; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (t < p.n_lanes && m == 0 && r < R_HI) {
      store_row<T, RS, CS, SCALE>(p, i, r, acc);
    }
  }
}

template <typename T, int RS, int CS, bool SCALE>
int launch(const Args<T>& a, cudaStream_t st) {
  const auto fn = bsr_spmv_kernel<T, RS, CS, SCALE>;
  // resident blocks on the card, per instantiation (one card per process)
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
  }
  const int grid = (int)std::min<int64_t>(
      (a.n_lanes + kThreads - 1) / kThreads, resident);
  fn<<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// the views NodeBSR applies: (all, all) the operator, (u, u), (u, p),
// (p, u), (p, p) its blocks, (all, p) the p column
template <typename T, bool SCALE>
int views(const Args<T>& a, int rs, int cs, cudaStream_t st) {
  if (rs == 0 && cs == 0) return launch<T, 0, 0, SCALE>(a, st);
  if (rs == 1 && cs == 1) return launch<T, 1, 1, SCALE>(a, st);
  if (rs == 1 && cs == 2) return launch<T, 1, 2, SCALE>(a, st);
  if (rs == 2 && cs == 1) return launch<T, 2, 1, SCALE>(a, st);
  if (rs == 2 && cs == 2) return launch<T, 2, 2, SCALE>(a, st);
  if (rs == 0 && cs == 2) return launch<T, 0, 2, SCALE>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(const void* vals, const void* rowptr, const void* cols, int n,
        const void* x, int rs, int cs, void* out, int mode, const void* b,
        const void* sc, const void* mask, const void* mv, const void* cw,
        const void* dprev, void* dout, const void* add, double ca, double cc,
        int lg, void* stream) {
  Args<T> a;
  a.vals = static_cast<const T*>(vals);
  a.rowptr = static_cast<const int*>(rowptr);
  a.cols = static_cast<const int*>(cols);
  a.n = n;
  a.x = static_cast<const T*>(x);
  a.out = static_cast<T*>(out);
  a.mode = mode;
  a.b = static_cast<const T*>(b);
  a.sc = static_cast<const T*>(sc);
  a.mask = static_cast<const unsigned char*>(mask);
  a.mv = static_cast<const T*>(mv);
  a.cw = static_cast<const T*>(cw);
  a.dprev = static_cast<const T*>(dprev);
  a.dout = static_cast<T*>(dout);
  a.add = static_cast<const T*>(add);
  a.ca = static_cast<T>(ca);
  a.cc = static_cast<T>(cc);
  a.lg = lg;
  a.n_lanes = (int64_t)n << lg;
  const auto st = static_cast<cudaStream_t>(stream);
  return sc != nullptr ? views<T, true>(a, rs, cs, st)
                       : views<T, false>(a, rs, cs, st);
}

}  // namespace

extern "C" int cfd_bsr_spmv(const void* vals, const void* rowptr,
                            const void* cols, int n, const void* x, int rs,
                            int cs, void* out, int mode, const void* b,
                            const void* sc, const void* mask, const void* mv,
                            const void* cw, const void* dprev, void* dout,
                            const void* add, double ca, double cc, int lg,
                            int is_f64, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  // lanes a node row: a power of 2 of whole block groups, within a warp
  if (lg < (rs == 2 ? 0 : 2) || lg > 5 || ((int64_t)n << lg) >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(vals) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  if ((mode != 0 && mode != 1 && mode != 3) || (mode != 0 && b == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // mode 3: a square view and w; its mask takes no values. add: mode 3,
  // no mask
  if (mode == 3 && (rs != cs || cw == nullptr || mv != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((mode != 3 && (cw != nullptr || dprev != nullptr || dout != nullptr ||
                     add != nullptr)) ||
      (add != nullptr && mask != nullptr) ||
      (mv != nullptr && mask == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return is_f64 ? run<double>(vals, rowptr, cols, n, x, rs, cs, out, mode, b,
                              sc, mask, mv, cw, dprev, dout, add, ca, cc, lg,
                              stream)
                : run<float>(vals, rowptr, cols, n, x, rs, cs, out, mode, b,
                             sc, mask, mv, cw, dprev, dout, add, ca, cc, lg,
                             stream);
}
