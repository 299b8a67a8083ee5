// K9 krylov: the Gram-Schmidt step of GMRES's Arnoldi process, with
// FGMRES's Givens update as an optional tail, and the small solves that
// end a fixed sweep or a restart cycle.
//
// Replaces the jnp products, norms and solves of cfdtpu/la/gmres.py:
//   gmres_fixed (:28-82): V[0] = b / max(||b||, tiny); each sweep's
//     classical Gram-Schmidt over the active rows (once, or twice with
//     reorth); the normal equations (H^T H + reg I) y = H^T beta e1,
//     reg = max(trace / m, tiny) * 1e-12, and Z^T y;
//   fgmres (:179-239): the CGS2 step of every inner iteration, the
//     Givens rotations of the new Hessenberg column (:201-219), and the
//     cycle's back-substitution and x + Z^T y (:226-239).
//
// cfd_krylov_cgs, for the active rows V[0..j] (none at j = -1):
//   h1 = V w; u = w - V^T h1; [h2 = V u; u = u - V^T h2]   (reorth)
//   V[j+1] = u / max(||u||, tiny); hcol[k] = h1[k] (+ h2[k]), k <= j;
//   hcol[j+1] = ||u||
// in one launch of persistent blocks, one a multiprocessor at most, each
// owning a contiguous slice of the n columns. Each of the reductions
// (V w, V u, ||u||^2) is the block's sums, published to an exchange in
// device memory, and every block gathering all blocks' sums and adding
// them in one fixed order, so that each holds the same h. No atomics
// touch a value: two calls are bitwise equal, and so are a CUDA graph's
// replays. The exchange is the grid's barrier: each 64-bit word carries
// a sum (a float, or half a double) beside the launch's tag (from a
// launch counter kept with it), so a reader polls the words themselves
// until all carry the tag, with no fence, atomic or flag. The launch is
// cooperative (cudaLaunchKernelEx with cudaLaunchAttributeCooperative,
// capturable into a graph), so the runtime refuses a grid whose blocks
// could not all be resident at once: no block polls for one that never
// runs.
//
// Resident path: each block copies its slice of V[0..j] and of w into
// shared memory once (cp.async), and both passes, the norm and the scaled
// store of V[j+1] read it there, so device memory sees each input once,
// as the bound counts. Streamed path, where the slices do not fit
// (kSmemCgs; the wrapper chooses from the shapes): the same code reads
// the rows from L2 or device memory and keeps u in V[j+1]. The two
// paths do the same operations in the same order: bitwise equal results.
// A pass keeps eight rows' sums a thread in registers, its loads free of
// branches, and reduces them across the warp by transposition (nine
// shuffles for eight rows, not forty): a per-row chain of shuffles and
// loads behind a branch made each pass a latency chain.
//
// At j = -1 an elementwise scale sc may come with w: the step normalises
// u = sc * w (each value rounded once, then squared and summed in the
// same order), so that after y = A v (K1) it is one power-iteration
// step of sc * A, with ||sc * y|| left in hcol[0]: lambda_max of the
// Chebyshev smoothers (la/chebyshev.py, cfdtpu/la/chebyshev.py:33-51)
// without a read on the host.
//
// Bound: the active rows, w and V[j+1] once: at the FGMRES site of the
// DFG 2D-1 slice (n = 106,275, j = 19, CGS2, float32) 9.35 MB, 2.79 us
// at 3.35 TB/s. What holds it is latency, not bytes: the slices' load
// (a copy a value), three exchanges of a round trip or two to L2 on
// lines every block reads, and the launch; at the S stage's sweeps
// (n = 35,425, j <= 4) the exchanges are all.
//
// Givens tail (FGMRES): after the norm, block 0 takes the new column to
// float64, applies the previous rotations, forms the new one, updates g,
// writes the rotated column into R and (|g[j+1]|, the continue flag
// |g[j+1]| > tol and j + 1 < m) into stat: the host's float64 arithmetic
// operation by operation, with no fused multiply-add. At j = -1 it
// starts the cycle: g = ||w|| e1 and stat = (||w||, ||w|| > tol).
//
// cfd_krylov_lsq and cfd_krylov_tri, one kernel in two modes: every
// block solves the same small system in shared memory, in float64
// whatever the vectors' type, then writes its share of out = [x +] Z^T y:
// one launch, no cuSOLVER call, so nothing in a captured CUDA graph
// synchronises. Normal mode (gmres_fixed): the m x m normal equations of
// H by Gauss elimination with partial pivoting (the first largest pivot,
// as LAPACK's getrf), y masked by beta > tiny. Triangular mode (fgmres):
// R[:j,:j] y = g[:j] by column-oriented back substitution (BLAS trsv's
// order), one warp on the triangle held in shared memory. Bound: the
// launch and the solve's dependent steps; Z is j*n values.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 128;  // restart + 1 at most
constexpr int kMaxM = 64;      // the normal equations' m at most
constexpr int kMaxBlocks = 160;  // blocks of a Gram-Schmidt step at most
constexpr int kSlots = (kMaxBlocks + 31) / 32;  // blocks a lane gathers
constexpr int kCols = 4;     // columns a thread takes a group
constexpr int kDotRows = 8;  // rows whose sums a thread keeps at once
constexpr long long kSpinLimit = 1ll << 24;  // polls before a trap
// dynamic shared memory of the Gram-Schmidt step's resident path
// (SMEM_RESIDENT in kernels/krylov.py), and of the triangle
constexpr int kSmemCgs = 200 * 1024;
constexpr int kSmemTri = (kMaxRows - 1) * (kMaxRows - 1) * 8;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// The warp's sums of R values a lane (R a power of two, at most 32) in
// R - 1 + log2(32 / R) shuffles, each level's shuffles independent:
// recursive halving (a lane keeps the half its bit of the offset names
// and adds its partner's copy of it), then a butterfly over the lanes
// that hold the same row. Lane L returns the sum of v[L % R]; a fixed
// order, the same in every call.
template <typename T, int R>
__device__ __forceinline__ T warp_sums(T (&v)[R]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int o = R / 2; o >= 1; o /= 2) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const T send = up ? v[i] : v[i + o];
      const T keep = up ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  T s = v[0];
#pragma unroll
  for (int o = R; o < 32; o *= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// A word of the partials' exchange: a 32-bit payload and the launch's tag
// in the upper half. Each word is written and read whole (aligned 64-bit
// accesses are single-copy atomic), so a reader that finds the tag holds
// the payload written with it: no fence, counter or flag is needed.
__device__ __forceinline__ void xch_put(unsigned long long* p,
                                        unsigned payload, unsigned tag) {
  const unsigned long long w =
      (unsigned long long)payload | ((unsigned long long)tag << 32);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long xch_get(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}

// a value as n payloads (a float one, a double its high and low halves),
// and back
template <typename T>
struct Words;
template <>
struct Words<float> {
  static constexpr int n = 1;
  __device__ static unsigned get(float v, int) { return __float_as_uint(v); }
  __device__ static float make(const unsigned long long* w) {
    return __uint_as_float((unsigned)w[0]);
  }
};
template <>
struct Words<double> {
  static constexpr int n = 2;
  __device__ static unsigned get(double v, int i) {
    return (unsigned)(i == 0 ? __double2hiint(v) : __double2loint(v));
  }
  __device__ static double make(const unsigned long long* w) {
    return __hiloint2double((int)(unsigned)w[0], (int)(unsigned)w[1]);
  }
};

// this block's sums sum[k], k < rows, into its slots of an exchange
// region (row k, block b at words (k * blocks + b) * W)
template <typename T>
__device__ void publish(unsigned long long* region, const T* sum, int rows,
                        unsigned tag) {
  constexpr int W = Words<T>::n;
  for (int k = threadIdx.x; k < rows; k += kThreads) {
    unsigned long long* p =
        region + ((int64_t)k * gridDim.x + blockIdx.x) * W;
#pragma unroll
    for (int i = 0; i < W; ++i) xch_put(p + i, Words<T>::get(sum[k], i), tag);
  }
}

// h[k], k < rows: the sum of every block's sum of row k. A warp takes
// kPoll rows at a time, each lane the blocks lane, lane + 32, ...: every
// word is loaded at once, and loaded again until all carry the tag (the
// launch is cooperative: every writer is resident); then each lane's sum
// over its blocks in order and the warp's transposed sums, the same in
// every block.
// A wait past kSpinLimit polls traps rather than hangs.
template <typename T>
__device__ void gather(const unsigned long long* region, int rows,
                       unsigned tag, T* h) {
  constexpr int W = Words<T>::n;
  constexpr int kPoll = 4 / W;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nb = gridDim.x;
  for (int k0 = warp * kPoll; k0 < rows; k0 += kWarps * kPoll) {
    unsigned long long v[kPoll][kSlots][W];
    long long spins = 0;
    bool ready;
    do {
      ready = true;
#pragma unroll
      for (int r = 0; r < kPoll; ++r) {
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          const int b = lane + 32 * q;
          const bool live = k0 + r < rows && b < nb;
#pragma unroll
          for (int i = 0; i < W; ++i) {
            v[r][q][i] = live ? xch_get(region + ((int64_t)(k0 + r) * nb + b)
                                                     * W + i)
                              : (unsigned long long)tag << 32;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kPoll; ++r) {
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
#pragma unroll
          for (int i = 0; i < W; ++i) {
            ready = ready && (unsigned)(v[r][q][i] >> 32) == tag;
          }
        }
      }
      if (++spins > kSpinLimit) __trap();
    } while (!ready);
    T acc[kPoll];
#pragma unroll
    for (int r = 0; r < kPoll; ++r) {
      acc[r] = T(0);
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        if (lane + 32 * q < nb) acc[r] += Words<T>::make(v[r][q]);
      }
    }
    const T tot = warp_sums(acc);
    if (lane < kPoll && k0 + lane < rows) h[k0 + lane] = tot;
  }
  __syncthreads();
}

template <int B>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(B)
               : "memory");
}

// the block's rows of V, row k at base + k * ld: its slices in shared
// memory (resident) or V itself (streamed)
template <typename T>
struct Rows {
  const T* base;
  int64_t ld;
  __device__ const T* operator()(int k) const { return base + k * ld; }
};

// sum[k], k < rows: the block's sums over its cnt columns of row k of Vr
// times x, kDotRows rows at a time. A thread keeps those
// rows' sums in registers over its kCols columns of a group: the loads of
// all of them are independent and unguarded (a row past the last reads
// the last again, its sum unused), the chains independent; then the
// warp's transposed sums, and after all rows the warps in order: one
// fixed order.
template <typename T>
__device__ void block_dots(const Rows<T>& Vr, int rows, int cnt,
                           const T* x, T* sum) {
  __shared__ T red[kWarps][kMaxRows];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int k0 = 0; k0 < rows; k0 += kDotRows) {
    T acc[kDotRows];
#pragma unroll
    for (int kk = 0; kk < kDotRows; ++kk) acc[kk] = T(0);
    for (int c0 = threadIdx.x; c0 < cnt; c0 += kCols * kThreads) {
      T xv[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        xv[i] = c0 + i * kThreads < cnt ? x[c0 + i * kThreads] : T(0);
      }
#pragma unroll
      for (int kk = 0; kk < kDotRows; ++kk) {
        const T* vr = Vr(min(k0 + kk, rows - 1)) + c0;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const T vv = c0 + i * kThreads < cnt ? vr[i * kThreads] : T(0);
          acc[kk] = fma(vv, xv[i], acc[kk]);
        }
      }
    }
    const T tot = warp_sums(acc);
    if (lane < kDotRows && k0 + lane < rows) red[warp][k0 + lane] = tot;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < rows; k += kThreads) {
    T s = T(0);
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][k];
    sum[k] = s;
  }
  __syncthreads();
}

// dst = src - Vr^T h over the block's columns, each in the order
// k = 0, 1, ... (kCols independent chains a thread); src may be dst
template <typename T>
__device__ void block_update(const Rows<T>& Vr, int rows, int cnt,
                             const T* src, T* dst, const T* h) {
  for (int c0 = threadIdx.x; c0 < cnt; c0 += kCols * kThreads) {
    T t[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) t[i] = T(0);
#pragma unroll 4
    for (int k = 0; k < rows; ++k) {
      const T hk = h[k];
      const T* vr = Vr(k) + c0;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        if (c0 + i * kThreads < cnt) t[i] = fma(vr[i * kThreads], hk, t[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = c0 + i * kThreads;
      if (c < cnt) dst[c] = src[c] - t[i];
    }
  }
  __syncthreads();
}

template <typename T>
struct CgsArgs {
  T* V;
  const T* w;
  const T* sc;  // j = -1 only: u = sc * w (a power-iteration step), or null
  T* h;
  unsigned* epoch;          // launches so far (the exchange's tag)
  unsigned long long* xch;  // the exchange: 2 (j + 1) + 1 rows of slots
  int64_t n, hstride;
  int j, reorth, cols;
  T tiny;
  // Givens tail (R null: none)
  double *R, *cs, *sn, *g, *stat;
  const double* tol;
  int m;
  double gtiny;
};

// FGMRES's update of its rotated Hessenberg state by the new column
// (h[0..j] the summed projections, wn = ||u||), one thread; cs, sn, g[j]
// and tol were read at the kernel's start (pre)
template <typename T>
__device__ void givens_tail(const CgsArgs<T>& a, const T* h, T wn,
                            double* hd, const double* pcs,
                            const double* psn, const double* pre) {
  const int j = a.j;
  double* st = a.stat + 2 * (j + 1);
  const double tol = pre[1];
  if (j < 0) {  // the cycle's start: g = beta e1
    const double beta = static_cast<double>(wn);
    a.g[0] = beta;
    for (int k = 1; k <= a.m; ++k) a.g[k] = 0.0;
    st[0] = beta;
    st[1] = (beta > tol && a.m > 0) ? 1.0 : 0.0;
    return;
  }
  // rotation i mixes the carried hd[i] with the column's own h[i+1]
  double carry = static_cast<double>(h[0]);
  for (int i = 0; i < j; ++i) {
    const double c = pcs[i], s = psn[i], h1 = static_cast<double>(h[i + 1]);
    hd[i] = __dadd_rn(__dmul_rn(c, carry), __dmul_rn(s, h1));
    carry = __dadd_rn(__dmul_rn(-s, carry), __dmul_rn(c, h1));
  }
  const double h0 = carry, h1 = static_cast<double>(wn);
  const double denom = sqrt(__dadd_rn(__dmul_rn(h0, h0), __dmul_rn(h1, h1)));
  const double den = a.gtiny > denom ? a.gtiny : denom;
  const double c = h0 / den, s = h1 / den;
  a.cs[j] = c;
  a.sn[j] = s;
  const double gj = pre[0];
  const double g1 = __dmul_rn(-s, gj);
  a.g[j] = __dmul_rn(c, gj);
  a.g[j + 1] = g1;
  hd[j] = denom;
  hd[j + 1] = 0.0;
  const double res = fabs(g1);
  st[0] = res;
  st[1] = (res > tol && j + 1 < a.m) ? 1.0 : 0.0;
}

template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(kThreads)
    krylov_cgs_step(CgsArgs<T> a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ T h[kMaxRows + 1];
  __shared__ T h2[kMaxRows];
  __shared__ T sum[kMaxRows];
  __shared__ T red[kWarps];
  __shared__ double hd[kMaxRows + 1];
  __shared__ double pcs[kMaxRows], psn[kMaxRows], pre[2];
  __shared__ unsigned ep;
  constexpr int W = Words<T>::n;
  const int rows = a.j + 1, nb = gridDim.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t c0 = (int64_t)blockIdx.x * a.cols;
  const int64_t rem = a.n - c0;
  const int cnt = rem <= 0 ? 0 : (rem < a.cols ? (int)rem : a.cols);
  const bool tail = a.R != nullptr && blockIdx.x == 0;
  if (threadIdx.x == 0) ep = *static_cast<volatile unsigned*>(a.epoch);
  if (tail) {  // the Givens tail's inputs, ahead of need
    for (int i = threadIdx.x; i < a.j; i += kThreads) {
      pcs[i] = a.cs[i];
      psn[i] = a.sn[i];
    }
    if (threadIdx.x == 0) {
      pre[0] = a.j >= 0 ? a.g[a.j] : 0.0;
      pre[1] = *a.tol;
    }
  }
  T* dst = a.V + (int64_t)rows * a.n + c0;  // the block's share of V[j+1]
  // where the block reads its rows and keeps u: shared memory, or V and
  // w in place with u in V[j+1] (each pointer derived on one path only,
  // so that the resident path's reads compile to shared-memory loads)
  T* s = reinterpret_cast<T*>(dyn);
  const Rows<T> Vr = RESIDENT ? Rows<T>{s, a.cols} : Rows<T>{a.V + c0, a.n};
  const T* x = RESIDENT ? s + (int64_t)rows * a.cols : a.w + c0;
  T* u = RESIDENT ? s + (int64_t)rows * a.cols : dst;
  if (RESIDENT) {
    for (int k = 0; k < rows; ++k) {
      for (int c = threadIdx.x; c < cnt; c += kThreads) {
        cp_async<sizeof(T)>(s + k * a.cols + c, a.V + c0 + k * a.n + c);
      }
    }
    for (int c = threadIdx.x; c < cnt; c += kThreads) {
      cp_async<sizeof(T)>(u + c, a.w + c0 + c);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();
  // tags 1 .. 2^32 - 1: a zeroed slot never carries one
  const unsigned tag = ep % 0xffffffffu + 1u;
  unsigned long long* x1 = a.xch;
  unsigned long long* x2 = x1 + (int64_t)rows * nb * W;
  unsigned long long* x3 = x2 + (int64_t)rows * nb * W;
  const T* uc = x;  // the current u
  if (rows > 0) {
    block_dots(Vr, rows, cnt, x, sum);
    publish(x1, sum, rows, tag);
    gather(x1, rows, tag, h);
    block_update(Vr, rows, cnt, x, u, h);
    if (a.reorth) {
      block_dots(Vr, rows, cnt, u, sum);
      publish(x2, sum, rows, tag);
      gather(x2, rows, tag, h2);
      block_update(Vr, rows, cnt, u, u, h2);
      for (int k = threadIdx.x; k < rows; k += kThreads) h[k] += h2[k];
    }
    uc = u;
  }
  // the scaled normalisation (j = -1): u = sc * w, each value rounded
  // once before its square, as the plain version forms it
  const T* scb = a.sc != nullptr ? a.sc + c0 : nullptr;
  T acc = T(0);
  for (int c = threadIdx.x; c < cnt; c += kThreads) {
    const T v = scb != nullptr ? scb[c] * uc[c] : uc[c];
    acc = fma(v, v, acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T tot = T(0);
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) tot += red[wi];
    sum[0] = tot;
  }
  __syncthreads();
  publish(x3, sum, 1, tag);
  gather(x3, 1, tag, sum);
  const T wn = sqrt(sum[0]);
  const T den = wn > a.tiny ? wn : a.tiny;
  for (int c = threadIdx.x; c < cnt; c += kThreads) {
    dst[c] = (scb != nullptr ? scb[c] * uc[c] : uc[c]) / den;
  }
  if (blockIdx.x == 0) {
    // every block has read the epoch (each published the norm after it)
    if (threadIdx.x == 0) *a.epoch = ep + 1u;
    for (int k = threadIdx.x; k < rows; k += kThreads) {
      a.h[k * a.hstride] = h[k];
    }
    if (threadIdx.x == 0) {
      a.h[rows * a.hstride] = wn;
      if (tail) givens_tail(a, h, wn, hd, pcs, psn, pre);
    }
    if (tail && a.j >= 0) {  // the rotated column into R's row j
      __syncthreads();
      double* col = a.R + (int64_t)a.j * (a.m + 1);
      for (int i = threadIdx.x; i <= a.m; i += kThreads) {
        col[i] = i <= a.j ? hd[i] : 0.0;
      }
    }
  }
}

template <typename T, bool RESIDENT>
int launch_cgs(const CgsArgs<T>& a, int nb, int smem, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      krylov_cgs_step<T, RESIDENT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCgs);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, krylov_cgs_step<T, RESIDENT>, kThreads, smem);
  }
  if (rc != cudaSuccess) return (int)rc;
  if (nb > occ * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, krylov_cgs_step<T, RESIDENT>, a);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

template <typename T>
int cgs(void* V, int64_t n, int j, const void* w, const void* sc, void* h,
        int64_t hstride,
        int reorth, void* xch, int nb, int cols, int smem, double tiny,
        void* R, void* cs, void* sn, void* g, void* stat, const void* tol,
        int m, cudaStream_t st) {
  CgsArgs<T> a;
  a.V = static_cast<T*>(V);
  a.w = static_cast<const T*>(w);
  a.sc = static_cast<const T*>(sc);
  a.h = static_cast<T*>(h);
  a.epoch = static_cast<unsigned*>(xch);
  a.xch = static_cast<unsigned long long*>(xch) + 1;
  a.n = n;
  a.hstride = hstride;
  a.j = j;
  a.reorth = reorth;
  a.cols = cols;
  a.tiny = static_cast<T>(tiny);
  a.R = static_cast<double*>(R);
  a.cs = static_cast<double*>(cs);
  a.sn = static_cast<double*>(sn);
  a.g = static_cast<double*>(g);
  a.stat = static_cast<double*>(stat);
  a.tol = static_cast<const double*>(tol);
  a.m = m;
  a.gtiny = tiny;
  return smem > 0 ? launch_cgs<T, true>(a, nb, smem, st)
                  : launch_cgs<T, false>(a, nb, smem, st);
}

template <typename T>
struct LsqArgs {
  const T* H;        // normal mode: (m + 1, m) row-major
  const T* beta;
  const double* R;   // triangular mode: column k of the triangle at R + k*ldr
  int64_t ldr;
  const double* g;
  const T* x;
  const T* Z;        // (m, n) row-major
  T* out;
  int64_t n;
  int m;             // the system's size (the triangle's j)
  double tiny;
};

// the m x m normal equations of H in float64, Gauss elimination with
// partial pivoting; y masked by beta > tiny
template <typename T>
__device__ void normal_solve(const LsqArgs<T>& a, T* y) {
  __shared__ double A[kMaxM][kMaxM + 1];  // [H^T H + reg I | H^T beta e1]
  __shared__ double yd[kMaxM];
  __shared__ int piv;
  const int t = threadIdx.x, m = a.m;
  const double bt = (double)a.beta[0];
  for (int e = t; e < m * m; e += kThreads) {
    const int r = e / m, c = e - r * m;
    double s = 0.0;
    for (int k = 0; k <= m; ++k) {
      s = fma((double)a.H[k * m + r], (double)a.H[k * m + c], s);
    }
    A[r][c] = s;
  }
  for (int r = t; r < m; r += kThreads) A[r][m] = (double)a.H[r] * bt;
  __syncthreads();
  if (t == 0) {  // reg from the trace, in order
    double tr = 0.0;
    for (int r = 0; r < m; ++r) tr += A[r][r];
    const double reg = fmax(tr / m, a.tiny) * 1e-12;
    for (int r = 0; r < m; ++r) A[r][r] += reg;
  }
  __syncthreads();
  for (int col = 0; col < m; ++col) {
    if (t == 0) {  // the first largest |pivot|
      int p = col;
      double best = fabs(A[col][col]);
      for (int r = col + 1; r < m; ++r) {
        if (fabs(A[r][col]) > best) {
          best = fabs(A[r][col]);
          p = r;
        }
      }
      piv = p;
    }
    __syncthreads();
    const int p = piv;
    if (p != col) {
      for (int c = col + t; c <= m; c += kThreads) {
        const double v = A[col][c];
        A[col][c] = A[p][c];
        A[p][c] = v;
      }
    }
    __syncthreads();
    const int w = m - col;  // columns col+1 .. m (the rhs last)
    for (int e = t; e < (m - col - 1) * w; e += kThreads) {
      const int r = col + 1 + e / w, c = col + 1 + e % w;
      A[r][c] -= (A[r][col] / A[col][col]) * A[col][c];
    }
    __syncthreads();
  }
  if (t == 0) {
    for (int r = m - 1; r >= 0; --r) {
      double s = A[r][m];
      for (int c = r + 1; c < m; ++c) s -= A[r][c] * yd[c];
      yd[r] = s / A[r][r];
    }
    for (int r = 0; r < m; ++r) {
      y[r] = a.beta[0] > static_cast<T>(a.tiny) ? static_cast<T>(yd[r])
                                                 : T(0);
    }
  }
}

// R[:m,:m] y = g[:m], the triangle copied into shared memory, then one
// warp: for c = m-1 .. 0, y[c] = g'[c] / R[c][c] and g'[r] -= R[r][c] y[c]
// for r < c
template <typename T>
__device__ void tri_solve(const LsqArgs<T>& a, T* y) {
  extern __shared__ double Rs[];  // Rs[c * m + r] = R[r][c]
  __shared__ double yd[kMaxRows];
  const int t = threadIdx.x, m = a.m;
  for (int e = t; e < m * m; e += kThreads) {
    const int c = e / m, r = e - c * m;
    Rs[e] = a.R[c * a.ldr + r];
  }
  for (int r = t; r < m; r += kThreads) yd[r] = a.g[r];
  __syncthreads();
  if (t < 32) {
    for (int c = m - 1; c >= 0; --c) {
      const double yc = yd[c] / Rs[c * m + c];
      __syncwarp();
      for (int r = t; r < c; r += 32) yd[r] -= Rs[c * m + r] * yc;
      if (t == 0) yd[c] = yc;
      __syncwarp();
    }
    for (int r = t; r < m; r += 32) y[r] = static_cast<T>(yd[r]);
  }
}

template <typename T, bool TRI>
__global__ void __launch_bounds__(kThreads)
    krylov_lsq_kernel(LsqArgs<T> a) {
  __shared__ T y[kMaxRows];
  if constexpr (TRI) {
    tri_solve(a, y);
  } else {
    normal_solve(a, y);
  }
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * kThreads) {
    T s = T(0);
    for (int k = 0; k < a.m; ++k) s = fma(__ldg(a.Z + k * a.n + i), y[k], s);
    a.out[i] = TRI ? a.x[i] + s : s;
  }
}

template <typename T>
int launch_tri(const LsqArgs<T>& a, int nb, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      krylov_lsq_kernel<T, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemTri);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = (size_t)a.m * a.m * sizeof(double);
  krylov_lsq_kernel<T, true><<<nb, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cfd_krylov_cgs(void* V, int64_t n, int j, const void* w,
                              const void* sc, void* h, int64_t hstride,
                              int reorth,
                              void* xch, int nb, int cols, int smem,
                              double tiny, void* R, void* cs, void* sn,
                              void* g, void* stat, const void* tol, int m,
                              int is_f64, void* stream) {
  const int rows = j + 1;
  const int64_t need = (int64_t)(rows + 1) * cols * (is_f64 ? 8 : 4);
  if (n <= 0 || nb <= 0 || nb > kMaxBlocks || j < -1 || rows > kMaxRows
      || (int64_t)nb * cols < n || smem < 0 || smem > kSmemCgs
      || (smem > 0 && smem < need)
      || (R != nullptr && (m < rows || m > kMaxRows))
      || (sc != nullptr && j != -1)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return is_f64 ? cgs<double>(V, n, j, w, sc, h, hstride, reorth, xch, nb,
                              cols, smem, tiny, R, cs, sn, g, stat, tol, m,
                              st)
                : cgs<float>(V, n, j, w, sc, h, hstride, reorth, xch, nb,
                             cols, smem, tiny, R, cs, sn, g, stat, tol, m,
                             st);
}

extern "C" int cfd_krylov_lsq(const void* H, int m, const void* beta,
                              const void* Z, int64_t n, void* out, int nb,
                              double tiny, int is_f64, void* stream) {
  if (m < 1 || m > kMaxM || n <= 0 || nb <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    LsqArgs<double> a = {};
    a.H = static_cast<const double*>(H);
    a.beta = static_cast<const double*>(beta);
    a.Z = static_cast<const double*>(Z);
    a.out = static_cast<double*>(out);
    a.n = n;
    a.m = m;
    a.tiny = tiny;
    krylov_lsq_kernel<double, false><<<nb, kThreads, 0, st>>>(a);
  } else {
    LsqArgs<float> a = {};
    a.H = static_cast<const float*>(H);
    a.beta = static_cast<const float*>(beta);
    a.Z = static_cast<const float*>(Z);
    a.out = static_cast<float*>(out);
    a.n = n;
    a.m = m;
    a.tiny = tiny;
    krylov_lsq_kernel<float, false><<<nb, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" int cfd_krylov_tri(const void* R, int64_t ldr, const void* g,
                              const void* Z, int64_t n, const void* x, int j,
                              void* out, int nb, int is_f64, void* stream) {
  if (j < 1 || j > kMaxRows - 1 || ldr < j || n <= 0 || nb <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    LsqArgs<double> a = {};
    a.R = static_cast<const double*>(R);
    a.ldr = ldr;
    a.g = static_cast<const double*>(g);
    a.x = static_cast<const double*>(x);
    a.Z = static_cast<const double*>(Z);
    a.out = static_cast<double*>(out);
    a.n = n;
    a.m = j;
    return launch_tri(a, nb, st);
  }
  LsqArgs<float> a = {};
  a.R = static_cast<const double*>(R);
  a.ldr = ldr;
  a.g = static_cast<const double*>(g);
  a.x = static_cast<const float*>(x);
  a.Z = static_cast<const float*>(Z);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.m = j;
  return launch_tri(a, nb, st);
}
