// K6 ras_apply: the restricted additive Schwarz (RAS) apply.
//
// Replaces la/ras.py RASPrecond.apply of cfdtpu (gather of the node
// windows, batched einsum with the window inverses, slice of the owned
// centre rows). Window k covers the nodes [k*s - o, k*s + s + o) (m =
// (s + 2o) d values of the flat x, zero outside [0, n)) and owns its
// centre s nodes. The caller keeps only the owned rows of each inverse,
// inv (n_sub, s*d, m) contiguous, so row r of the flat (n_sub*s*d, m)
// array is output row r = k*s*d + a of window k = r / (s*d):
//
//   out[r] = sum_{b<m} inv[r, b] * x[k*s*d - o*d + b]   (mode 0)
//   out[r] = base[r] + the same sum                      (mode 1)
//   for r < n*d.
//
// Each output row has one owner (a group of four lanes) and a fixed
// order of summation, so two calls are bitwise equal. Mode 1 is the
// fine smoother's x + RAS(r) of BlockAMG.v_cycle.
//
// Bound: device memory. The owned inverse rows are read once per apply
// (at the bench settings 70,850 rows of 80 float32: 22.7 MB, ~6.8 us at
// 3.35 TB/s); x and out are 0.28 MB each. Design:
// - the n*d output rows are split into equal runs, one per block, with
//   as many blocks as the card has SMs (more only where a run would not
//   fit the shared memory): one wave, every SM the same bytes, whatever
//   the number of windows;
// - a block's run of rows is one contiguous range of inv. Warp 0 asks
//   for all of it at once, in chunks of eight rows, each a bulk copy
//   (cp.async.bulk, the Tensor Memory Accelerator) into shared memory
//   completing on its own mbarrier, so the card streams the whole array
//   from the first microsecond with no load held in a register;
// - x of the run's windows is one contiguous range at a computed address
//   (no index map), which the other warps load meanwhile, zero outside
//   [0, n*d);
// - warp w sums chunks w, w+32, ... as each lands: four lanes per row,
//   16-byte shared-memory reads (conflict-free), and a fixed two-step
//   xor-shuffle tree.
// Where a row is not a multiple of 16 bytes or the array not 16-byte
// aligned (bulk copies need both), the block copies its rows with its
// threads and sums them with scalar reads.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;  // rows per bulk copy: one warp's pass
constexpr int kLanes = 4;  // lanes per row

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_addr(bar))
      : "memory");
  return done != 0;
}

// one thread: announce `bytes` on `bar` and copy them global -> shared
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T, int V>
struct Vec;
template <typename T>
struct Vec<T, 1> {
  T v[1];
};
template <>
struct alignas(16) Vec<float, 4> {
  float v[4];
};
template <>
struct alignas(16) Vec<double, 2> {
  double v[2];
};

// V values per shared-memory read: 16 bytes where rows, windows and the
// array allow bulk copies (`bulk`), else 1 and the threads copy
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
    ras_apply_kernel(const T* __restrict__ inv, const T* __restrict__ x,
                     const T* __restrict__ base, T* __restrict__ out,
                     int64_t nd, int sd, int od, int m, int64_t per_block,
                     int n_chunks, int xs_len, int bulk) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);  // [n_chunks]
  const int bars_pad = (n_chunks * 8 + 127) / 128 * 128;
  T* xs = reinterpret_cast<T*>(smem_raw + bars_pad);  // [xs_len]
  const int xs_pad = (xs_len * (int)sizeof(T) + 127) / 128 * 128;
  T* rows = reinterpret_cast<T*>(smem_raw + bars_pad + xs_pad);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * per_block;
  const int nr = (int)(nd - r0 < per_block ? nd - r0 : per_block);
  if (nr <= 0) return;
  const int64_t k0 = r0 / sd;
  const int64_t xlo = k0 * sd - od;  // x index of xs[0]

  if (bulk) {
    for (int c = tid; c < n_chunks; c += kThreads) mbar_init(&bars[c]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    __syncthreads();
    if (warp == 0) {
      for (int c = lane; c * kChunk < nr; c += 32) {
        const int rc = min(kChunk, nr - c * kChunk);
        bulk_load(rows + (int64_t)c * kChunk * m,
                  inv + (r0 + (int64_t)c * kChunk) * m,
                  (unsigned)(rc * m * sizeof(T)), &bars[c]);
      }
    }
  } else {
    const T* src = inv + r0 * m;
    for (int64_t e = tid; e < (int64_t)nr * m; e += kThreads)
      rows[e] = __ldg(src + e);
  }
  // x of the run's windows, zero outside [0, nd), by the warps that do
  // not issue bulk copies
  const int x_len = (int)(((r0 + nr - 1) / sd - k0) * sd + m);
  const int t0 = bulk ? 32 : 0;
  if (tid >= t0) {
    for (int b = tid - t0; b < x_len; b += kThreads - t0) {
      const int64_t i = xlo + b;
      xs[b] = (i >= 0 && i < nd) ? __ldg(x + i) : T(0);
    }
  }
  __syncthreads();

  const int i = lane / kLanes, q = lane % kLanes;
  const int mv = m / V;
  for (int c = warp; c * kChunk < nr; c += kWarps) {
    if (bulk)
      while (!mbar_try_wait(&bars[c])) {
      }
    const int a = c * kChunk + i;  // row within the run
    T acc = T(0);
    if (a < nr) {
      const int64_t r = r0 + a;
      const Vec<T, V>* S =
          reinterpret_cast<const Vec<T, V>*>(rows + (int64_t)a * m);
      const Vec<T, V>* X =
          reinterpret_cast<const Vec<T, V>*>(xs + (r / sd - k0) * sd);
      for (int j = q; j < mv; j += kLanes) {
        const Vec<T, V> s = S[j], xv = X[j];
#pragma unroll
        for (int e = 0; e < V; ++e) acc += s.v[e] * xv.v[e];
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (a < nr && q == 0) {
      const int64_t r = r0 + a;
      out[r] = base != nullptr ? base[r] + acc : acc;
    }
  }
}

template <typename T, int V>
int launch(const void* inv, const void* x, const void* base, void* out,
           int64_t nd, int sd, int od, int m, int64_t per_block,
           int64_t blocks, int bulk, cudaStream_t st) {
  const int n_chunks = (int)((per_block + kChunk - 1) / kChunk);
  // the most x a run of per_block rows can span: its windows' ranges
  const int xs_len = (int)(((per_block - 1) / sd + 1) * sd + m);
  const size_t smem = (size_t)(n_chunks * 8 + 127) / 128 * 128 +
                      (size_t)(xs_len * sizeof(T) + 127) / 128 * 128 +
                      (size_t)per_block * m * sizeof(T);
  // the shared-memory opt-in, set once per size (the solver calls this
  // thousands of times a step)
  static size_t opted = 0;
  if (smem > opted) {
    cudaFuncSetAttribute(ras_apply_kernel<T, V>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    opted = smem;
  }
  ras_apply_kernel<T, V><<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const T*>(inv), static_cast<const T*>(x),
      static_cast<const T*>(base), static_cast<T*>(out), nd, sd, od, m,
      per_block, n_chunks, xs_len, bulk);
  return (int)cudaGetLastError();
}

}  // namespace

// inv (n_sub, s*d, m) owned rows, x and out (n*d,), base (n*d,) or null;
// `per_block` output rows per block over `blocks` blocks, and `bulk`
// (1: 16-byte rows by bulk copy and 16-byte reads; 0: copies and reads
// by the threads), all chosen by kernels/ras_apply.py ras_plan
extern "C" int cfd_ras_apply(const void* inv, const void* x,
                             const void* base, void* out, int64_t n,
                             int64_t d, int64_t s, int64_t o,
                             int64_t per_block, int64_t blocks, int bulk,
                             int is_f64, void* stream) {
  const int64_t nd = n * d;
  if (blocks <= 0 || nd <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sd = (int)(s * d), od = (int)(o * d), m = (int)((s + 2 * o) * d);
  if (is_f64)
    return bulk ? launch<double, 2>(inv, x, base, out, nd, sd, od, m,
                                    per_block, blocks, 1, st)
                : launch<double, 1>(inv, x, base, out, nd, sd, od, m,
                                    per_block, blocks, 0, st);
  return bulk ? launch<float, 4>(inv, x, base, out, nd, sd, od, m, per_block,
                                 blocks, 1, st)
              : launch<float, 1>(inv, x, base, out, nd, sd, od, m, per_block,
                                 blocks, 0, st);
}
