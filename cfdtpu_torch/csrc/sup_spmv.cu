// K1 sup_spmv: supernode-blocked ELL SpMV with fused epilogues, for Hopper.
//
// Replaces the jnp gather + batched einsum of cfdtpu's operator applies:
//   la/nodebsr.py:258  NodeBSR.apply_element_matrices (full operator)
//   la/nodebsr.py:277  NodeBSR.apply_sub_block (uu / up / pu / pp views)
//   la/nodebsr.py:586  NodeBSR.apply_p_coupled (the (g*bs, g) p column)
//   la/amg.py:447      AMG._matvec, and through the epilogues the
//                      l1-Jacobi update and residual of AMG.v_cycle
//   la/amg.py:629      BlockAMG's level matvec (width g*d)
//   la/superell.py:125 sup_matvec
// and, at width 1, the product of scripts/gather_micro.py.
//
//   y[s, r] = sum_{k<Kg} sum_{c<C} A[s, k, r, c] * X[cols[s, k], c]
//   out[pos(s, r)] = y                                 mode 0
//                  = b[pos] - y                        mode 1 (residual)
//                  = x[pos] + omega*(b[pos]-y)/d[pos]  mode 2 (l1-Jacobi)
//                  = x[pos] + dn[pos]                  mode 3 (Chebyshev)
//     dn = ca * (dprev or x)[pos] + cc * (w[pos] * (b[pos] - y)),
//     stored into dout where given: one step of la/chebyshev.py's sweep
//     (cfdtpu/la/chebyshev.py:72-77; ca, cc host numbers), the AMG
//     levels' smoothers (cfdtpu/la/amg.py:485-492, 596-611) and the
//     chebyshev inner method's Auu sweep (la/schur.py:254-260)
//
// Two options around the modes, each a template parameter, so the modes
// without them compile to the code they had before the options existed:
// - SCALE, an input scale: X is gathered as sc[i] * x[i] (one flat x
//   only), and mode 2's x[pos] is sc[pos] * x[pos] too. It carries
//   diag(Auu)^-1 into the SELFP Schur action's Apu, the 0/1 Dirichlet
//   mask into the near-true one's, and omega/d into the first l1-Jacobi
//   sweep of an AMG level from x0 = 0 (la/amg.py).
// - MASK, a row mask on the output: where mask[pos] is set, out[pos] is
//   mv[pos] (mv given) or 0, whatever the mode gave. It is the identity
//   Dirichlet rows of the outer operator and of Auu (mv = v), the zero
//   rows of Aup, and the pressure-Dirichlet rows of S (mv = v_p).
// - PROLONG, the coarse-grid correction of an aggregation V-cycle read
//   in place of K8's output (la/amg.py): X is gathered as
//     xhat[i] = base[i] + xc[agg[i / w] * w + i % w],
//     base = sc[i] * x[i] (SCALE) or x[i],
//   in the gather and in mode 2's own-row x alike, with K8's expression
//   (csrc/amg_prolong.cu), so the launch equals K8 then K1. With xhat
//   given, each output row's lane also stores xhat[pos] (BlockAMG's
//   finest level, where the RAS smoother adds to it). Instantiated with
//   SCALE or without, never with MASK, in 16-byte chunks only, at w = 1
//   (the SELFP AMG), 2 (BlockAMG in 2D) and 3 (BlockAMG in 3D), 8 nodes
//   a supernode: the cycles' levels; the host refuses the rest.
// - ADD (a runtime pointer, modes 2 and 3, no MASK): out += add[pos]
//   after the mode, one more rounding: the W-cycle's x1 + x2
//   (cfdtpu/la/amg.py:503-510, 675-690) in the epilogue of the second
//   visit's last launch, x2 + x1, which equals x1 + x2 bit for bit.
// In mode 3 a MASK makes its rows identity rows of the product (y = x
// there, Auu's where(mask, v, A v)) and mv is not read.
// The order of operations is fixed: the row sum y, then the mode (so the
// residual is b - y, rounded once), then the add, then the mask.
//
// X is never built. It is read from the solver's flat vector(s): one
// vector x0 of w0 = C values per supernode, or two (u at width w0 = g*d,
// p at width C - w0), and an index past a vector's length, or the
// padded slot cols == ns, reads zero. The output is one flat vector, or
// two regions of it split at row R0 of each supernode: rows r < R0 go to
// out[s*R0 + r] (< n0), rows r >= R0 to out[n0 + s*(R-R0) + r-R0] (< n1).
// So each apply is one launch into one torch.empty, with no padded
// supernode-row array, concatenation or slicing around it.
//
// Bound: device memory, at every site. Each matrix value is read once
// and used in one FMA: 0.5 flop per byte in float32, 0.25 in float64,
// hundreds of times below the H100's ridge, so tensor cores cannot help;
// the design is about bytes in flight, parallelism and launches.
//   full operator (8857, 15, 12, 12) f32: 76.5 MB of values (77.9 MB with
//     cols, x and y), 23 us at 3.35 TB/s; its strided views read only
//     their own rows (uu 34 MB);
//   BlockAMG L0 (4429, 13, 16, 16) 59 MB, SELFP AMG L0 (4429, 22, 8, 8)
//     24.9 MB: the same stream at widths 16 and 8;
//   BlockAMG L1/L2, SELFP L1 (0.6-6 MB): too few bytes to fill the card,
//     bound by latency: how many loads are in flight and how long each
//     row's dependent chain is;
//   with PROLONG, agg (4 bytes a node) and xc (1/7-1/9 of x) on top: a
//     lane loads its chunk's aggregate ids as one vector beside the x
//     chunk, then xc through the read-only cache (xc is L2-resident:
//     31 KB at BlockAMG L1), a node's two values in one load at w = 2;
//     the correction is formed at every gather of a value (~Kg*R/RPL
//     times a value, where K8 forms it once), so what it costs is
//     registers and load instructions, not bytes (kUnrollProlong);
//   width 1 (gather_micro, P*L rows, K = 8): values + cols + x + y.
//
// Design, against those two bounds (the launch plan is chosen on the
// host, kernels/sup_spmv.py launch_plan):
// - Coalesced 16-byte value stream. A lane reads 16-byte chunks of a row
//   (float4 in f32, double2 in f64) with evict-first loads; the CV lanes
//   of a row cover its C columns and the lanes of neighbouring rows are
//   neighbours, so each warp load is whole rows of a block tile,
//   neighbouring lanes on neighbouring addresses. A strided view (uu, up,
//   pu, pp, the p column) reads only its own rows.
// - Bytes in flight. A lane issues the loads of kUnroll blocks (values
//   and column indices, then the gathered x) before it sums any, and the
//   grid is persistent, sized from the occupancy calculator times the SM
//   count. Copying the values through a shared-memory ring (cp.async,
//   2-3 stages, a whole supernode slab per stage, then the rows summed
//   from shared memory) measured slower on the H100 at every large site
//   (full operator 51.6 us against 35 us here): the block barriers and
//   the serial x phase cost more than the ring saved.
// - The gather of x is what separates the stream from the 2.5 TB/s a
//   plain read of the same values reaches (full operator: 31 us without
//   the x loads, 39 us with one x load per value chunk). So a lane sums
//   RPL = 2 rows of one supernode (r0 and r0 + R/2) where the card keeps
//   enough lanes: each x chunk it gathers serves both rows.
// - Parallelism for the small levels: KS lanes split a row's Kg blocks
//   (the j-th takes k = j, j + KS, ...), raised on the host until the
//   card has enough lanes, so a lane's chain is 2-6 blocks instead of
//   the 176-192 products of one thread per row. The partial sums meet in
//   a fixed xor-shuffle tree: two calls are bitwise equal, with no
//   atomics (each row has one owner).
// - x and y in the solver's flat layouts (above), the residual and
//   l1-Jacobi epilogues, the input scale and the row mask, so an apply,
//   with the elementwise work around it in cfdtpu (la/schur.py:45-87,
//   287-300, 350-357, solvers/stabilized_schur.py:455-461, the first
//   pre-smooth of la/amg.py:520, 701), is one launch.
// A narrow row whose values are not 16-byte chunks (width 1) takes the
// same kernel with one value per lane (VEC = 1).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
// blocks whose loads a lane issues together: 4 in 16-byte chunks (times
// RPL rows), 8 at one value per lane
template <int VEC>
constexpr int kUnroll = VEC == 1 ? 8 : 4;
// With PROLONG, 2 blocks a round and at least 3 resident blocks a
// multiprocessor (85 registers a thread at most). The gather's extra
// values (ids, coarse values, scale) at 4 blocks a round took 96-116
// registers, 2 blocks of 256 threads a multiprocessor, and the large
// levels ran 1.3-1.6x slower than K8 and K1 apart; at 2 and 3 they run
// as fast or faster (device time alone on an H100 80GB HBM3 at 700 W:
// SELFP L0 13.1-13.4 us against 13.2-13.7 for the pair, BlockAMG L0
// 24.2-25.5 against 25.2-26.0, the small levels ~1 us under the pair).
constexpr int kUnrollProlong = 2;
constexpr int kBlocksProlong = 3;

template <typename T>
struct Args {
  const T* A;
  int64_t sA0, sA1, sA2;  // the last stride is 1
  const int* cols;
  int ns, Kg, R, C;
  const T* x0;
  int64_t m0;
  int w0, xa0;  // xa: the segment's alignment in bytes (16, 8 or 0)
  const T* x1;
  int64_t m1;
  int xa1;
  T* out;
  int64_t n0;
  int R0;
  int64_t n1;
  int mode;
  const T* b;
  const T* d;
  T omega;
  const T* sc;                // SCALE: the input scale, x's length
  const unsigned char* mask;  // MASK: one byte per output row
  const T* mv;                // MASK: the masked rows' values, or null
  const T* pxc;               // PROLONG: the coarse vector xc
  const int* pagg;            // PROLONG: each fine node's aggregate
  T* xhat;                    // PROLONG: xhat's output rows, or null
  const T* cw;                // mode 3: the sweep's scale w
  const T* dprev;             // mode 3: the previous step's d, or null
  T* dout;                    // mode 3: this step's d, or null
  const T* add;               // modes 2, 3: added to the output, or null
  T ca, cc;                   // mode 3: the step's coefficients
  int CV, KS, lg;  // chunks per row, k splits, log2 of lanes per row set
  int n_lanes;     // (ns * R / RPL) << lg
};

template <typename T, int VEC>
struct Chunk {
  T v[VEC];
};

// VEC contiguous values, 16-byte aligned when VEC > 1; STREAM: read once
// (evict-first), else through the read-only cache
template <typename T, int VEC, bool STREAM>
__device__ __forceinline__ Chunk<T, VEC> load_chunk(const T* p) {
  Chunk<T, VEC> c;
  if constexpr (VEC == 1) {
    c.v[0] = STREAM ? __ldcs(p) : __ldg(p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 f = STREAM ? __ldcs(reinterpret_cast<const float4*>(p))
                            : __ldg(reinterpret_cast<const float4*>(p));
    c.v[0] = f.x;
    c.v[1] = f.y;
    c.v[2] = f.z;
    c.v[3] = f.w;
  } else {
    const double2 f = STREAM ? __ldcs(reinterpret_cast<const double2*>(p))
                             : __ldg(reinterpret_cast<const double2*>(p));
    c.v[0] = f.x;
    c.v[1] = f.y;
  }
  return c;
}

// PROLONG (PW = w, the values a node): where value c0 + e of a
// supernode's column block lies: node col*g + nd[e] of the fine level,
// component cp[e] (fixed per lane)
template <int VEC>
struct NodeOf {
  int nd[VEC], cp[VEC];
};

template <int VEC, int PW>
__device__ __forceinline__ NodeOf<VEC> node_of(int c0) {
  NodeOf<VEC> q;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    q.nd[e] = (c0 + e) / PW;
    q.cp[e] = (c0 + e) % PW;
  }
  return q;
}

// xhat at the chunk of flat index i (column block col) of the one flat
// x, zero past its end: the base chunk (sc * x or x) and xc[agg[node] *
// w + component]. A whole chunk (the common case) takes vector loads
// and no guards: its aggregate ids are contiguous (one vector load
// beside the x chunk; agg 16-byte aligned, g a multiple of VEC: the
// host checks), and at w = 2 each node's two coarse values are one 8- or
// 16-byte load (xc aligned to a node: the host checks). At w = 3 a
// chunk's values straddle nodes, and each takes its own aggregate id
// and coarse value, as the guarded path does. The sum is K8's
// expression, base + xc[...], in one statement, so the compiler forms it
// as it does in K8 (sc*x + xc contracts to one fma).
template <typename T, int VEC, bool SCALE, int PW>
__device__ __forceinline__ Chunk<T, VEC> load_xhat(const Args<T>& p,
                                                   int col, int64_t i,
                                                   const NodeOf<VEC>& q) {
  using V2 = typename std::conditional<sizeof(T) == 4, float2,
                                       double2>::type;
  static_assert(VEC > 1 && (PW == 3 || VEC % PW == 0),
                "whole nodes a chunk at w 1 and 2");
  constexpr int G = 8;  // nodes a supernode column block (the host checks)
  const int64_t m = p.m0;
  const int* ag = p.pagg + (int64_t)col * G;
  Chunk<T, VEC> xv, sv, cv;
  if (p.xa0 >= 16 && i + VEC <= m) {
    xv = load_chunk<T, VEC, false>(p.x0 + i);
    if constexpr (SCALE) sv = load_chunk<T, VEC, false>(p.sc + i);
    const int* src = ag + q.nd[0];
    if constexpr (PW == 3) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        cv.v[e] = __ldg(p.pxc + __ldg(ag + q.nd[e]) * PW + q.cp[e]);
    } else if constexpr (PW == 1) {
      int a[VEC];
      if constexpr (VEC == 4) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(src));
        a[0] = v.x;
        a[1] = v.y;
        a[2] = v.z;
        a[3] = v.w;
      } else {
        const int2 v = __ldg(reinterpret_cast<const int2*>(src));
        a[0] = v.x;
        a[1] = v.y;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) cv.v[e] = __ldg(p.pxc + a[e]);
    } else {  // w = 2: VEC / 2 nodes, two coarse values each
      const V2* xc2 = reinterpret_cast<const V2*>(p.pxc);
      if constexpr (VEC == 4) {
        const int2 v = __ldg(reinterpret_cast<const int2*>(src));
        const V2 c0 = __ldg(xc2 + v.x), c1 = __ldg(xc2 + v.y);
        cv.v[0] = c0.x;
        cv.v[1] = c0.y;
        cv.v[2] = c1.x;
        cv.v[3] = c1.y;
      } else {
        const V2 c0 = __ldg(xc2 + __ldg(src));
        cv.v[0] = c0.x;
        cv.v[1] = c0.y;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const bool in = i + e < m;
      xv.v[e] = in ? __ldg(p.x0 + i + e) : T(0);
      if constexpr (SCALE) sv.v[e] = in ? __ldg(p.sc + i + e) : T(0);
      cv.v[e] = in ? __ldg(p.pxc + __ldg(ag + q.nd[e]) * PW + q.cp[e])
                   : T(0);
    }
  }
  Chunk<T, VEC> c;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if constexpr (SCALE) {
      c.v[e] = sv.v[e] * xv.v[e] + cv.v[e];
    } else {
      c.v[e] = xv.v[e] + cv.v[e];
    }
  }
  return c;
}

// X[col, c0 : c0 + VEC] from the flat segment(s); zero past an end and
// for the padded slot. For VEC > 1 the host guarantees w0 % VEC == 0, so
// a chunk never straddles the two segments.
template <typename T, int VEC, bool SCALE, int PW>
__device__ __forceinline__ Chunk<T, VEC> load_x(const Args<T>& p, int col,
                                                int c0,
                                                const NodeOf<VEC>& q) {
  Chunk<T, VEC> c;
  if (col < 0 || col >= p.ns) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) c.v[e] = T(0);
    return c;
  }
  if constexpr (PW > 0) {  // one segment (the host checks)
    return load_xhat<T, VEC, SCALE, PW>(p, col, (int64_t)col * p.w0 + c0,
                                        q);
  }
  const T* base = p.x0;
  int64_t i = (int64_t)col * p.w0 + c0, m = p.m0;
  int al = p.xa0;
  if (c0 >= p.w0) {
    base = p.x1;
    i = (int64_t)col * (p.C - p.w0) + (c0 - p.w0);
    m = p.m1;
    al = p.xa1;
  }
  if constexpr (SCALE) {  // one segment (the host checks): sc is x's twin
    Chunk<T, VEC> xv, sv;
    if (VEC > 1 && al >= 16 && i + VEC <= m) {  // al: both vectors' class
      xv = load_chunk<T, VEC, false>(base + i);
      sv = load_chunk<T, VEC, false>(p.sc + i);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        xv.v[e] = i + e < m ? __ldg(base + i + e) : T(0);
        sv.v[e] = i + e < m ? __ldg(p.sc + i + e) : T(0);
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) c.v[e] = sv.v[e] * xv.v[e];
    return c;
  }
  if (VEC > 1 && al >= 16 && i + VEC <= m) {
    return load_chunk<T, VEC, false>(base + i);
  }
  if constexpr (VEC == 4) {  // f32 at 8 bytes: two float2
    if (al == 8 && i + VEC <= m) {
      const float2 lo = __ldg(reinterpret_cast<const float2*>(base + i));
      const float2 hi = __ldg(reinterpret_cast<const float2*>(base + i + 2));
      c.v[0] = lo.x;
      c.v[1] = lo.y;
      c.v[2] = hi.x;
      c.v[3] = hi.y;
      return c;
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) c.v[e] = i + e < m ? __ldg(base + i + e) : T(0);
  return c;
}

// mode 3's step at row pos: xv the row's x (as read), y its product
template <typename T>
__device__ __forceinline__ T cheby_row(const Args<T>& p, int64_t pos,
                                       T xv, T y) {
  const T dp = p.dprev != nullptr ? p.dprev[pos] : xv;
  const T dn = p.ca * dp + p.cc * (p.cw[pos] * (p.b[pos] - y));
  if (p.dout != nullptr) p.dout[pos] = dn;
  return xv + dn;
}

// the epilogue: row r of supernode s to its place in the flat output
template <typename T, bool SCALE, bool MASK, int PW>
__device__ __forceinline__ void store_row(const Args<T>& p, int s, int r,
                                          T acc) {
  int64_t pos;
  bool ok;
  if (r < p.R0) {
    pos = (int64_t)s * p.R0 + r;
    ok = pos < p.n0;
  } else {
    const int64_t li = (int64_t)s * (p.R - p.R0) + (r - p.R0);
    ok = li < p.n1;
    pos = p.n0 + li;
  }
  if (!ok) return;
  T y = acc;
  if constexpr (PW > 0) {  // the own row's xhat, K8's expression
    // row r of supernode s is value r of its column block (R == C)
    const T cv = __ldg(p.pxc + __ldg(p.pagg + (int64_t)s * (p.C / PW) +
                                     r / PW) * PW + r % PW);
    const T xv = SCALE ? p.sc[pos] * p.x0[pos] + cv : p.x0[pos] + cv;
    if (p.xhat != nullptr) p.xhat[pos] = xv;
    if (p.mode == 1) {
      y = p.b[pos] - acc;
    } else if (p.mode == 2) {
      y = xv + p.omega * (p.b[pos] - acc) / p.d[pos];
    } else {  // mode 3 (the host refuses mode 0)
      y = cheby_row(p, pos, xv, acc);
    }
  } else if (p.mode == 1) {
    y = p.b[pos] - acc;
  } else if (p.mode >= 2) {
    const T xv = SCALE ? p.sc[pos] * p.x0[pos] : p.x0[pos];
    if (p.mode == 2) {
      y = xv + p.omega * (p.b[pos] - acc) / p.d[pos];
    } else {
      T yp = acc;
      if constexpr (MASK) {
        if (p.mask[pos]) yp = xv;  // identity rows
      }
      y = cheby_row(p, pos, xv, yp);
    }
  }
  if (p.add != nullptr) y = y + p.add[pos];
  if constexpr (MASK) {
    if (p.mode != 3 && p.mask[pos]) y = p.mv != nullptr ? p.mv[pos] : T(0);
  }
  p.out[pos] = y;
}

// A lane sums RPL rows of one supernode, r0 + j*R/RPL (j < RPL), over its
// share of the blocks and of the columns: each gathered x chunk serves
// RPL rows.
template <typename T, int VEC, int RPL, bool SCALE, bool MASK, int PW>
__device__ __forceinline__ void sup_spmv_body(const Args<T>& p) {
  const int G = 1 << p.lg;
  const int Kg = p.Kg, KS = p.KS, Rq = p.R / RPL;
  for (int t0 = blockIdx.x * kThreads; t0 < p.n_lanes;
       t0 += gridDim.x * kThreads) {
    const int t = t0 + threadIdx.x;  // the whole block takes each step
    const int set = t >> p.lg, g = t & (G - 1);
    const int ks = g / p.CV, c0 = (g - ks * p.CV) * VEC;
    const int s = set / Rq, r0 = set - s * Rq;
    NodeOf<VEC> q{};
    if constexpr (PW > 0) q = node_of<VEC, PW>(c0);
    T acc[RPL];
#pragma unroll
    for (int j = 0; j < RPL; ++j) acc[j] = T(0);
    if (t < p.n_lanes && ks < KS) {
      const T* a = p.A + s * p.sA0 + r0 * p.sA2 + c0;
      const int64_t sj = Rq * p.sA2;
      const int* cl = p.cols + (int64_t)s * Kg;
      constexpr int U = PW > 0 ? kUnrollProlong : kUnroll<VEC>;
      for (int kb = ks; kb < Kg; kb += U * KS) {
        Chunk<T, VEC> av[U][RPL];
        int cv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = kb + u * KS;
          if (k < Kg) {
            cv[u] = __ldg(cl + k);
#pragma unroll
            for (int j = 0; j < RPL; ++j) {
              av[u][j] = load_chunk<T, VEC, true>(a + k * p.sA1 + j * sj);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (kb + u * KS < Kg) {
            const Chunk<T, VEC> xv =
                load_x<T, VEC, SCALE, PW>(p, cv[u], c0, q);
#pragma unroll
            for (int j = 0; j < RPL; ++j) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                acc[j] = fma(av[u][j].v[e], xv.v[e], acc[j]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      for (int off = G >> 1; off > 0; off >>= 1) {
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      }
    }
    if (g == 0 && t < p.n_lanes) {
#pragma unroll
      for (int j = 0; j < RPL; ++j) {
        store_row<T, SCALE, MASK, PW>(p, s, r0 + j * Rq, acc[j]);
      }
    }
  }
}

template <typename T, int VEC, int RPL, bool SCALE, bool MASK>
__global__ void __launch_bounds__(kThreads)
    sup_spmv_kernel(const Args<T> p) {
  sup_spmv_body<T, VEC, RPL, SCALE, MASK, 0>(p);
}

// the fused coarse-grid correction under its own name, so a trace tells
// its launches from K1's others
template <typename T, int VEC, int RPL, bool SCALE, int PW>
__global__ void __launch_bounds__(kThreads, kBlocksProlong)
    sup_spmv_prolong_kernel(const Args<T> p) {
  sup_spmv_body<T, VEC, RPL, SCALE, false, PW>(p);
}

template <typename T, int VEC, int RPL, bool SCALE, bool MASK>
int launch(const Args<T>& a, cudaStream_t st) {
  const auto fn = sup_spmv_kernel<T, VEC, RPL, SCALE, MASK>;
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
  const int grid = std::min<int64_t>((a.n_lanes + kThreads - 1) / kThreads,
                                     resident);
  fn<<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int RPL, bool SCALE, int PW>
int launch_prolong(const Args<T>& a, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const auto fn = sup_spmv_prolong_kernel<T, V, RPL, SCALE, PW>;
  static int resident = 0;  // as in launch()
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
  const int grid = std::min<int64_t>((a.n_lanes + kThreads - 1) / kThreads,
                                     resident);
  fn<<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool SCALE>
int prolong_w(const Args<T>& a, int pw, int rpl, cudaStream_t st) {
  if (pw == 1) {
    return rpl == 2 ? launch_prolong<T, 2, SCALE, 1>(a, st)
                    : launch_prolong<T, 1, SCALE, 1>(a, st);
  }
  if (pw == 2) {
    return rpl == 2 ? launch_prolong<T, 2, SCALE, 2>(a, st)
                    : launch_prolong<T, 1, SCALE, 2>(a, st);
  }
  if (pw == 3) {
    return rpl == 2 ? launch_prolong<T, 2, SCALE, 3>(a, st)
                    : launch_prolong<T, 1, SCALE, 3>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int prolong_rpl(const Args<T>& a, bool scale, int pw, int rpl,
                cudaStream_t st) {
  return scale ? prolong_w<T, true>(a, pw, rpl, st)
               : prolong_w<T, false>(a, pw, rpl, st);
}

template <typename T, bool SCALE, bool MASK>
int shapes(const Args<T>& a, int vec, int rpl, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec == 1 && rpl == 1) return launch<T, 1, 1, SCALE, MASK>(a, st);
  if (vec != V) return (int)cudaErrorInvalidValue;
  if (rpl == 1) return launch<T, V, 1, SCALE, MASK>(a, st);
  if (rpl == 2) return launch<T, V, 2, SCALE, MASK>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(const void* A, int64_t sA0, int64_t sA1, int64_t sA2,
        const void* cols, int ns, int Kg, int R, int C, const void* x0,
        int64_t m0, int w0, int xa0, const void* x1, int64_t m1, int xa1,
        void* out, int64_t n0, int R0, int64_t n1, int mode, const void* b,
        const void* d, double omega, const void* sc, const void* mask,
        const void* mv, const void* pxc, const void* pagg, int pw,
        void* xhat, const void* cw, const void* dprev, void* dout,
        const void* add, double ca, double cc, int vec, int rpl, int CV,
        int KS, int lg, void* stream) {
  Args<T> a;
  a.A = static_cast<const T*>(A);
  a.sA0 = sA0;
  a.sA1 = sA1;
  a.sA2 = sA2;
  a.cols = static_cast<const int*>(cols);
  a.ns = ns;
  a.Kg = Kg;
  a.R = R;
  a.C = C;
  a.x0 = static_cast<const T*>(x0);
  a.m0 = m0;
  a.w0 = w0;
  a.xa0 = xa0;
  a.x1 = static_cast<const T*>(x1);
  a.m1 = m1;
  a.xa1 = xa1;
  a.out = static_cast<T*>(out);
  a.n0 = n0;
  a.R0 = R0;
  a.n1 = n1;
  a.mode = mode;
  a.b = static_cast<const T*>(b);
  a.d = static_cast<const T*>(d);
  a.omega = static_cast<T>(omega);
  a.sc = static_cast<const T*>(sc);
  a.mask = static_cast<const unsigned char*>(mask);
  a.mv = static_cast<const T*>(mv);
  a.pxc = static_cast<const T*>(pxc);
  a.pagg = static_cast<const int*>(pagg);
  a.xhat = static_cast<T*>(xhat);
  a.cw = static_cast<const T*>(cw);
  a.dprev = static_cast<const T*>(dprev);
  a.dout = static_cast<T*>(dout);
  a.add = static_cast<const T*>(add);
  a.ca = static_cast<T>(ca);
  a.cc = static_cast<T>(cc);
  a.CV = CV;
  a.KS = KS;
  a.lg = lg;
  a.n_lanes = (int)(((int64_t)ns * (R / rpl)) << lg);
  const auto st = static_cast<cudaStream_t>(stream);
  if (pxc != nullptr) {  // instantiated: 16-byte chunks, no mask, w 1-3
    if (vec != 16 / (int)sizeof(T) || mask != nullptr ||
        (rpl != 1 && rpl != 2)) {
      return (int)cudaErrorInvalidValue;
    }
    return prolong_rpl<T>(a, sc != nullptr, pw, rpl, st);
  }
  if (sc != nullptr) {
    return mask != nullptr ? shapes<T, true, true>(a, vec, rpl, st)
                           : shapes<T, true, false>(a, vec, rpl, st);
  }
  return mask != nullptr ? shapes<T, false, true>(a, vec, rpl, st)
                         : shapes<T, false, false>(a, vec, rpl, st);
}

}  // namespace

extern "C" int cfd_sup_spmv(
    const void* A, int64_t sA0, int64_t sA1, int64_t sA2, const void* cols,
    int ns, int Kg, int R, int C, const void* x0, int64_t m0, int w0,
    int xa0, const void* x1, int64_t m1, int xa1, void* out, int64_t n0,
    int R0, int64_t n1, int mode, const void* b, const void* d,
    double omega, const void* sc, const void* mask, const void* mv,
    const void* pxc, const void* pagg, int pw, void* xhat, const void* cw,
    const void* dprev, void* dout, const void* add, double ca, double cc,
    int vec, int rpl, int CV, int KS, int lg, int is_f64, void* stream) {
  if (ns <= 0 || n0 + n1 <= 0) return (int)cudaGetLastError();
  if (lg < 0 || lg > 5 || CV < 1 || KS < 1 || CV * KS > (1 << lg) ||
      rpl < 1 || R % rpl || ((int64_t)ns * (R / rpl) << lg) >= (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  if (sc != nullptr && (C != w0 || m1 != 0)) {  // the scale: one x only
    return (int)cudaErrorInvalidValue;
  }
  // the prolongation: one x only, of whole nodes, square, out = x's
  // rows, 8 nodes a supernode at w 1, 2 or 3, agg and xc aligned (xc to
  // a node at w 2)
  if (pxc != nullptr &&
      (C != w0 || m1 != 0 || pw < 1 || pw > 3 || C != 8 * pw ||
       m0 % pw || R != C || R0 != R || n1 != 0 || n0 != m0 || mode == 0 ||
       pagg == nullptr || reinterpret_cast<uintptr_t>(pagg) % 16 ||
       reinterpret_cast<uintptr_t>(pxc) %
           ((pw == 2 ? 2 : 1) * (is_f64 ? 8 : 4)))) {
    return (int)cudaErrorInvalidValue;
  }
  if (xhat != nullptr && pxc == nullptr) return (int)cudaErrorInvalidValue;
  // mode 3: square, one x (its rows are the output's), w given; add:
  // modes 2 and 3 without a mask
  if (mode == 3 && (cw == nullptr || b == nullptr || C != w0 || m1 != 0 ||
                    R != C || R0 != R || n1 != 0 || n0 != m0 ||
                    mv != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((mode != 3 && (cw != nullptr || dprev != nullptr || dout != nullptr)) ||
      (add != nullptr && (mode < 2 || mask != nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  return is_f64 ? run<double>(A, sA0, sA1, sA2, cols, ns, Kg, R, C, x0, m0,
                              w0, xa0, x1, m1, xa1, out, n0, R0, n1, mode, b,
                              d, omega, sc, mask, mv, pxc, pagg, pw, xhat,
                              cw, dprev, dout, add, ca, cc, vec, rpl, CV,
                              KS, lg, stream)
                : run<float>(A, sA0, sA1, sA2, cols, ns, Kg, R, C, x0, m0,
                             w0, xa0, x1, m1, xa1, out, n0, R0, n1, mode, b,
                             d, omega, sc, mask, mv, pxc, pagg, pw, xhat,
                             cw, dprev, dout, add, ca, cc, vec, rpl, CV, KS,
                             lg, stream);
}

// cheby_update: mode 3's step alone, after an operator that is not one
// K1 launch (la/chebyshev.py; the SELFP S of the chebyshev inner
// methods, two launches): y = A x given,
//   dn = ca * (dprev or x) + cc * (w * (b - y)),  out = x + dn,
// dn into dout where given. Elementwise and bound by its bytes (five
// vectors in, two out: 0.99 MB at the S stage of 35,425 float32 values,
// 0.30 us at 3.35 TB/s), so by its launch: one pass, one thread a value.

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cheby_update_kernel(const T* __restrict__ x, const T* __restrict__ y,
                        const T* __restrict__ b, const T* __restrict__ w,
                        const T* __restrict__ dprev, T* __restrict__ out,
                        T* __restrict__ dout, int64_t n, T ca, T cc) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const T xv = x[i];
    const T dp = dprev != nullptr ? dprev[i] : xv;
    const T dn = ca * dp + cc * (w[i] * (b[i] - y[i]));
    if (dout != nullptr) dout[i] = dn;
    out[i] = xv + dn;
  }
}

template <typename T>
int cheby_update_run(const void* x, const void* y, const void* b,
                     const void* w, const void* dprev, void* out,
                     void* dout, int64_t n, double ca, double cc,
                     cudaStream_t st) {
  const int grid =
      (int)std::min<int64_t>((n + kThreads - 1) / kThreads, 1 << 20);
  cheby_update_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(b), static_cast<const T*>(w),
      static_cast<const T*>(dprev), static_cast<T*>(out),
      static_cast<T*>(dout), n, static_cast<T>(ca), static_cast<T>(cc));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cfd_cheby_update(const void* x, const void* y, const void* b,
                                const void* w, const void* dprev, void* out,
                                void* dout, int64_t n, double ca, double cc,
                                int is_f64, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const auto st = static_cast<cudaStream_t>(stream);
  return is_f64 ? cheby_update_run<double>(x, y, b, w, dprev, out, dout, n,
                                           ca, cc, st)
                : cheby_update_run<float>(x, y, b, w, dprev, out, dout, n,
                                          ca, cc, st);
}
