// Fused packed-row gather + corner combine for Hopper (sm_90a).
//
//   out[n, f] = sum_{c < nc} w[n, c] * table[idx[n], c * nf + f]
//
// Replaces the Pallas TPU kernel grtrans_tpu/ops/pallas_gather.py
// (vmem_row_gather, the pallas_call at :49) together with its XLA
// epilogue quad_combine (:64), in one pass.  Callers: FFJet.vals (4
// corners x 9 fields of the bilinear sampler), polsynchpl._g_all (2
// bracketing rows x 6 cutoff tables) and its per-sample-p lookup (4 x 6),
// the 2-D snapshot samplers of HARM (4 x 10) and KORAL (4 x 11), SphAcc
// (2 x 2), NumDisk (4 x 1) and PhatDisk (2 x 101).
//
// What bounds it: the bytes it must move (index, weights and output once
// through device memory) set the floor, but with scattered rows the time
// goes to the row traffic out of L2 and to the instructions that fetch it,
// not to device memory.  The TPU kernel pinned the table in VMEM; on
// Hopper the FFJET table (16384 x 36) is 4.7 MB in float64 and 2.4 MB in
// float32, far above the 227 KB of shared memory a block can use, but it
// sits easily in the 50 MB L2, so rows are read straight through L2/L1.
//
// Kernels of quad_gather:
//  * quad_gather_tiled<T, NC, NF>, for every narrow shape in use (the
//    list in launch() below; each row a whole number of 16-byte pieces in
//    both dtypes).  A block of 128 threads takes a tile of 128 queries.
//    Each thread reads its own query's index and weights once (16-byte
//    loads).  The block then fetches the 128 rows as one stream of 16-byte
//    pieces, neighbouring threads on neighbouring pieces of a row, so a
//    warp's load covers whole rows instead of 32 scattered sectors, and
//    every thread has all its row pieces (18 for a float64 FFJET row) in
//    flight before the first is used.  The rows are laid into shared
//    memory at an odd stride, each thread combines its own query from
//    there (corners summed in the order c = 0..NC-1), and the tile's
//    outputs go back through shared memory so that they leave in 16-byte
//    stores on consecutive addresses.  No run-time divide.  The pipeline
//    (tiled_pipeline) is written once; its epilogue is a template
//    parameter, so that the weights' backward, quad_gather_bwd_w_tiled,
//    runs on the same steps (the end of this file).
//  * quad_gather_wide<T>, for wide rows (nf >= 32; PHATDISK's pair-packed
//    table has nc x nf = 2 x 101): a warp a query, eight queries a warp in
//    sequence.  One lane reads the index and nc lanes the weights, once,
//    and the warp shares them by shuffle; lanes stride f = lane, lane + 32,
//    ... so that every warp-wide load of table[row, c * nf + f] and every
//    store of out[n, f] covers 32 consecutive elements.  The next query's
//    index and weights are fetched while the current one is combined.  No
//    16-byte vectors: a row's second half and out[n] are only element
//    aligned when nf is odd.  The table is small and stays in L2/L1; the
//    output stream is what costs, and it leaves in whole lines.
//  * quad_gather_generic<T>, for any other (nc, nf) or for operands that
//    are not 16-byte aligned: one thread per output element.
//
// And the multi-row gather of the GRMHD snapshot samplers,
//
//   out[n, f] = sum_{r < R} sum_{c < nc} w[n, r, c] * table[idx[n, r], c * nf + f]
//
// what Grmhd3D._gather_cols (grtrans_tpu/fluid/grmhd3d.py:212),
// thickdisk.py:269, koral.py:402 and harmpi.py:520 leave to one fused XLA
// gather + weighted sum.  R rows of a phi-pair-packed table (nc = 2) are
// the corners of a trilinear cell (R = 4; R = 8 with the two time slices of
// slow light folded into the weights), R rows of a plain table (nc = 1) the
// corners of a binned population.  A snapshot table is hundreds of MB, far
// beyond L2, so scattered rows come from device memory; element offsets
// idx * (nc * nf) are formed in 64 bits.
//  * quad_gather_rows_tiled<T, R, NC>, for (R, NC) in (4, 2),
//    (8, 2), (1, 1) and rows that are whole 16-byte pieces of at most
//    kRowsMaxRowBytes.  A persistent grid; a block of 128
//    threads takes tiles of 128 / R consecutive queries, one (query, row)
//    slot a thread.  Each thread reads its slot's index and weights one
//    tile ahead (coalesced), so their latency hides behind the tile being
//    combined.  Each row a slot names is copied from global to shared
//    memory by one Hopper bulk copy (cp.async.bulk, no tensor map),
//    completion counted on the stage's mbarrier, armed with the tile's
//    bytes; two stages, so the next tile's copies are in flight while this
//    one is combined.  Lanes of a warp that name one row (neighbouring
//    points of a ray share cells; a frame names each row ~8 times) share
//    the copy of the lowest of them (__match_any_sync): +17% on a frame's
//    rows, a tie on random rows (PERF.md).  The combine is one thread per
//    (query, field) from shared memory, rows r-major then corners c, as
//    the plain version sums; the outputs leave through shared memory in
//    16-byte stores.  The
//    launch set-up (shared-memory attribute, resident blocks) is worked out
//    once per kernel, device and row size.  The pipeline (rows_pipeline:
//    index fetch, ring, dedup, tile stream) is written once; its epilogue
//    is a template parameter, so that the weights' backward,
//    quad_gather_rows_bwd_w_tiled, runs on it too.  Measured (PERF.md): the
//    frame's rows take 54% of their byte bound; uniformly random rows of a
//    755 MB table stay at 32% whatever the tile, ring depth or
//    deduplication.
//  * quad_gather_rows_simple<T, R, NC>, for rows the bulk copy cannot take
//    (not whole 16-byte pieces, e.g. KORAL3D's 2 x 11 in float32, or a
//    table that is not 16-byte aligned), for the binned populations (R =
//    8 or 4 rows of nc = 1: ~100,000 queries give a persistent block one
//    to three tiles, too few for the ring to hide a copy's round trip;
//    measured no faster tiled, PERF.md) and any other (R, nc): sixteen
//    lanes a query, lane f < nf owns output field f, each
//    of the R * nc loads nf consecutive elements, index and weight loads
//    broadcast within the group, all loads in flight before the first use;
//    <T, 0, 0> takes any (R, nc) at run time.
//
// Ragged edges are masked here (no padding to a block multiple).  An
// index outside [0, ns) sets *err and writes NaN for that query instead of
// reading out of bounds; the host reads the flag after a run.
//
// C interface (ctypes, bound by ops/_build.load): quad_gather_f32 /
// quad_gather_f64 launch on the given stream and return
// cudaGetLastError().  `variant` names the kernel, which ops/quad_gather.py
// picks from the shape, dtype and alignment alone: 0 tiled (the shape must be one it is built for), 1 generic, 2
// wide.  quad_gather_rows_f32 / _f64 launch the multi-row gather the same
// way: `variant` 0 tiled, 1 simple.  quad_gather_bwd_w_f32 / _f64 and
// quad_gather_rows_bwd_w_f32 / _f64 launch the backward with respect to
// the weights (the end of this file): `variant` 0 tiled (a shape of the
// tiled forward, operands on 16 bytes), 1 the first design (generic for
// R = 1, simple for rows), which takes any shape.  A tiled launch the
// shape or alignment does not admit returns cudaErrorInvalidValue.

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() {
  return CUDART_NAN_F;
}
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return CUDART_NAN;
}

// 16-byte vector of T and its lanes.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
};
template <> struct Vec16<double> {
  using type = double2;
};
__device__ __forceinline__ void unpack(const float4& v, float* a) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double* a) {
  a[0] = v.x;
  a[1] = v.y;
}
__device__ __forceinline__ float4 pack(const float* a) {
  return make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ double2 pack(const double* a) {
  return make_double2(a[0], a[1]);
}

template <typename T>
__global__ void quad_gather_generic(const T* __restrict__ table,
                                    const int32_t* __restrict__ idx,
                                    const T* __restrict__ w,
                                    T* __restrict__ out,
                                    int* __restrict__ err,
                                    long long n, int ns, int nc, int nf) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n * nf) return;
  const long long q = t / nf;
  const int f = static_cast<int>(t - q * nf);
  const int row = __ldg(idx + q);
  if (row < 0 || row >= ns) {
    atomicExch(err, 1);
    out[t] = quiet_nan<T>();
    return;
  }
  const T* trow = table + static_cast<long long>(row) * nc * nf + f;
  const T* wq = w + q * nc;
  T acc = T(0);
  for (int c = 0; c < nc; ++c) acc += __ldg(wq + c) * __ldg(trow + c * nf);
  out[t] = acc;
}

constexpr int kTile = 128;  // queries, and threads, per block

// ---- the R = 1 tile pipeline, shared by quad_gather_tiled and
// quad_gather_bwd_w_tiled ----
//
// The epilogue, a template parameter, is what a kernel does with a query
// once its row lies in shared memory: TiledCombine (the forward: x the
// weights (N, NC), NF outputs a query) or TiledWeightGrad (the backward
// with respect to the weights: x the output's gradient (N, NF), NC outputs
// a query).  Each provides OUT (outputs a query), load (the query's
// operand, read before the rows are issued), settle (run while the rows'
// loads are in flight) and compute (the query's OUT values from its row).

template <typename T, int NC, int NF>
struct TiledCombine {
  static constexpr int OUT = NF;
  T wq[NC];

  // this thread's weights, read once (16-byte loads where NC allows)
  __device__ __forceinline__ void load(const T* __restrict__ w, long long q0,
                                       int t, int nq) {
    using V = typename Vec16<T>::type;
    constexpr int VEC = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < NC; ++c) wq[c] = T(0);
    if (t >= nq) return;
    const T* wp = w + (q0 + t) * NC;
    if constexpr (NC % VEC == 0) {
#pragma unroll
      for (int i = 0; i < NC / VEC; ++i)
        unpack(__ldg(reinterpret_cast<const V*>(wp) + i), wq + i * VEC);
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) wq[c] = __ldg(wp + c);
    }
  }

  __device__ __forceinline__ void settle(T*, int, int) {}

  // corners in the order c = 0..NC-1
  __device__ __forceinline__ void compute(const T* row, T* acc) const {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      T a = T(0);
#pragma unroll
      for (int c = 0; c < NC; ++c) a += wq[c] * row[c * NF + f];
      acc[f] = a;
    }
  }
};

template <typename T, int NC, int NF>
struct TiledWeightGrad {
  using V = typename Vec16<T>::type;
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int OUT = NC;
  // a query's g is whole 16-byte pieces (float64 2x6, 4x6, 4x10, 2x2):
  // each thread loads its own; else the tile's g, one run of kTile NF
  // values, arrives as pieces t, t + kTile, ... a thread and passes
  // through shared memory
  static constexpr bool OWN = NF % VEC == 0;
  static constexpr int GV = (NF + VEC - 1) / VEC;
  V gv[GV];
  T gt;       // an element of a ragged last tile's tail
  int total;  // values of g in this tile
  T gq[NF];   // this thread's query's g

  // g read once, in 16-byte loads
  __device__ __forceinline__ void load(const T* __restrict__ g, long long q0,
                                       int t, int nq) {
    if constexpr (OWN) {
#pragma unroll
      for (int f = 0; f < NF; ++f) gq[f] = T(0);
      if (t < nq) {
        const V* gp = reinterpret_cast<const V*>(g + (q0 + t) * NF);
#pragma unroll
        for (int i = 0; i < NF / VEC; ++i) unpack(__ldg(gp + i), gq + i * VEC);
      }
    } else {
      total = nq * NF;
      const T* gp = g + q0 * NF;
      const int nvec = total / VEC;
#pragma unroll
      for (int i = 0; i < GV; ++i) {
        const int k = t + i * kTile;
        if (k < nvec) gv[i] = __ldg(reinterpret_cast<const V*>(gp) + k);
      }
      const int k = nvec * VEC + t;
      if (k < total) gt = __ldg(gp + k);
    }
  }

  // while the rows' loads are in flight: the tile's run through shared
  // memory, from which each thread takes its query's NF values
  __device__ __forceinline__ void settle(T* s_buf, int t, int nq) {
    if constexpr (!OWN) {
      const int nvec = total / VEC;
#pragma unroll
      for (int i = 0; i < GV; ++i) {
        const int k = t + i * kTile;
        if (k < nvec) reinterpret_cast<V*>(s_buf)[k] = gv[i];
      }
      const int k = nvec * VEC + t;
      if (k < total) s_buf[k] = gt;
      __syncthreads();
#pragma unroll
      for (int f = 0; f < NF; ++f) gq[f] = t < nq ? s_buf[t * NF + f] : T(0);
      __syncthreads();   // the stage is free for the rows
    }
  }

  // dw[c] = sum_f g[f] row[c NF + f], fields in the order f = 0..NF-1
  __device__ __forceinline__ void compute(const T* row, T* acc) const {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      T a = T(0);
#pragma unroll
      for (int f = 0; f < NF; ++f) a += gq[f] * row[c * NF + f];
      acc[c] = a;
    }
  }
};

template <typename T, int NC, int NF, class Epi>
__device__ __forceinline__ void tiled_pipeline(const T* __restrict__ table,
                                               const int32_t* __restrict__ idx,
                                               const T* __restrict__ x,
                                               T* __restrict__ out,
                                               int* __restrict__ err,
                                               long long n, long long ns) {
  using V = typename Vec16<T>::type;
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte piece
  constexpr int ROW = NC * NF;          // elements per table row
  static_assert(ROW % VEC == 0, "rows must be whole 16-byte pieces");
  constexpr int RV = ROW / VEC;         // pieces per row, and per thread
  constexpr int STRIDE = ROW | 1;       // odd: no bank conflict on reads
  constexpr int OUT = Epi::OUT;
  static_assert(NF <= STRIDE && OUT <= STRIDE, "g and output stages fit");
  static_assert(kTile * STRIDE * sizeof(T) + kTile * 4 <= 48 * 1024,
                "static shared stage fits");

  __shared__ int s_row[kTile];
  __shared__ __align__(16) T s_buf[kTile * STRIDE];

  const int t = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long left = n - q0;
  const int nq = left < kTile ? static_cast<int>(left) : kTile;

  // 1. this thread's query: index and the epilogue's operand, read once
  int row = -1;
  bool bad = false;
  Epi epi;
  if (t < nq) {
    row = __ldg(idx + q0 + t);
    if (row < 0 || row >= ns) {
      bad = true;
      row = -1;
      atomicExch(err, 1);
    }
  }
  epi.load(x, q0, t, nq);
  s_row[t] = row;
  __syncthreads();

  // 2. the tile's rows as one stream of 16-byte pieces: piece k belongs
  //    to query k / RV; all RV loads are issued before any is stored
  V regs[RV];
#pragma unroll
  for (int i = 0; i < RV; ++i) {
    const int k = i * kTile + t;
    const int qq = k / RV;
    const int piece = k - qq * RV;
    const int r = s_row[qq];
    T zero[VEC] = {};
    regs[i] = r >= 0
        ? __ldg(reinterpret_cast<const V*>(
                    table + static_cast<long long>(r) * ROW) + piece)
        : pack(zero);
  }
  epi.settle(s_buf, t, nq);
#pragma unroll
  for (int i = 0; i < RV; ++i) {
    const int k = i * kTile + t;
    const int qq = k / RV;
    const int piece = k - qq * RV;
    T lanes[VEC];
    unpack(regs[i], lanes);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      s_buf[qq * STRIDE + piece * VEC + e] = lanes[e];
  }
  __syncthreads();

  // 3. this thread's query from its row in shared memory
  T acc[OUT];
  epi.compute(s_buf + t * STRIDE, acc);
#pragma unroll
  for (int o = 0; o < OUT; ++o)
    if (bad) acc[o] = quiet_nan<T>();
  __syncthreads();

  // 4. outputs through shared memory, then 16-byte stores in order
#pragma unroll
  for (int o = 0; o < OUT; ++o) s_buf[t * OUT + o] = acc[o];
  __syncthreads();
  const int total = nq * OUT;
  T* o = out + q0 * OUT;
  const int nvec = total / VEC;
  for (int k = t; k < nvec; k += kTile)
    reinterpret_cast<V*>(o)[k] = *reinterpret_cast<const V*>(s_buf + k * VEC);
  for (int k = nvec * VEC + t; k < total; k += kTile) o[k] = s_buf[k];
}

template <typename T, int NC, int NF>
__global__ void __launch_bounds__(kTile)
quad_gather_tiled(const T* __restrict__ table,
                  const int32_t* __restrict__ idx,
                  const T* __restrict__ w, T* __restrict__ out,
                  int* __restrict__ err, long long n, long long ns) {
  tiled_pipeline<T, NC, NF, TiledCombine<T, NC, NF>>(table, idx, w, out, err,
                                                     n, ns);
}

template <typename T, int NC, int NF>
__global__ void __launch_bounds__(kTile)
quad_gather_bwd_w_tiled(const T* __restrict__ table,
                        const int32_t* __restrict__ idx,
                        const T* __restrict__ g, T* __restrict__ dw,
                        int* __restrict__ err, long long n, long long ns) {
  tiled_pipeline<T, NC, NF, TiledWeightGrad<T, NC, NF>>(table, idx, g, dw,
                                                        err, n, ns);
}

constexpr int kWideWarps = 8;    // warps per block
constexpr int kWideQueries = 8;  // queries a warp takes in sequence

template <typename T>
__global__ void __launch_bounds__(kWideWarps * 32)
quad_gather_wide(const T* __restrict__ table, const int32_t* __restrict__ idx,
                 const T* __restrict__ w, T* __restrict__ out,
                 int* __restrict__ err, long long n, int ns, int nc, int nf) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWideWarps + (threadIdx.x >> 5);
  const long long q0 = warp * kWideQueries;
  if (q0 >= n) return;
  const long long left = n - q0;
  const int nq = left < kWideQueries ? static_cast<int>(left) : kWideQueries;
  const int rowlen = nc * nf;

  // lane 0 holds the index, lanes 0..nc-1 the weights, of the query ahead
  int row_l = lane == 0 ? __ldg(idx + q0) : 0;
  T w_l = lane < nc ? __ldg(w + q0 * nc + lane) : T(0);
  for (int i = 0; i < nq; ++i) {
    const long long q = q0 + i;
    const int row = __shfl_sync(kFull, row_l, 0);
    const T wq = w_l;
    if (i + 1 < nq) {
      row_l = lane == 0 ? __ldg(idx + q + 1) : 0;
      w_l = lane < nc ? __ldg(w + (q + 1) * nc + lane) : T(0);
    }
    const bool bad = row < 0 || row >= ns;
    if (bad && lane == 0) atomicExch(err, 1);
    const T* trow = table + static_cast<long long>(bad ? 0 : row) * rowlen;
    T* o = out + q * nf;
    for (int f0 = 0; f0 < nf; f0 += 32) {
      const int f = f0 + lane;
      const bool live = f < nf;
      T acc = T(0);
      for (int c = 0; c < nc; ++c) {
        const T wc = __shfl_sync(kFull, wq, c);
        if (live) acc += wc * __ldg(trow + c * nf + f);
      }
      if (live) o[f] = bad ? quiet_nan<T>() : acc;
    }
  }
}

constexpr int kRowsGroup = 16;     // lanes a query
constexpr int kRowsThreads = 256;  // threads a block

// R_ = NC_ = 0: the row and corner counts are the run-time r_rt, nc.
template <typename T, int R_, int NC_>
__global__ void __launch_bounds__(kRowsThreads)
quad_gather_rows_simple(const T* __restrict__ table,
                        const int32_t* __restrict__ idx,
                        const T* __restrict__ w, T* __restrict__ out,
                        int* __restrict__ err, long long n, long long ns,
                        int r_rt, int nc_rt, int nf) {
  const int R = R_ > 0 ? R_ : r_rt;
  const int NC = NC_ > 0 ? NC_ : nc_rt;
  const int g = threadIdx.x & (kRowsGroup - 1);
  const long long q =
      (static_cast<long long>(blockIdx.x) * kRowsThreads + threadIdx.x) /
      kRowsGroup;
  if (q >= n) return;
  const long long rowlen = static_cast<long long>(NC) * nf;
  const int32_t* iq = idx + q * R;
  const T* wq = w + q * R * NC;
  T* o = out + q * nf;

  if constexpr (R_ > 0) {
    // the renderer's shapes: every load in flight before the first use
    long long off[R_];
    bool bad = false;
#pragma unroll
    for (int r = 0; r < R_; ++r) {
      const long long row = __ldg(iq + r);
      const bool b = row < 0 || row >= ns;
      bad |= b;
      off[r] = (b ? 0 : row) * rowlen;
    }
    if (bad && g == 0) atomicExch(err, 1);
    T wv[R_ * NC_];
#pragma unroll
    for (int k = 0; k < R_ * NC_; ++k) wv[k] = __ldg(wq + k);
    for (int f = g; f < nf; f += kRowsGroup) {
      T v[R_ * NC_];
#pragma unroll
      for (int r = 0; r < R_; ++r)
#pragma unroll
        for (int c = 0; c < NC_; ++c)
          v[r * NC_ + c] = __ldg(table + off[r] + c * nf + f);
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < R_ * NC_; ++k) acc += wv[k] * v[k];
      o[f] = bad ? quiet_nan<T>() : acc;
    }
  } else {
    bool bad = false;
    for (int r = 0; r < R; ++r) {
      const long long row = __ldg(iq + r);
      bad |= row < 0 || row >= ns;
    }
    if (bad && g == 0) atomicExch(err, 1);
    for (int f = g; f < nf; f += kRowsGroup) {
      T acc = T(0);
      if (!bad) {
        for (int r = 0; r < R; ++r) {
          const T* trow = table + static_cast<long long>(__ldg(iq + r)) * rowlen;
          for (int c = 0; c < NC; ++c)
            acc += __ldg(wq + r * NC + c) * __ldg(trow + c * nf + f);
        }
      }
      o[f] = bad ? quiet_nan<T>() : acc;
    }
  }
}

// ---- the multi-row pipeline: bulk copies into a two-stage ring, shared
// by quad_gather_rows_tiled and quad_gather_rows_bwd_w_tiled ----

// the tile and the ring: 128 slots x 2 stages measured best of 128 / 256
// slots and 2-4 stages (PERF.md)
constexpr int kRowsSlots = 128;   // (query, row) slots a tile, threads a block
constexpr int kRowsStages = 2;    // tiles a block has in shared memory
constexpr int kRowsMaxRowBytes = 256;      // keeps two stages within shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// arrive once and add `bytes` to the transactions the phase waits for; the
// copies may complete before this (the count goes negative meanwhile), but
// the phase cannot end before the arrival
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// wait for the phase of the given parity to end; a phase that has not
// ended after a second (a fault of this kernel) traps instead of hanging
// the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  const unsigned long long start = global_ns();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (global_ns() - start > 1000000000ull) {
      printf("quad_gather rows pipeline: block %d thread %d: barrier phase "
             "of parity %u did not end\n", blockIdx.x, threadIdx.x, parity);
      __trap();
    }
  }
}

// one row, global -> shared, completion counted on `bar`
__device__ __forceinline__ void bulk_copy_row(void* dst, const void* src,
                                              unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The epilogue, a template parameter, is what a kernel does with a tile
// once its rows lie in shared memory: RowsCombine (the forward: x the
// weights (N, R, NC), nf outputs a query) or RowsWeightGrad (the backward
// with respect to the weights: x the output's gradient (N, nf), R NC
// outputs a query).  Each provides stage_elems / out_elems (shared memory
// a stage's operand and the output stage take, in elements), fetch (its
// operand of the tile ahead, into registers), store (those registers into
// the stage, when the tile is issued) and finish (the tile's outputs from
// the stage, stored in 16-byte pieces).

template <typename T, int R, int NC>
struct RowsCombine {
  static constexpr int Q = kRowsSlots / R;   // queries a tile
  T wv[NC];

  __host__ __device__ static constexpr int stage_elems(int) {
    return kRowsSlots * NC;
  }
  __host__ __device__ static constexpr int out_elems(int nf) { return Q * nf; }

  // the weights of slot t of the tile ahead, element k of idx
  __device__ __forceinline__ void fetch(const T* __restrict__ w, long long,
                                        long long k, bool live, long long,
                                        int, int) {
    if (live) {
#pragma unroll
      for (int c = 0; c < NC; ++c) wv[c] = __ldg(w + k * NC + c);
    }
  }

  __device__ __forceinline__ void store(T* sx, int t, bool live) const {
    if (live) {
#pragma unroll
      for (int c = 0; c < NC; ++c) sx[t * NC + c] = wv[c];
    }
  }

  // one thread per (query, field) of the tile, rows r-major then corners
  // c; outputs through shared memory in 16-byte stores
  __device__ __forceinline__ void finish(long long tile, long long n, int nf,
                                         int t, const T* rows,
                                         const int* slot, const T* ws,
                                         T* s_out, T* __restrict__ out) const {
    using V = typename Vec16<T>::type;
    constexpr int VEC = 16 / sizeof(T);
    const int rowlen = NC * nf;
    const long long q0 = tile * Q;
    const long long left = n - q0;
    const int nq = left < Q ? static_cast<int>(left) : Q;
    const int total = nq * nf;
    for (int e = t; e < total; e += kRowsSlots) {
      const int q = e / nf;
      const int f = e - q * nf;
      T acc = T(0);
      bool bad = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int u = slot[q * R + r];
        if (u < 0) {
          bad = true;
        } else {
          const T* rr = rows + u * rowlen + f;
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc += ws[(q * R + r) * NC + c] * rr[c * nf];
        }
      }
      s_out[e] = bad ? quiet_nan<T>() : acc;
    }
    __syncthreads();
    T* o = out + q0 * nf;
    const int nvec = total / VEC;
    for (int k = t; k < nvec; k += kRowsSlots)
      reinterpret_cast<V*>(o)[k] = *reinterpret_cast<const V*>(s_out + k * VEC);
    for (int k = nvec * VEC + t; k < total; k += kRowsSlots) o[k] = s_out[k];
  }
};

template <typename T, int R, int NC>
struct RowsWeightGrad {
  using V = typename Vec16<T>::type;
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int Q = kRowsSlots / R;   // queries a tile
  // 16-byte pieces of the tile's g (Q nf values, one run) a thread fetches,
  // at the widest row the pipeline takes
  static constexpr int GV =
      (Q * (kRowsMaxRowBytes / (NC * static_cast<int>(sizeof(T)))) / VEC +
       kRowsSlots - 1) / kRowsSlots;
  V gv[GV];
  T gt;       // an element of a ragged last tile's tail
  int total;  // values of g in the tile ahead

  __host__ __device__ static constexpr int stage_elems(int nf) {
    return Q * nf;
  }
  __host__ __device__ static constexpr int out_elems(int) {
    return kRowsSlots * NC;
  }

  // the tile's run of g, pieces t, t + kRowsSlots, ... as coalesced 16-byte
  // loads
  __device__ __forceinline__ void fetch(const T* __restrict__ g,
                                        long long tile, long long, bool,
                                        long long n, int nf, int t) {
    const long long q0 = tile * Q;
    const long long left = n - q0;
    total = (left < Q ? static_cast<int>(left) : Q) * nf;
    const T* gp = g + q0 * nf;
    const int nvec = total / VEC;
#pragma unroll
    for (int i = 0; i < GV; ++i) {
      const int k = t + i * kRowsSlots;
      if (k < nvec) gv[i] = __ldg(reinterpret_cast<const V*>(gp) + k);
    }
    const int k = nvec * VEC + t;
    if (k < total) gt = __ldg(gp + k);
  }

  __device__ __forceinline__ void store(T* sx, int t, bool) const {
    const int nvec = total / VEC;
#pragma unroll
    for (int i = 0; i < GV; ++i) {
      const int k = t + i * kRowsSlots;
      if (k < nvec) reinterpret_cast<V*>(sx)[k] = gv[i];
    }
    const int k = nvec * VEC + t;
    if (k < total) sx[k] = gt;
  }

  // one thread per (slot, corner): dw[q, r, c] = sum_f g[q, f] row[c nf +
  // f], fields in the order f = 0..nf-1; the tile's dw, Q R NC values of
  // one run, through shared memory in 16-byte stores
  __device__ __forceinline__ void finish(long long tile, long long n, int nf,
                                         int t, const T* rows,
                                         const int* slot, const T* gs,
                                         T* s_out, T* __restrict__ out) const {
    const int rowlen = NC * nf;
    const long long q0 = tile * Q;
    const long long left = n - q0;
    const int nq = left < Q ? static_cast<int>(left) : Q;
    const int total = nq * R * NC;
    for (int e = t; e < total; e += kRowsSlots) {
      const int u = e / NC;   // the slot, query u / R, row u % R
      const int c = e - u * NC;
      const int q = u / R;
      bool bad = false;
#pragma unroll
      for (int r = 0; r < R; ++r) bad |= slot[q * R + r] < 0;
      T acc = T(0);
      if (!bad) {
        const T* rr = rows + slot[u] * rowlen + c * nf;
        const T* gq = gs + q * nf;
        for (int f = 0; f < nf; ++f) acc += gq[f] * rr[f];
      }
      s_out[e] = bad ? quiet_nan<T>() : acc;
    }
    __syncthreads();
    using V = typename Vec16<T>::type;
    T* o = out + q0 * R * NC;
    const int nvec = total / VEC;
    for (int k = t; k < nvec; k += kRowsSlots)
      reinterpret_cast<V*>(o)[k] = *reinterpret_cast<const V*>(s_out + k * VEC);
    for (int k = nvec * VEC + t; k < total; k += kRowsSlots) o[k] = s_out[k];
  }
};

// dynamic shared memory of the pipeline: the two stages' rows and
// operands, then the output stage
template <typename T, int R, int NC, class Epi>
size_t rows_tiled_smem(int nf) {
  return (static_cast<size_t>(kRowsStages) *
              (static_cast<size_t>(kRowsSlots) * NC * nf +
               Epi::stage_elems(nf)) +
          Epi::out_elems(nf)) * sizeof(T);
}

// A persistent grid; slot t of tile k is (query k Q + t / R, row t % R),
// element k kRowsSlots + t of idx; lanes of a warp with one row share a
// copy
template <typename T, int R, int NC, class Epi>
__device__ __forceinline__ void rows_pipeline(const T* __restrict__ table,
                                              const int32_t* __restrict__ idx,
                                              const T* __restrict__ x,
                                              T* __restrict__ out,
                                              int* __restrict__ err,
                                              long long n, long long ns,
                                              int nf) {
  constexpr int Q = kRowsSlots / R;
  static_assert(Q * R == kRowsSlots, "R divides the tile");

  __shared__ uint64_t s_bar[kRowsStages];
  __shared__ int s_slot[kRowsStages][kRowsSlots];  // where a slot's row is, -1 bad
  extern __shared__ __align__(128) unsigned char s_dyn[];

  const int rowlen = NC * nf;
  const unsigned rowbytes = static_cast<unsigned>(rowlen * sizeof(T));
  const int xlen = Epi::stage_elems(nf);
  T* s_rows = reinterpret_cast<T*>(s_dyn);               // [stage][slot][row]
  T* s_x = s_rows + kRowsStages * kRowsSlots * rowlen;    // [stage][operand]
  T* s_out = s_x + kRowsStages * xlen;                    // the output stage

  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < kRowsStages; ++s) mbar_init(&s_bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long ntiles = (n + Q - 1) / Q;

  // this thread's slot of the tile ahead and the epilogue's operand, read
  // from global memory one tile before it is issued
  bool live = false;
  int row = 0;
  Epi epi;
  auto fetch = [&](long long tile) {
    const long long k = tile * kRowsSlots + t;
    live = k < n * R;
    if (live) row = __ldg(idx + k);
    epi.fetch(x, tile, k, live, n, nf, t);
  };

  // stage s takes the fetched tile: the operand to shared memory, the
  // slot's row copied to the slot's own place in the stage unless another
  // slot of the warp with that row copies it, the stage's barrier
  // armed with the bytes of the copies
  auto issue = [&](int s) {
    const bool valid = live && row >= 0 && row < ns;
    if (live && !valid) atomicExch(err, 1);
    epi.store(s_x + s * xlen, t, live);
    // lanes naming the same row share the copy of the lowest of them
    const unsigned peers = __match_any_sync(0xffffffffu, valid ? row : -1);
    const int lead = __ffs(peers) - 1;
    const int lane = t & 31;
    const bool copy = valid && lead == lane;
    const int slot = valid ? t - lane + lead : -1;   // where its row lands
    // the stage's last reads were generic loads; order them before the
    // bulk copies that overwrite it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (copy)
      bulk_copy_row(s_rows + (static_cast<size_t>(s) * kRowsSlots + t) * rowlen,
                    table + static_cast<long long>(row) * rowlen, rowbytes,
                    &s_bar[s]);
    s_slot[s][t] = slot;
    const int copies = __syncthreads_count(copy);
    if (t == 0) mbar_arrive_expect_tx(&s_bar[s], copies * rowbytes);
  };

  // kRowsStages - 1 tiles in flight ahead of the one being finished
  const long long step = gridDim.x;
  long long tile = blockIdx.x;
  if (tile >= ntiles) return;
  fetch(tile);
  for (int j = 0; j < kRowsStages - 1; ++j) {
    const long long tj = tile + j * step;
    if (tj < ntiles) {
      issue(j);
      if (tj + step < ntiles) fetch(tj + step);
    }
  }
  for (int it = 0; tile < ntiles; ++it, tile += step) {
    const int s = it % kRowsStages;
    const long long ahead = tile + (kRowsStages - 1) * step;
    if (ahead < ntiles) {
      issue((it + kRowsStages - 1) % kRowsStages);
      if (ahead + step < ntiles) fetch(ahead + step);
    }
    mbar_wait(&s_bar[s], (it / kRowsStages) & 1);
    epi.finish(tile, n, nf, t,
               s_rows + static_cast<size_t>(s) * kRowsSlots * rowlen,
               s_slot[s], s_x + s * xlen, s_out, out);
    __syncthreads();   // stage s and the output stage are free again
  }
}

template <typename T, int R, int NC>
__global__ void __launch_bounds__(kRowsSlots)
quad_gather_rows_tiled(const T* __restrict__ table,
                       const int32_t* __restrict__ idx,
                       const T* __restrict__ w, T* __restrict__ out,
                       int* __restrict__ err, long long n, long long ns,
                       int nf) {
  rows_pipeline<T, R, NC, RowsCombine<T, R, NC>>(table, idx, w, out, err, n,
                                                 ns, nf);
}

template <typename T, int R, int NC>
__global__ void __launch_bounds__(kRowsSlots)
quad_gather_rows_bwd_w_tiled(const T* __restrict__ table,
                             const int32_t* __restrict__ idx,
                             const T* __restrict__ g, T* __restrict__ dw,
                             int* __restrict__ err, long long n, long long ns,
                             int nf) {
  rows_pipeline<T, R, NC, RowsWeightGrad<T, R, NC>>(table, idx, g, dw, err,
                                                    n, ns, nf);
}

template <typename T, int R_, int NC_>
void launch_rows_simple(const T* table, const int32_t* idx, const T* w,
                        T* out, int* err, long long n, long long ns, int r,
                        int nc, int nf, cudaStream_t stream) {
  constexpr int per_block = kRowsThreads / kRowsGroup;
  const long long blocks = (n + per_block - 1) / per_block;
  quad_gather_rows_simple<T, R_, NC_>
      <<<static_cast<unsigned int>(blocks), kRowsThreads, 0, stream>>>(
          table, idx, w, out, err, n, ns, r, nc, nf);
}

constexpr int kRowsMaxDevices = 64;

// the grid of a persistent kernel: blocks resident on the whole card at
// this row size, worked out on the first launch of each kernel, device and
// row size (the set-up calls cost more than a small launch); 0 and the CUDA
// error on failure
template <typename T, int R, int NC, class Epi, typename Kernel>
long long rows_tiled_resident(Kernel kernel, int nf, int* rc) {
  constexpr int kSizes = kRowsMaxRowBytes / 16 + 1;
  static long long resident[kRowsMaxDevices][kSizes];   // 0: not yet known
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= kRowsMaxDevices) {
    *rc = static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidDevice);
    return 0;
  }
  const int size = static_cast<int>(NC * nf * sizeof(T) / 16);
  long long& cached = resident[dev][size];
  if (cached > 0) return cached;
  // the attribute admits the largest row, so every row size may launch
  const size_t smem_max = rows_tiled_smem<T, R, NC, Epi>(
      static_cast<int>(kRowsMaxRowBytes / (NC * sizeof(T))));
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_max));
  int per_sm = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kRowsSlots, rows_tiled_smem<T, R, NC, Epi>(nf));
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    *rc = static_cast<int>(e);
    return 0;
  }
  cached = static_cast<long long>(per_sm) * sms;
  return cached;
}

template <typename T, int R, int NC, class Epi, typename Kernel>
int launch_rows_tiled(Kernel kernel, const T* table, const int32_t* idx,
                      const T* x, T* out, int* err, long long n, long long ns,
                      int nf, cudaStream_t stream) {
  const size_t smem = rows_tiled_smem<T, R, NC, Epi>(nf);
  int rc = 0;
  const long long resident =
      rows_tiled_resident<T, R, NC, Epi>(kernel, nf, &rc);
  if (resident == 0) return rc;
  constexpr int Q = kRowsSlots / R;
  const long long ntiles = (n + Q - 1) / Q;
  const long long blocks = ntiles < resident ? ntiles : resident;
  kernel<<<static_cast<unsigned int>(blocks), kRowsSlots, smem, stream>>>(
      table, idx, x, out, err, n, ns, nf);
  return static_cast<int>(cudaGetLastError());
}

// the forward, or (bwd) the weights' backward
template <typename T, int R, int NC>
int launch_rows_tiled_as(const T* table, const int32_t* idx, const T* x,
                         T* out, int* err, long long n, long long ns, int nf,
                         bool bwd, cudaStream_t stream) {
  if (bwd)
    return launch_rows_tiled<T, R, NC, RowsWeightGrad<T, R, NC>>(
        quad_gather_rows_bwd_w_tiled<T, R, NC>, table, idx, x, out, err, n,
        ns, nf, stream);
  return launch_rows_tiled<T, R, NC, RowsCombine<T, R, NC>>(
      quad_gather_rows_tiled<T, R, NC>, table, idx, x, out, err, n, ns, nf,
      stream);
}

// the bulk-copy kernels' shapes and alignment: rows of whole 16-byte pieces
// of at most kRowsMaxRowBytes, table and the operands read or written in
// 16-byte pieces on 16 bytes (out always; x for the backward)
template <typename T>
int launch_rows_tiled_shape(const T* table, const int32_t* idx, const T* x,
                            T* out, int* err, long long n, long long ns,
                            int r, int nc, int nf, bool bwd,
                            cudaStream_t stream) {
  const long long rowbytes = static_cast<long long>(nc) * nf * sizeof(T);
  if (rowbytes % 16 != 0 || rowbytes > kRowsMaxRowBytes ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (bwd && reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (r == 4 && nc == 2)
    return launch_rows_tiled_as<T, 4, 2>(table, idx, x, out, err, n, ns, nf,
                                         bwd, stream);
  if (r == 8 && nc == 2)
    return launch_rows_tiled_as<T, 8, 2>(table, idx, x, out, err, n, ns, nf,
                                         bwd, stream);
  if (r == 1 && nc == 1)
    return launch_rows_tiled_as<T, 1, 1>(table, idx, x, out, err, n, ns, nf,
                                         bwd, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_rows(const T* table, const int32_t* idx, const T* w, T* out,
                int* err, long long n, long long ns, int r, int nc, int nf,
                int variant, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (variant == 0)
    return launch_rows_tiled_shape<T>(table, idx, w, out, err, n, ns, r, nc,
                                      nf, false, stream);
  if (n > 0) {
    if (r == 4 && nc == 2) {
      launch_rows_simple<T, 4, 2>(table, idx, w, out, err, n, ns, r, nc, nf,
                                  stream);
    } else if (r == 8 && nc == 2) {
      launch_rows_simple<T, 8, 2>(table, idx, w, out, err, n, ns, r, nc, nf,
                                  stream);
    } else if (r == 8 && nc == 1) {
      launch_rows_simple<T, 8, 1>(table, idx, w, out, err, n, ns, r, nc, nf,
                                  stream);
    } else if (r == 4 && nc == 1) {
      launch_rows_simple<T, 4, 1>(table, idx, w, out, err, n, ns, r, nc, nf,
                                  stream);
    } else if (r == 1 && nc == 1) {
      launch_rows_simple<T, 1, 1>(table, idx, w, out, err, n, ns, r, nc, nf,
                                  stream);
    } else {
      launch_rows_simple<T, 0, 0>(table, idx, w, out, err, n, ns, r, nc, nf,
                                  stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// the forward tiled kernel, or (bwd) the weights' backward on its pipeline
template <typename T, int NC, int NF>
void launch_tiled(const T* table, const int32_t* idx, const T* x, T* out,
                  int* err, long long n, long long ns, bool bwd,
                  cudaStream_t stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((n + kTile - 1) / kTile);
  if (bwd)
    quad_gather_bwd_w_tiled<T, NC, NF><<<blocks, kTile, 0, stream>>>(
        table, idx, x, out, err, n, ns);
  else
    quad_gather_tiled<T, NC, NF><<<blocks, kTile, 0, stream>>>(
        table, idx, x, out, err, n, ns);
}

// the shapes the tiled kernels are built for: FFJET (4, 9), the POLSYNCHPL
// cutoff table (2, 6) and its per-sample-p form (4, 6), HARM (4, 10),
// KORAL (4, 11), SPHACC (2, 2), NUMDISK (4, 1)
template <typename T>
bool launch_tiled_shape(const T* table, const int32_t* idx, const T* x,
                        T* out, int* err, long long n, long long ns, int nc,
                        int nf, bool bwd, cudaStream_t stream) {
#define QG_TILED(NC_, NF_)                                                  \
  if (nc == NC_ && nf == NF_) {                                             \
    if (n > 0)                                                              \
      launch_tiled<T, NC_, NF_>(table, idx, x, out, err, n, ns, bwd,       \
                                stream);                                    \
    return true;                                                            \
  }
  QG_TILED(4, 9)
  QG_TILED(2, 6)
  QG_TILED(4, 6)
  QG_TILED(4, 10)
  QG_TILED(4, 11)
  QG_TILED(2, 2)
  QG_TILED(4, 1)
#undef QG_TILED
  return false;
}

template <typename T>
int launch(const T* table, const int32_t* idx, const T* w, T* out, int* err,
           long long n, int ns, int nc, int nf, int variant, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (variant == 0) {
    if (!launch_tiled_shape<T>(table, idx, w, out, err, n, ns, nc, nf, false,
                               stream))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 2 && nc > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    if (variant == 2) {
      constexpr long long per_block = kWideWarps * kWideQueries;
      const long long blocks = (n + per_block - 1) / per_block;
      quad_gather_wide<T>
          <<<static_cast<unsigned int>(blocks), kWideWarps * 32, 0, stream>>>(
              table, idx, w, out, err, n, ns, nc, nf);
    } else {
      constexpr int kThreads = 256;
      const long long total = n * nf;
      const long long blocks = (total + kThreads - 1) / kThreads;
      quad_gather_generic<T>
          <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
              table, idx, w, out, err, n, ns, nc, nf);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- the backward with respect to the weights ----
//
//   dw[n, r, c] = sum_f g[n, f] * table[idx[n, r], c * nf + f]
//
// g is the gradient of the output.  R = 1 is quad_gather's backward
// (quad_gather_bwd_w), R >= 1 quad_gather_rows's (quad_gather_rows_bwd_w).
// The table takes no gradient (no path differentiates loaded data), so
// there is no scatter and no atomic: every dw element is written once, by
// one thread, which sums over the fields in the order f = 0..nf-1, so a run
// repeats bitwise, and every kernel below sums in that one order.  Bound:
// the bytes, as the forward's (index, g and dw once, each distinct row
// once).  A row outside [0, ns) sets *err and writes NaN into every dw of
// its query.  Kernels:
//  * quad_gather_bwd_w_tiled<T, NC, NF> (R = 1, the tiled forward's shapes,
//    16-byte aligned operands): the forward's tile pipeline with the
//    weight-gradient epilogue.  A block takes 128 queries; each thread reads
//    its index and its query's g once, in 16-byte loads: its own row of g
//    where that is whole 16-byte pieces, else the tile's g (one run of
//    128 NF values) in coalesced loads, passed through shared memory while
//    the rows' 16-byte pieces are in flight; each thread forms its NC dot
//    products with NF unrolled; dw leaves through shared memory in 16-byte
//    stores.
//  * quad_gather_rows_bwd_w_tiled<T, R, NC> ((R, NC) and rows as the tiled
//    rows forward takes them, table and g 16-byte aligned): the forward's
//    bulk-copy pipeline (persistent grid, indices a tile ahead, rows by
//    cp.async.bulk into a two-stage mbarrier ring, warp dedup) with the
//    weight-gradient epilogue: the tile's Q nf values of g (one run) are
//    fetched a tile ahead in coalesced 16-byte loads and staged in the
//    ring beside the rows; one thread per (slot, corner) forms its dot from
//    shared memory; the tile's dw, Q R NC values of one run, leaves in
//    16-byte stores.
//  * quad_gather_bwd_w_generic / quad_gather_rows_bwd_w_simple (the first
//    design; any run-time (R, nc, nf) and alignment): a thread a weight,
//    its query's R * nc threads neighbours; the thread's index is divided
//    in 32 bits where the weight count fits.

constexpr int kBwdThreads = 256;   // threads a block

// I: the integer type of the thread index, 32 bits where the count fits
template <typename T, typename I>
__device__ __forceinline__ void bwd_w_element(const T* __restrict__ table,
                                              const int32_t* __restrict__ idx,
                                              const T* __restrict__ g,
                                              T* __restrict__ dw,
                                              int* __restrict__ err,
                                              long long n, long long ns,
                                              int r, int nc, int nf) {
  const I t = static_cast<I>(blockIdx.x) * kBwdThreads + threadIdx.x;
  const I per = static_cast<I>(r) * nc;
  if (t >= static_cast<I>(n) * per) return;
  const I q = t / per;
  const int k = static_cast<int>(t - q * per);
  const int rr = k / nc;
  const int c = k - rr * nc;
  const int32_t* iq = idx + static_cast<long long>(q) * r;
  bool bad = false;
  for (int j = 0; j < r; ++j) {
    const long long row = __ldg(iq + j);
    bad |= row < 0 || row >= ns;
  }
  if (bad) {
    if (k == 0) atomicExch(err, 1);
    dw[t] = quiet_nan<T>();
    return;
  }
  const T* trow = table + static_cast<long long>(__ldg(iq + rr)) * nc * nf
                  + static_cast<long long>(c) * nf;
  const T* gq = g + static_cast<long long>(q) * nf;
  T acc = T(0);
  for (int f = 0; f < nf; ++f) acc += __ldg(gq + f) * __ldg(trow + f);
  dw[t] = acc;
}

template <typename T, typename I>
__global__ void __launch_bounds__(kBwdThreads)
quad_gather_bwd_w_generic(const T* __restrict__ table,
                          const int32_t* __restrict__ idx,
                          const T* __restrict__ g, T* __restrict__ dw,
                          int* __restrict__ err, long long n, long long ns,
                          int nc, int nf) {
  bwd_w_element<T, I>(table, idx, g, dw, err, n, ns, 1, nc, nf);
}

template <typename T, typename I>
__global__ void __launch_bounds__(kBwdThreads)
quad_gather_rows_bwd_w_simple(const T* __restrict__ table,
                              const int32_t* __restrict__ idx,
                              const T* __restrict__ g, T* __restrict__ dw,
                              int* __restrict__ err, long long n,
                              long long ns, int r, int nc, int nf) {
  bwd_w_element<T, I>(table, idx, g, dw, err, n, ns, r, nc, nf);
}

template <typename T, typename I>
void launch_bwd_w_element(const T* table, const int32_t* idx, const T* g,
                          T* dw, int* err, long long n, long long ns, int r,
                          int nc, int nf, bool rows, cudaStream_t stream) {
  const long long total = n * r * nc;
  const unsigned int blocks =
      static_cast<unsigned int>((total + kBwdThreads - 1) / kBwdThreads);
  if (rows)
    quad_gather_rows_bwd_w_simple<T, I><<<blocks, kBwdThreads, 0, stream>>>(
        table, idx, g, dw, err, n, ns, r, nc, nf);
  else
    quad_gather_bwd_w_generic<T, I><<<blocks, kBwdThreads, 0, stream>>>(
        table, idx, g, dw, err, n, ns, nc, nf);
}

// variant 0: the tiled kernel (the shape must be one it is built for, the
// operands 16-byte aligned); 1: generic (R = 1) or simple (rows)
template <typename T>
int launch_bwd_w(const T* table, const int32_t* idx, const T* g, T* dw,
                 int* err, long long n, long long ns, int r, int nc, int nf,
                 bool rows, int variant, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (r < 1 || nc < 1 || nf < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 0) {
    if (rows)
      return launch_rows_tiled_shape<T>(table, idx, g, dw, err, n, ns, r, nc,
                                        nf, true, stream);
    if (reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(dw) % 16 != 0 ||
        !launch_tiled_shape<T>(table, idx, g, dw, err, n, ns, nc, nf, true,
                               stream))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
  }
  if (n > 0) {
    // 32-bit indices where every thread's index fits
    if (n * r * nc + kBwdThreads <= 0x7fffffffLL)
      launch_bwd_w_element<T, unsigned>(table, idx, g, dw, err, n, ns, r, nc,
                                        nf, rows, stream);
    else
      launch_bwd_w_element<T, long long>(table, idx, g, dw, err, n, ns, r, nc,
                                         nf, rows, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int quad_gather_bwd_w_f32(const float* table, const int32_t* idx,
                                     const float* g, float* dw, int* err,
                                     long long n, long long ns, int nc,
                                     int nf, int variant, void* stream) {
  return launch_bwd_w<float>(table, idx, g, dw, err, n, ns, 1, nc, nf, false,
                             variant, stream);
}

extern "C" int quad_gather_bwd_w_f64(const double* table, const int32_t* idx,
                                     const double* g, double* dw, int* err,
                                     long long n, long long ns, int nc,
                                     int nf, int variant, void* stream) {
  return launch_bwd_w<double>(table, idx, g, dw, err, n, ns, 1, nc, nf, false,
                              variant, stream);
}

extern "C" int quad_gather_rows_bwd_w_f32(const float* table,
                                          const int32_t* idx, const float* g,
                                          float* dw, int* err, long long n,
                                          long long ns, int r, int nc, int nf,
                                          int variant, void* stream) {
  return launch_bwd_w<float>(table, idx, g, dw, err, n, ns, r, nc, nf, true,
                             variant, stream);
}

extern "C" int quad_gather_rows_bwd_w_f64(const double* table,
                                          const int32_t* idx, const double* g,
                                          double* dw, int* err, long long n,
                                          long long ns, int r, int nc, int nf,
                                          int variant, void* stream) {
  return launch_bwd_w<double>(table, idx, g, dw, err, n, ns, r, nc, nf, true,
                              variant, stream);
}

extern "C" int quad_gather_f32(const float* table, const int32_t* idx,
                               const float* w, float* out, int* err,
                               long long n, int ns, int nc, int nf,
                               int variant, void* stream) {
  return launch<float>(table, idx, w, out, err, n, ns, nc, nf, variant,
                       stream);
}

extern "C" int quad_gather_f64(const double* table, const int32_t* idx,
                               const double* w, double* out, int* err,
                               long long n, int ns, int nc, int nf,
                               int variant, void* stream) {
  return launch<double>(table, idx, w, out, err, n, ns, nc, nf, variant,
                        stream);
}

extern "C" int quad_gather_rows_f32(const float* table, const int32_t* idx,
                                    const float* w, float* out, int* err,
                                    long long n, long long ns, int r, int nc,
                                    int nf, int variant, void* stream) {
  return launch_rows<float>(table, idx, w, out, err, n, ns, r, nc, nf,
                            variant, stream);
}

extern "C" int quad_gather_rows_f64(const double* table, const int32_t* idx,
                                    const double* w, double* out, int* err,
                                    long long n, long long ns, int r, int nc,
                                    int nf, int variant, void* stream) {
  return launch_rows<double>(table, idx, w, out, err, n, ns, r, nc, nf,
                             variant, stream);
}
