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
//    stores on consecutive addresses.  No run-time divide.
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
//  * quad_gather_rows_tiled<T, R, NC, DEDUP>, for (R, NC) in (4, 2),
//    (8, 2), (1, 1) and rows that are whole 16-byte pieces of at most
//    kRowsMaxRowBytes.  A persistent grid; a block of 128
//    threads takes tiles of 128 / R consecutive queries, one (query, row)
//    slot a thread.  Each thread reads its slot's index and weights one
//    tile ahead (coalesced), so their latency hides behind the tile being
//    combined.  Each row a slot names is copied from global to shared
//    memory by one Hopper bulk copy (cp.async.bulk, no tensor map),
//    completion counted on the stage's mbarrier, armed with the tile's
//    bytes; two stages, so the next tile's copies are in flight while this
//    one is combined.  DEDUP (what the port runs): lanes of a warp that
//    name one row (neighbouring points of a ray share cells; a frame names
//    each row ~8 times) share the copy of the lowest of them
//    (__match_any_sync); without it every slot copies its own row, kept to
//    be timed against it.  The combine is one thread per (query, field)
//    from shared memory, rows r-major then corners c, as the plain version
//    sums; the outputs leave through shared memory in 16-byte stores.  The
//    launch set-up (shared-memory attribute, resident blocks) is worked out
//    once per instantiation, device and row size.  Measured (PERF.md): the
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
// C interface (ctypes): quad_gather_f32 / quad_gather_f64 launch on the
// given stream and return cudaGetLastError().  `variant` names the
// kernel: 0 tiled (the shape must be one it is built for), 1 generic, 2
// wide.  quad_gather_rows_f32 / _f64 launch the multi-row gather the same
// way: `variant` 0 tiled (`dedup` 0 every slot copies its row, 1 a warp's
// lanes share a row's copy), 1 simple.  quad_gather_bwd_w_f32 / _f64 and
// quad_gather_rows_bwd_w_f32 / _f64 launch the backward with respect to
// the weights (the end of this file).

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

template <typename T, int NC, int NF>
__global__ void __launch_bounds__(kTile)
quad_gather_tiled(const T* __restrict__ table,
                  const int32_t* __restrict__ idx,
                  const T* __restrict__ w, T* __restrict__ out,
                  int* __restrict__ err, long long n, int ns) {
  using V = typename Vec16<T>::type;
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte piece
  constexpr int ROW = NC * NF;          // elements per table row
  static_assert(ROW % VEC == 0, "rows must be whole 16-byte pieces");
  constexpr int RV = ROW / VEC;         // pieces per row, and per thread
  constexpr int STRIDE = ROW | 1;       // odd: no bank conflict on reads
  static_assert(kTile * NF <= kTile * STRIDE, "output stage fits");
  static_assert(kTile * STRIDE * sizeof(T) + kTile * 4 <= 48 * 1024,
                "static shared stage fits");

  __shared__ int s_row[kTile];
  __shared__ __align__(16) T s_buf[kTile * STRIDE];

  const int t = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long left = n - q0;
  const int nq = left < kTile ? static_cast<int>(left) : kTile;

  // 1. this thread's query: index and weights, read once
  int row = -1;
  bool bad = false;
  T wq[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) wq[c] = T(0);
  if (t < nq) {
    row = __ldg(idx + q0 + t);
    if (row < 0 || row >= ns) {
      bad = true;
      row = -1;
      atomicExch(err, 1);
    }
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

  // 3. combine this thread's query, corners in the order c = 0..NC-1
  T acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    T a = T(0);
#pragma unroll
    for (int c = 0; c < NC; ++c) a += wq[c] * s_buf[t * STRIDE + c * NF + f];
    acc[f] = bad ? quiet_nan<T>() : a;
  }
  __syncthreads();

  // 4. outputs through shared memory, then 16-byte stores in order
#pragma unroll
  for (int f = 0; f < NF; ++f) s_buf[t * NF + f] = acc[f];
  __syncthreads();
  const int total = nq * NF;
  T* o = out + q0 * NF;
  const int nvec = total / VEC;
  for (int k = t; k < nvec; k += kTile)
    reinterpret_cast<V*>(o)[k] = *reinterpret_cast<const V*>(s_buf + k * VEC);
  for (int k = nvec * VEC + t; k < total; k += kTile) o[k] = s_buf[k];
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

// ---- the tiled multi-row kernel: bulk copies into a two-stage ring ----

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
      printf("quad_gather_rows_tiled: block %d thread %d: barrier phase of "
             "parity %u did not end\n", blockIdx.x, threadIdx.x, parity);
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

template <typename T, int R, int NC>
__host__ __device__ constexpr int rows_tile_queries() {
  return kRowsSlots / R;
}

// dynamic shared memory of quad_gather_rows_tiled: the two stages' rows and
// weights, then the output stage
template <typename T, int R, int NC>
size_t rows_tiled_smem(int nf) {
  return static_cast<size_t>(kRowsStages) * kRowsSlots *
             (static_cast<size_t>(NC) * nf + NC) * sizeof(T) +
         static_cast<size_t>(rows_tile_queries<T, R, NC>()) * nf * sizeof(T);
}

// DEDUP: lanes of a warp with one row share a copy; else every slot
// copies its row
template <typename T, int R, int NC, bool DEDUP>
__global__ void __launch_bounds__(kRowsSlots)
quad_gather_rows_tiled(const T* __restrict__ table,
                       const int32_t* __restrict__ idx,
                       const T* __restrict__ w, T* __restrict__ out,
                       int* __restrict__ err, long long n, long long ns,
                       int nf) {
  using V = typename Vec16<T>::type;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int Q = rows_tile_queries<T, R, NC>();
  static_assert(Q * R == kRowsSlots, "R divides the tile");

  __shared__ uint64_t s_bar[kRowsStages];
  __shared__ int s_slot[kRowsStages][kRowsSlots];  // where a slot's row is, -1 bad
  extern __shared__ __align__(128) unsigned char s_dyn[];

  const int rowlen = NC * nf;
  const unsigned rowbytes = static_cast<unsigned>(rowlen * sizeof(T));
  T* s_rows = reinterpret_cast<T*>(s_dyn);               // [stage][slot][row]
  T* s_w = s_rows + kRowsStages * kRowsSlots * rowlen;    // [stage][slot][c]
  T* s_out = s_w + kRowsStages * kRowsSlots * NC;         // [query][f]

  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < kRowsStages; ++s) mbar_init(&s_bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long ntiles = (n + Q - 1) / Q;

  // this thread's slot of the tile ahead, read from global memory one
  // tile before it is issued; slot t of tile k is (query k Q + t / R, row
  // t % R), element k * kRowsSlots + t of idx
  bool live = false;
  int row = 0;
  T wv[NC];
  auto fetch = [&](long long tile) {
    const long long k = tile * kRowsSlots + t;
    live = k < n * R;
    if (live) {
      row = __ldg(idx + k);
#pragma unroll
      for (int c = 0; c < NC; ++c) wv[c] = __ldg(w + k * NC + c);
    }
  };

  // stage s takes the fetched tile: weights to shared memory, the slot's
  // row copied to the slot's own place in the stage unless another slot of
  // the warp with that row copies it (DEDUP), the stage's barrier armed
  // with the bytes of the copies
  auto issue = [&](int s) {
    const bool valid = live && row >= 0 && row < ns;
    if (live && !valid) atomicExch(err, 1);
    if (live) {
#pragma unroll
      for (int c = 0; c < NC; ++c) s_w[(s * kRowsSlots + t) * NC + c] = wv[c];
    }
    bool copy = valid;
    int slot = valid ? t : -1;   // where the slot's row lands
    if constexpr (DEDUP) {
      // lanes naming the same row share the copy of the lowest of them
      const unsigned peers = __match_any_sync(0xffffffffu, valid ? row : -1);
      const int lead = __ffs(peers) - 1;
      const int lane = t & 31;
      copy = valid && lead == lane;
      if (valid) slot = t - lane + lead;
    }
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

  // one thread per (query, field) of the tile in stage s, rows r-major
  // then corners c; outputs through shared memory in 16-byte stores
  auto combine = [&](long long tile, int s) {
    const long long q0 = tile * Q;
    const long long left = n - q0;
    const int nq = left < Q ? static_cast<int>(left) : Q;
    const int total = nq * nf;
    const T* rows = s_rows + static_cast<size_t>(s) * kRowsSlots * rowlen;
    const T* ws = s_w + s * kRowsSlots * NC;
    for (int e = t; e < total; e += kRowsSlots) {
      const int q = e / nf;
      const int f = e - q * nf;
      T acc = T(0);
      bool bad = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int u = s_slot[s][q * R + r];
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
    __syncthreads();   // stage s and the output stage are free again
  };

  // kRowsStages - 1 tiles in flight ahead of the one being combined
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
    combine(tile, s);
  }
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

// the grid of the persistent kernel: blocks resident on the whole card at
// this row size, worked out on the first launch of each instantiation,
// device and row size (the set-up calls cost more than a small launch);
// 0 and the CUDA error on failure
template <typename T, int R, int NC, bool DEDUP>
long long rows_tiled_resident(int nf, int* rc) {
  constexpr int kSizes = kRowsMaxRowBytes / 16 + 1;
  static long long resident[kRowsMaxDevices][kSizes];   // 0: not yet known
  auto kernel = quad_gather_rows_tiled<T, R, NC, DEDUP>;
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
  const size_t smem_max = rows_tiled_smem<T, R, NC>(
      static_cast<int>(kRowsMaxRowBytes / (NC * sizeof(T))));
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_max));
  int per_sm = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kRowsSlots, rows_tiled_smem<T, R, NC>(nf));
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

template <typename T, int R, int NC, bool DEDUP>
int launch_rows_tiled(const T* table, const int32_t* idx, const T* w, T* out,
                      int* err, long long n, long long ns, int nf,
                      cudaStream_t stream) {
  auto kernel = quad_gather_rows_tiled<T, R, NC, DEDUP>;
  const size_t smem = rows_tiled_smem<T, R, NC>(nf);
  int rc = 0;
  const long long resident = rows_tiled_resident<T, R, NC, DEDUP>(nf, &rc);
  if (resident == 0) return rc;
  constexpr int Q = rows_tile_queries<T, R, NC>();
  const long long ntiles = (n + Q - 1) / Q;
  const long long blocks = ntiles < resident ? ntiles : resident;
  kernel<<<static_cast<unsigned int>(blocks), kRowsSlots, smem, stream>>>(
      table, idx, w, out, err, n, ns, nf);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int R, int NC>
int launch_rows_tiled_as(const T* table, const int32_t* idx, const T* w,
                         T* out, int* err, long long n, long long ns, int nf,
                         int dedup, cudaStream_t stream) {
  if (dedup)
    return launch_rows_tiled<T, R, NC, true>(table, idx, w, out, err, n, ns,
                                             nf, stream);
  return launch_rows_tiled<T, R, NC, false>(table, idx, w, out, err, n, ns,
                                            nf, stream);
}

template <typename T>
int launch_rows(const T* table, const int32_t* idx, const T* w, T* out,
                int* err, long long n, long long ns, int r, int nc, int nf,
                int variant, int dedup, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (variant == 0) {
    const long long rowbytes = static_cast<long long>(nc) * nf * sizeof(T);
    if (rowbytes % 16 != 0 || rowbytes > kRowsMaxRowBytes ||
        reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return static_cast<int>(cudaGetLastError());
    if (r == 4 && nc == 2)
      return launch_rows_tiled_as<T, 4, 2>(table, idx, w, out, err, n, ns, nf,
                                           dedup, stream);
    if (r == 8 && nc == 2)
      return launch_rows_tiled_as<T, 8, 2>(table, idx, w, out, err, n, ns, nf,
                                           dedup, stream);
    if (r == 1 && nc == 1)
      return launch_rows_tiled_as<T, 1, 1>(table, idx, w, out, err, n, ns, nf,
                                           dedup, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
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

template <typename T, int NC, int NF>
void launch_tiled(const T* table, const int32_t* idx, const T* w, T* out,
                  int* err, long long n, int ns, cudaStream_t stream) {
  const long long blocks = (n + kTile - 1) / kTile;
  quad_gather_tiled<T, NC, NF>
      <<<static_cast<unsigned int>(blocks), kTile, 0, stream>>>(
          table, idx, w, out, err, n, ns);
}

// the shapes the tiled kernel is built for: FFJET (4, 9), the POLSYNCHPL
// cutoff table (2, 6) and its per-sample-p form (4, 6), HARM (4, 10),
// KORAL (4, 11), SPHACC (2, 2), NUMDISK (4, 1)
template <typename T>
bool launch_tiled_shape(const T* table, const int32_t* idx, const T* w,
                        T* out, int* err, long long n, int ns, int nc, int nf,
                        cudaStream_t stream) {
#define QG_TILED(NC_, NF_)                                                  \
  if (nc == NC_ && nf == NF_) {                                             \
    if (n > 0)                                                              \
      launch_tiled<T, NC_, NF_>(table, idx, w, out, err, n, ns, stream);    \
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
    if (!launch_tiled_shape<T>(table, idx, w, out, err, n, ns, nc, nf,
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
// one thread, which sums over the fields in order, so a run repeats
// bitwise.  A query's R * nc threads are neighbours: together they read
// its rows as the forward kernels do (thread (r, c) the nf consecutive
// values of corner c of row r), share the query's g through L1, and store
// the query's dw as one contiguous run.  Bound: the bytes, as the
// forward's (index, g and dw once, each distinct row once); the shape is a
// run-time argument, so every (R, nc, nf) the forward takes is taken.  A
// row outside [0, ns) sets *err and writes NaN into every dw of its query.

constexpr int kBwdThreads = 256;   // threads a block

template <typename T>
__device__ __forceinline__ void bwd_w_element(const T* __restrict__ table,
                                              const int32_t* __restrict__ idx,
                                              const T* __restrict__ g,
                                              T* __restrict__ dw,
                                              int* __restrict__ err,
                                              long long n, long long ns,
                                              int r, int nc, int nf) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x;
  const long long per = static_cast<long long>(r) * nc;
  if (t >= n * per) return;
  const long long q = t / per;
  const int k = static_cast<int>(t - q * per);
  const int rr = k / nc;
  const int c = k - rr * nc;
  const int32_t* iq = idx + q * r;
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
  const T* gq = g + q * nf;
  T acc = T(0);
  for (int f = 0; f < nf; ++f) acc += __ldg(gq + f) * __ldg(trow + f);
  dw[t] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
quad_gather_bwd_w(const T* __restrict__ table, const int32_t* __restrict__ idx,
                  const T* __restrict__ g, T* __restrict__ dw,
                  int* __restrict__ err, long long n, long long ns, int nc,
                  int nf) {
  bwd_w_element(table, idx, g, dw, err, n, ns, 1, nc, nf);
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
quad_gather_rows_bwd_w(const T* __restrict__ table,
                       const int32_t* __restrict__ idx,
                       const T* __restrict__ g, T* __restrict__ dw,
                       int* __restrict__ err, long long n, long long ns, int r,
                       int nc, int nf) {
  bwd_w_element(table, idx, g, dw, err, n, ns, r, nc, nf);
}

template <typename T>
int launch_bwd_w(const T* table, const int32_t* idx, const T* g, T* dw,
                 int* err, long long n, long long ns, int r, int nc, int nf,
                 bool rows, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (r < 1 || nc < 1 || nf < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const long long total = n * r * nc;
    const unsigned int blocks =
        static_cast<unsigned int>((total + kBwdThreads - 1) / kBwdThreads);
    if (rows)
      quad_gather_rows_bwd_w<T><<<blocks, kBwdThreads, 0, stream>>>(
          table, idx, g, dw, err, n, ns, r, nc, nf);
    else
      quad_gather_bwd_w<T><<<blocks, kBwdThreads, 0, stream>>>(
          table, idx, g, dw, err, n, ns, nc, nf);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int quad_gather_bwd_w_f32(const float* table, const int32_t* idx,
                                     const float* g, float* dw, int* err,
                                     long long n, long long ns, int nc,
                                     int nf, void* stream) {
  return launch_bwd_w<float>(table, idx, g, dw, err, n, ns, 1, nc, nf, false,
                             stream);
}

extern "C" int quad_gather_bwd_w_f64(const double* table, const int32_t* idx,
                                     const double* g, double* dw, int* err,
                                     long long n, long long ns, int nc,
                                     int nf, void* stream) {
  return launch_bwd_w<double>(table, idx, g, dw, err, n, ns, 1, nc, nf, false,
                              stream);
}

extern "C" int quad_gather_rows_bwd_w_f32(const float* table,
                                          const int32_t* idx, const float* g,
                                          float* dw, int* err, long long n,
                                          long long ns, int r, int nc, int nf,
                                          void* stream) {
  return launch_bwd_w<float>(table, idx, g, dw, err, n, ns, r, nc, nf, true,
                             stream);
}

extern "C" int quad_gather_rows_bwd_w_f64(const double* table,
                                          const int32_t* idx, const double* g,
                                          double* dw, int* err, long long n,
                                          long long ns, int r, int nc, int nf,
                                          void* stream) {
  return launch_bwd_w<double>(table, idx, g, dw, err, n, ns, r, nc, nf, true,
                              stream);
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
                                    int nf, int variant, int dedup,
                                    void* stream) {
  return launch_rows<float>(table, idx, w, out, err, n, ns, r, nc, nf,
                            variant, dedup, stream);
}

extern "C" int quad_gather_rows_f64(const double* table, const int32_t* idx,
                                    const double* w, double* out, int* err,
                                    long long n, long long ns, int r, int nc,
                                    int nf, int variant, int dedup,
                                    void* stream) {
  return launch_rows<double>(table, idx, w, out, err, n, ns, r, nc, nf,
                             variant, dedup, stream);
}
