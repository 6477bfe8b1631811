// Fused packed-row gather + corner combine for Hopper (sm_90a).
//
//   out[n, f] = sum_{c < nc} w[n, c] * table[idx[n], c * nf + f]
//
// Replaces the Pallas TPU kernel grtrans_tpu/ops/pallas_gather.py
// (vmem_row_gather, the pallas_call at :49) together with its XLA
// epilogue quad_combine (:64), in one pass.  Callers: FFJet.vals (4
// corners x 9 fields of the bilinear sampler) and polsynchpl._g_all
// (2 bracketing rows x 6 cutoff tables).
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
//  * quad_gather_tiled<T, NC, NF>, for the two shapes the renderer uses,
//    (NC, NF) = (4, 9) and (2, 6).  A block of 128 threads takes a tile of
//    128 queries.  Each thread reads its own query's index and weights
//    once (16-byte loads).  The block then fetches the 128 rows as one
//    stream of 16-byte pieces, neighbouring threads on neighbouring
//    pieces of a row, so a warp's load covers whole rows instead of 32
//    scattered sectors, and every thread has all its row pieces (18 for a
//    float64 FFJET row) in flight before the first is used.  The rows are
//    laid into shared memory at an odd stride, each thread combines its
//    own query from there (corners summed in the order c = 0..NC-1), and
//    the tile's outputs go back through shared memory so that they leave
//    in 16-byte stores on consecutive addresses.  No run-time divide.
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
//  * quad_gather_rows<T, R, NC>: what Grmhd3D._gather_cols
//    (grtrans_tpu/fluid/grmhd3d.py:212), thickdisk.py:269, koral.py:402 and
//    harmpi.py:520 leave to one fused XLA gather + weighted sum.  R rows of
//    a phi-pair-packed table (nc = 2) are the corners of a trilinear cell
//    (R = 4; R = 8 with the two time slices of slow light folded into the
//    weights), R rows of a plain table (nc = 1) the corners of a binned
//    population.  Sixteen lanes take a query: lane f < nf owns output
//    field f, so each of the R * nc loads of a query is nf consecutive
//    elements (80-112 bytes in float64) and the index and weight loads are
//    one address for the group, served as a broadcast.  All R * NC loads
//    are in flight before the first is used.  A snapshot table is hundreds of
//    MB, far beyond L2, so scattered rows come from device memory; the
//    element offset idx * (nc * nf) is formed in 64 bits.  R and NC are
//    template parameters for the renderer's shapes; <T, 0, 0> takes any
//    (R, nc) at run time.
//
// Ragged edges are masked here (no padding to a block multiple).  An
// index outside [0, ns) sets *err and writes NaN instead of reading out
// of bounds; the host reads the flag after a run.
//
// C interface (ctypes): quad_gather_f32 / quad_gather_f64 launch on the
// given stream and return cudaGetLastError().  `variant` names the
// kernel: 0 tiled (the shape must be one of the two it is built for), 1
// generic, 2 wide.  quad_gather_rows_f32 / _f64 launch the multi-row
// gather the same way.

#include <cstdint>
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
quad_gather_rows(const T* __restrict__ table, const int32_t* __restrict__ idx,
                 const T* __restrict__ w, T* __restrict__ out,
                 int* __restrict__ err, long long n, long long ns, int r_rt,
                 int nc_rt, int nf) {
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

template <typename T, int R_, int NC_>
void launch_rows_as(const T* table, const int32_t* idx, const T* w, T* out,
                    int* err, long long n, long long ns, int r, int nc, int nf,
                    cudaStream_t stream) {
  constexpr int per_block = kRowsThreads / kRowsGroup;
  const long long blocks = (n + per_block - 1) / per_block;
  quad_gather_rows<T, R_, NC_>
      <<<static_cast<unsigned int>(blocks), kRowsThreads, 0, stream>>>(
          table, idx, w, out, err, n, ns, r, nc, nf);
}

template <typename T>
int launch_rows(const T* table, const int32_t* idx, const T* w, T* out,
                int* err, long long n, long long ns, int r, int nc, int nf,
                void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (n > 0) {
    if (r == 4 && nc == 2) {
      launch_rows_as<T, 4, 2>(table, idx, w, out, err, n, ns, r, nc, nf, stream);
    } else if (r == 8 && nc == 2) {
      launch_rows_as<T, 8, 2>(table, idx, w, out, err, n, ns, r, nc, nf, stream);
    } else if (r == 8 && nc == 1) {
      launch_rows_as<T, 8, 1>(table, idx, w, out, err, n, ns, r, nc, nf, stream);
    } else if (r == 4 && nc == 1) {
      launch_rows_as<T, 4, 1>(table, idx, w, out, err, n, ns, r, nc, nf, stream);
    } else if (r == 1 && nc == 1) {
      launch_rows_as<T, 1, 1>(table, idx, w, out, err, n, ns, r, nc, nf, stream);
    } else {
      launch_rows_as<T, 0, 0>(table, idx, w, out, err, n, ns, r, nc, nf, stream);
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

template <typename T>
int launch(const T* table, const int32_t* idx, const T* w, T* out, int* err,
           long long n, int ns, int nc, int nf, int variant, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (variant == 0 && !((nc == 4 && nf == 9) || (nc == 2 && nf == 6)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 2 && nc > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    if (variant == 0 && nc == 4) {
      launch_tiled<T, 4, 9>(table, idx, w, out, err, n, ns, stream);
    } else if (variant == 0) {
      launch_tiled<T, 2, 6>(table, idx, w, out, err, n, ns, stream);
    } else if (variant == 2) {
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

}  // namespace

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
                                    int nf, void* stream) {
  return launch_rows<float>(table, idx, w, out, err, n, ns, r, nc, nf, stream);
}

extern "C" int quad_gather_rows_f64(const double* table, const int32_t* idx,
                                    const double* w, double* out, int* err,
                                    long long n, long long ns, int r, int nc,
                                    int nf, void* stream) {
  return launch_rows<double>(table, idx, w, out, err, n, ns, r, nc, nf,
                             stream);
}
