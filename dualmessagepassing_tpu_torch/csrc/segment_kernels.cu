// Segment kernels of the UNC DMPNN layer for Hopper (sm_90a).
//
// Both kernels work on the receiver-sorted edge stream that pad_subgraph
// builds (real edges first, sorted by receiver, pad slots at the tail),
// described by a CSR row pointer over its real prefix:
// row_ptr[v] .. row_ptr[v + 1] are the edges whose receiver is v,
// row_ptr[0] = 0 and row_ptr[V] = n_real (ops/segment_kernel.attach_csr_plan).
//
// K1  dmp_segment_sum_sorted: out[v] = sum_{e in row v} msg[e], or
//     msg[rows[e]] where a row index is given, summed in float32 and
//     written once in msg's dtype; rows no edge reaches are zero, edges
//     past row_ptr[V] are never read.
//     Replaces the Pallas windowed segment-sum of
//     dualmessagepassing_tpu/ops/segment_kernel.py (_v5_kernel, launched by
//     _v5_impl). The TPU kernel builds a one-hot [T, W] tile per (chunk,
//     window) pass and contracts it with the message chunk on the MXU, so
//     that sums land in 128-lane windows held in VMEM across sequential
//     grid steps. Hopper has no sequential grid and no use for the one-hot
//     product: the sum is a stream of adds, and what bounds it is the
//     bytes of msg read once (N * H * 4 or 2, N = row_ptr[V]) and of out
//     written once, over 3.35 TB/s.
//     The first version gave each output row to one warp that walked the
//     row's edges in series. That left the card idle where rows are few
//     (64 rows of 64 edges: 64 warps) and where one row is long: the
//     sender plan of a training batch has rows of 400-1,000 edges (a node
//     sends to all its sampled neighbours), and the warp that walked one
//     took 0.39 ms of a 0.036 ms bound.
//     The design: the V + N items (row ends and edges) are cut into equal
//     shares, one per warp, as in a merge-path CSR reduction (Merrill and
//     Garland, SC16), as many shares as the card holds warps at once. Each
//     warp finds its share's first and last (row, edge) by a search in
//     row_ptr (two half warps, 16 probes a step), so no host plan is
//     needed. It streams its edges reading words of the widest size (2-16
//     bytes) that divides a row's bytes and msg's address, several slabs
//     of edges in flight whatever rows they fall in; a row of fewer than
//     32 words is read by groups of lanes that take one edge each and are
//     added by a butterfly in a fixed order. A row that begins and ends in
//     the share is written once; a row cut by a share boundary leaves
//     float32 partials (the head that ends it, the carry of each share it
//     runs through) in a scratch buffer, and after a grid-wide barrier
//     (a cooperative launch) the warp that ended the row adds them in
//     share order and writes it once. So a hub costs what as many edges
//     elsewhere cost, bf16 is rounded once, and the result is the same
//     bits on every call (no atomics: the order of every add follows from
//     the shapes). Short streams (at most 16,384 edges and 512 rows) take
//     a second kernel, one block per row, whose warps split the row and
//     meet in shared memory: there the search, barrier and partials cost
//     more than the sum (64 rows of 64 edges: 0.0054 ms against 0.0021).
//
// K2  dmp_gather_rows_sorted: out[e] = table[idx[e]] for e < n_real, and
//     zero for the pad tail e >= n_real.
//     Replaces the Pallas windowed row-broadcast of the same file
//     (_bcast_kernel, launched by windowed_row_broadcast), which streams
//     the table through VMEM one window at a time and emits each edge
//     chunk as one-hot [T, W] @ window MXU passes. Here it is a bit copy.
//     What bounds it: the E * W * (4 or 2) bytes written (197.9 MB at
//     E = 489,972, W = 101 in float32: 0.059 ms at 3.35 TB/s); the table
//     rows it reads come from L2, since the stream is receiver-sorted.
//     The first version gave each edge row to one warp with 4-byte
//     (float32) or 2-byte (bfloat16) accesses per lane and one dependent
//     chain (idx, table row, store) per warp: a 101-wide row took 4
//     passes, the last on 5 of 32 lanes, and bfloat16 ran at 25 % of HBM
//     bandwidth, bound by instructions and latency, not by bytes.
//     The design: the copy moves words of the widest size (2, 4, 8 or 16
//     bytes) that divides a row's bytes and both pointers, so a 50-wide
//     float32 row is 25 words of 8 bytes and a 128-wide one 32 of 16.
//     The output is one flat array of E * W words, walked in 16-byte
//     chunks by a grid-stride loop sized to the SM count, kUnroll
//     independent chunks in flight per thread. A chunk may straddle two
//     edges; each thread tracks its (edge, column) incrementally, with
//     no division per chunk. Every chunk is one 16-byte store of words
//     loaded one by one from the table (L1/L2). (Two aligned 16-byte
//     loads and a funnel shift per misaligned chunk measured slower.)
//     The words before the first 16-byte boundary of out (a view at a
//     misaligned offset) and after the last whole chunk are copied one
//     by one. The walk is over output bytes, so a 5,000-edge hub row
//     costs what 5,000 other edges cost, and no thread waits on it. On
//     an NVIDIA H100 80GB HBM3 at 700 W it took 0.107 ms at f32 W = 101
//     (64 % of HBM bandwidth, 73 % of what a device copy reaches) and
//     0.079 ms in bfloat16 (44 %), where its eight 2-byte table loads per
//     store are the likely limit. The copy moves raw bits, so the result
//     is bitwise equal to table[idx] for float32 and bfloat16, NaN
//     payloads and -0 included.
//
// In training the two kernels are each other's backward, as in the JAX
// package (_v5_call_b; _take_rows_bcast, _take_rows_win_perm): K1 sums
// the cotangents of the receiver gather (on the receiver row pointer) and
// of the sender gather (on a sender-sorted row pointer, reading the
// cotangent rows through the sender order instead of a permuted copy),
// and K2 gathers the aggregation's cotangent back onto the edges.
//
// K4  dmp_csr_segment_sum: the CSR row-tiled segment-sum of
//     dualmessagepassing_tpu/ops/pallas_scatter.py (_csr_kernel, launched
//     by pallas_csr_segment_sum) computes exactly what K1 computes in
//     float32 on a sorted stream with a row pointer; on Hopper it is K1's
//     kernels behind an entry of its own (f32 only and no row index, as
//     the TPU kernel), so that its launches are counted apart.
//
// The launchers take PyTorch's current stream, allocate nothing (the
// wrapper passes K1's scratch, sized for the most shares the launcher may
// choose), and return the launch's error so the Python wrapper can raise
// on a refused launch. An index outside its table, or a row pointer that
// does not start at 0, decreases, or runs past the stream, traps the
// kernel (a device-side fault reported at the next synchronisation)
// instead of reading out of bounds.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxDevices = 64;
int g_sm_count[kMaxDevices];   // SMs per device, read at first use

cudaError_t sm_count(int device, int* out) {
  if (g_sm_count[device] <= 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &g_sm_count[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *out = g_sm_count[device];
  return cudaSuccess;
}

// --- K1 and K4 ----------------------------------------------------------

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSumWarps = 8;   // shares per block: 256 threads
constexpr int kWide = 4;       // words per lane when a row has > 32 words

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// Element bits to float and back: float32 or bfloat16.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using Bits = uint32_t;
  static __device__ __forceinline__ float get(Bits b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ Bits put(float x) {
    return __float_as_uint(x);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  using Bits = uint16_t;
  static __device__ __forceinline__ float get(Bits b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  static __device__ __forceinline__ Bits put(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

// elements of T in a word U
template <typename T, typename U>
constexpr int kPer = sizeof(U) / sizeof(T);

template <typename T, typename U>
union Packed {
  U u;
  typename Elem<T>::Bits e[kPer<T, U>];
};

// The merge-path split of diagonal d over n_rows row ends and n_edges
// edges: the number x of rows whose end comes before item d, so that d - x
// edges do. Row x ends after its last edge, i.e. before item d iff
// row_ptr[x + 1] + x + 1 <= d, which grows with x. The 16 lanes of a half
// warp (`mask`) probe 16 points of the interval at once.
__device__ __forceinline__ int64_t merge_split(
    const int32_t* __restrict__ row_ptr, int64_t d, int64_t n_rows,
    int64_t n_edges, int lane16, unsigned mask) {
  int64_t lo = d > n_edges ? d - n_edges : 0;
  int64_t hi = d < n_rows ? d : n_rows;   // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t step = (hi - lo + 15) / 16;
    const int64_t x = lo + lane16 * step;
    const bool ended = x < hi && row_ptr[x + 1] + x + 1 <= d;
    const int n = __popc(__ballot_sync(mask, ended) & mask);
    if (n == 0) {
      hi = lo;
    } else {
      const int64_t base = lo;
      lo = base + (n - 1) * step + 1;
      hi = imin(hi, base + n * step);
    }
  }
  return lo;
}

// The msg row that edge e reads: e, or rows[e]; -1 from `end` on.
__device__ __forceinline__ int64_t msg_row(const int64_t* __restrict__ rows,
                                           int e, int end,
                                           int64_t n_msg_rows) {
  if (e >= end) return -1;
  if (rows == nullptr) return e;
  const int64_t r = __ldg(rows + e);
  if (r < 0 || r >= n_msg_rows) __trap();
  return r;
}

// Slabs a warp loads at once: 8 for rows of up to 32 words; for wider
// rows (K words a lane) up to 128 bytes in flight a lane, at least 2 and
// at most 8 slabs (16 slabs of 2-byte words cost more registers than
// they hide latency).
template <typename U, int K>
constexpr int kSlabsInFlight =
    K == 1 ? 8
           : std::max(2, std::min(8, 128 / static_cast<int>(sizeof(U)) / K));

// A warp's walk over the rows of its share, one column pass: the f32
// sums of the current row (K words of kP elements per lane), and where
// the row and the next row end. Lane l holds in `ends` the end of row
// base + l, so the walk reads row_ptr once per 32 rows.
template <typename T, typename U, int K>
struct RowWalk {
  static constexpr int kP = kPer<T, U>;
  static constexpr int kNone = 0x7fffffff;   // row i1 ends past the share
  float acc[K][kP];
  int i, start, end, base, ends;

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int q = 0; q < kP; ++q) acc[k][q] = 0.f;
    }
  }
  __device__ __forceinline__ void add(const Packed<T, U> (&w)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int q = 0; q < kP; ++q) acc[k][q] += Elem<T>::get(w[k].e[q]);
    }
  }
  // adds the sums of the warp's groups of `lanes` lanes in a fixed order;
  // every lane then holds the total
  __device__ __forceinline__ void reduce(int lanes) {
    for (int off = lanes; off < kWarp; off *= 2) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int q = 0; q < kP; ++q) {
          acc[k][q] += __shfl_xor_sync(kFull, acc[k][q], off);
        }
      }
    }
  }
  // the f32 sums into a partial row, by the lanes of group 0
  __device__ __forceinline__ void store(float* dst, int c0, int lanes,
                                        int words) const {
    const int gl = threadIdx.x % kWarp;
    if (gl >= lanes) return;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + gl + k * lanes;
      if (c < words) {
#pragma unroll
        for (int q = 0; q < kP; ++q) dst[c * kP + q] = acc[k][q];
      }
    }
  }
  __device__ __forceinline__ void load_end(const int32_t* __restrict__ row_ptr,
                                           int i1, int n_rows, int n) {
    if (i < i1) {
      if (i - base == kWarp) {
        base = i;
        const int lane = threadIdx.x % kWarp;
        ends = row_ptr[min(base + 1 + lane, n_rows)];
      }
      end = __shfl_sync(kFull, ends, i - base);
      if (end < start || end > n) __trap();
    } else {
      end = kNone;
    }
  }
  // row i is whole: its sum goes to out (or, if it began in an earlier
  // share, to the head partial), and the walk moves to row i + 1
  __device__ __forceinline__ void finish(
      U* __restrict__ out, float* head, bool head_cut, int i0, int i1,
      const int32_t* __restrict__ row_ptr, int n_rows, int n, int c0,
      int lanes, int words) {
    reduce(lanes);
    if (i == i0 && head_cut) {
      store(head, c0, lanes, words);
    } else {
      const int gl = threadIdx.x % kWarp;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = c0 + gl + k * lanes;
        if (gl < lanes && c < words) {
          Packed<T, U> o;
#pragma unroll
          for (int q = 0; q < kP; ++q) o.e[q] = Elem<T>::put(acc[k][q]);
          out[int64_t{i} * words + c] = o.u;
        }
      }
    }
    zero();
    ++i;
    start = end;
    load_end(row_ptr, i1, n_rows, n);
  }
};

// One warp per share of the V + N items (row ends and edges; N =
// row_ptr[V]), items [s * per, (s + 1) * per). The warp streams the
// share's edges in slabs of G = 32 / lanes consecutive edges, one edge per
// group of `lanes` lanes, each lane K words of the row per column pass;
// kBatch slabs are loaded at once, whatever rows they fall in, so a warp
// has as many loads in flight for short rows as for long ones. Where a
// row ends, a butterfly over the groups adds their sums in a fixed order.
// A row that begins and ends in the share is written to out. The row
// begun in an earlier share and ended here leaves its f32 sum in the
// share's head partial, and the row still open at the share's end its
// sum in the carry partial. The grid is one wave, launched cooperatively:
// after a grid-wide barrier, each warp with a head adds the carries of
// the shares from the one that holds the row's first edge up to its own,
// then its head, in share order, and writes the row once.
// Positions in the stream are int32 (the entry checks V + E).
template <typename T, typename U, int K>
__global__ void __launch_bounds__(kWarp * kSumWarps)
segment_sum_kernel(const U* __restrict__ msg, const int64_t* __restrict__ rows,
                   const int32_t* __restrict__ row_ptr, U* __restrict__ out,
                   float* __restrict__ partial, int n_rows, int words,
                   int64_t n_msg_rows, int n_edges, int n_shares, int lanes) {
  constexpr int kP = kPer<T, U>;
  constexpr int kBatch = kSlabsInFlight<U, K>;
  constexpr int kRun = 16 / kP > 1 ? 16 / kP : 2;   // carries in flight
  const int lane = threadIdx.x % kWarp;
  const int s = blockIdx.x * kSumWarps + threadIdx.x / kWarp;
  const int64_t width = int64_t{words} * kP;
  float* head = partial + 2 * int64_t{s} * width;
  float* carry = head + width;
  int head_row = -1, first = 0;
  if (s < n_shares) {   // every warp reaches the grid barrier below
    const int n = row_ptr[n_rows];
    if (row_ptr[0] != 0 || n < 0 || n > n_edges) __trap();
    const int total = n_rows + n;
    const int per = (total + n_shares - 1) / n_shares;
    const int d0 = static_cast<int>(imin(int64_t{s} * per, total));
    const int d1 = static_cast<int>(imin(int64_t{d0} + per, total));
    const int half = lane / 16;
    const int x = static_cast<int>(
        merge_split(row_ptr, half ? d1 : d0, n_rows, n, lane % 16,
                    half ? 0xffff0000u : 0x0000ffffu));
    const int i0 = __shfl_sync(kFull, x, 0);
    const int i1 = __shfl_sync(kFull, x, 16);
    const int j0 = d0 - i0;
    const int j1 = d1 - i1;
    const int first0 = row_ptr[i0];
    if (i1 < i0 || j1 < j0 || first0 > j0) __trap();
    const bool head_cut = i0 < i1 && first0 < j0;
    if (head_cut) {
      head_row = i0;
      first = (first0 + i0) / per;   // the share of the row's first edge
    }
    const int groups = kWarp / lanes;
    const int g = lane / lanes;
    const int gl = lane % lanes;
    for (int c0 = 0; c0 < words; c0 += lanes * K) {
      RowWalk<T, U, K> walk;
      walk.zero();
      walk.i = i0;
      walk.start = j0;
      walk.base = i0;
      walk.ends = row_ptr[min(i0 + 1 + lane, n_rows)];
      walk.end = i0 < i1 ? __shfl_sync(kFull, walk.ends, 0)
                         : RowWalk<T, U, K>::kNone;
      if (i0 < i1 && (walk.end < j0 || walk.end > n)) __trap();
      // the msg rows of a batch of slabs; through `rows`, those of the
      // next batch load while this one is summed
      int64_t next[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        next[b] = msg_row(rows, j0 + b * groups + g, j1, n_msg_rows);
      }
      for (int e = j0; e < j1; e += kBatch * groups) {
        Packed<T, U> w[kBatch][K];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int64_t r = next[b];
          const U* src = msg + r * words;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int c = c0 + gl + k * lanes;
            w[b][k].u = r >= 0 && c < words ? __ldg(src + c) : U{};
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          next[b] = msg_row(rows, e + (kBatch + b) * groups + g, j1,
                            n_msg_rows);
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int s0 = e + b * groups;
          if (s0 >= j1) break;
          const int lim = min(s0 + groups, j1);
          const int mine = s0 + g;
          bool pending = mine < lim;
          while (walk.end <= lim) {   // row i ends in this slab
            if (pending && mine < walk.end) {
              walk.add(w[b]);
              pending = false;
            }
            walk.finish(out, head, head_cut, i0, i1, row_ptr, n_rows, n, c0,
                        lanes, words);
          }
          if (pending) walk.add(w[b]);
        }
      }
      // a share with no edges: its rows are empty here
      while (walk.i < i1) {
        walk.finish(out, head, head_cut, i0, i1, row_ptr, n_rows, n, c0,
                    lanes, words);
      }
      if (i1 < n_rows && j1 > walk.start) {   // the carry: row i1 so far
        walk.reduce(lanes);
        walk.store(carry, c0, lanes, words);
      }
    }
  }
  cooperative_groups::this_grid().sync();
  if (head_row < 0) return;
  // the row cut at this share's start: carries of shares first .. s - 1,
  // then the head, kRun carries in flight per lane
  const int64_t stride = 2 * width;
  for (int c = lane; c < words; c += kWarp) {
    float acc[kP];
#pragma unroll
    for (int q = 0; q < kP; ++q) acc[q] = 0.f;
    const float* src = partial + (2 * int64_t{first} + 1) * width + c * kP;
    int t = first;
    for (; t + kRun <= s; t += kRun, src += kRun * stride) {
      float v[kRun][kP];
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
#pragma unroll
        for (int q = 0; q < kP; ++q) v[u][q] = src[u * stride + q];
      }
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
#pragma unroll
        for (int q = 0; q < kP; ++q) acc[q] += v[u][q];
      }
    }
    for (; t < s; ++t, src += stride) {
#pragma unroll
      for (int q = 0; q < kP; ++q) acc[q] += src[q];
    }
    Packed<T, U> o;
#pragma unroll
    for (int q = 0; q < kP; ++q) {
      o.e[q] = Elem<T>::put(acc[q] + head[c * kP + q]);
    }
    out[int64_t{head_row} * words + c] = o.u;
  }
}

// Short streams (kShortEdges edges, kShortRows rows at most): one block
// per row, its kSumWarps warps each a contiguous piece of the row's edges
// (slabs of G edges, kBatch slabs in flight, as above); the warps' f32
// sums meet in shared memory and warp 0 adds them in warp order and
// writes the row once. One launch and no barrier across blocks: at 64
// rows of 64 edges the merge path's search, grid barrier and fixup cost
// more than the sum itself.
constexpr int kShortEdges = 16384;
constexpr int kShortRows = 512;

template <typename T, typename U, int K>
__global__ void __launch_bounds__(kWarp * kSumWarps)
segment_sum_rows_kernel(const U* __restrict__ msg,
                        const int64_t* __restrict__ rows,
                        const int32_t* __restrict__ row_ptr,
                        U* __restrict__ out, int n_rows, int words,
                        int64_t n_msg_rows, int n_edges, int lanes) {
  constexpr int kP = kPer<T, U>;
  constexpr int kBatch = kSlabsInFlight<U, K>;
  __shared__ float sums[kSumWarps][kWarp * K * kP];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int row = blockIdx.x;
  const int n = row_ptr[n_rows];
  const int begin = row_ptr[row];
  const int end = row_ptr[row + 1];
  if (row_ptr[0] != 0 || n < 0 || n > n_edges || begin < 0 || end < begin ||
      end > n) {
    __trap();
  }
  const int piece = (end - begin + kSumWarps - 1) / kSumWarps;
  const int lo = begin + warp * piece;
  const int hi = min(lo + piece, end);
  const int groups = kWarp / lanes;
  const int g = lane / lanes;
  const int gl = lane % lanes;
  for (int c0 = 0; c0 < words; c0 += lanes * K) {
    RowWalk<T, U, K> walk;
    walk.zero();
    for (int e = lo; e < hi; e += kBatch * groups) {
      Packed<T, U> w[kBatch][K];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int64_t r = msg_row(rows, e + b * groups + g, hi, n_msg_rows);
        const U* src = msg + r * words;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = c0 + gl + k * lanes;
          w[b][k].u = r >= 0 && c < words ? __ldg(src + c) : U{};
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) walk.add(w[b]);
    }
    walk.reduce(lanes);
    walk.store(sums[warp], 0, lanes, lanes * K);
    __syncthreads();
    if (warp == 0) {
      for (int c = lane; c < lanes * K && c0 + c < words; c += kWarp) {
        Packed<T, U> o;
#pragma unroll
        for (int q = 0; q < kP; ++q) {
          float acc = 0.f;
#pragma unroll
          for (int v = 0; v < kSumWarps; ++v) acc += sums[v][c * kP + q];
          o.e[q] = Elem<T>::put(acc);
        }
        out[int64_t{row} * words + c0 + c] = o.u;
      }
    }
    __syncthreads();
  }
}

// A cooperative launch: the runtime refuses it unless every block of the
// grid can be resident at once, which a grid-wide barrier needs.
template <typename... Args>
cudaError_t launch_cooperative(void (*kernel)(Args...), dim3 grid,
                               dim3 block, cudaStream_t s, Args... args) {
  void* ptrs[] = {&args...};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                     block, ptrs, 0, s);
}

// Shares: one per warp the card holds at once for this kernel (one wave,
// as the barrier needs, so every share's search is paid once), at most
// max_shares (the scratch the wrapper sized: at least 16 items a share).
template <typename T, typename U, int K>
cudaError_t launch_sum_kernel(const void* msg, const int64_t* rows,
                              const int32_t* row_ptr, void* out,
                              float* partial, int64_t n_rows, int64_t words,
                              int64_t n_msg_rows, int64_t n_edges,
                              int64_t max_shares, int lanes, int device,
                              cudaStream_t s) {
  static int blocks_per_sm[kMaxDevices];
  int sms = 0;
  cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm[device] <= 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm[device], segment_sum_kernel<T, U, K>,
        kWarp * kSumWarps, 0);
    if (err != cudaSuccess) return err;
  }
  const int64_t n_shares = std::max<int64_t>(
      1, std::min<int64_t>(max_shares, int64_t{sms} * blocks_per_sm[device] *
                                           kSumWarps));
  const unsigned blocks =
      static_cast<unsigned>((n_shares + kSumWarps - 1) / kSumWarps);
  return launch_cooperative(
      segment_sum_kernel<T, U, K>, dim3(blocks), dim3(kWarp * kSumWarps), s,
      static_cast<const U*>(msg), rows, row_ptr, static_cast<U*>(out),
      partial, static_cast<int>(n_rows), static_cast<int>(words), n_msg_rows,
      static_cast<int>(n_edges), static_cast<int>(n_shares), lanes);
}

template <typename T, typename U>
cudaError_t launch_segment_sum(const void* msg, const int64_t* rows,
                               const int32_t* row_ptr, void* out,
                               float* partial, int64_t n_rows, int64_t words,
                               int64_t n_msg_rows, int64_t n_edges,
                               int64_t max_shares, int device,
                               cudaStream_t s) {
  const bool short_stream = n_edges <= kShortEdges && n_rows <= kShortRows;
  const dim3 threads(kWarp * kSumWarps);
  const U* m = static_cast<const U*>(msg);
  U* o = static_cast<U*>(out);
  const int v = static_cast<int>(n_rows), w = static_cast<int>(words);
  const int e = static_cast<int>(n_edges);
  if (words <= kWarp) {
    int lanes = 1;
    while (lanes < words) lanes *= 2;
    if (short_stream) {
      segment_sum_rows_kernel<T, U, 1><<<v, threads, 0, s>>>(
          m, rows, row_ptr, o, v, w, n_msg_rows, e, lanes);
      return cudaGetLastError();
    }
    return launch_sum_kernel<T, U, 1>(msg, rows, row_ptr, out, partial,
                                      n_rows, words, n_msg_rows, n_edges,
                                      max_shares, lanes, device, s);
  }
  if (short_stream) {
    segment_sum_rows_kernel<T, U, kWide><<<v, threads, 0, s>>>(
        m, rows, row_ptr, o, v, w, n_msg_rows, e, kWarp);
    return cudaGetLastError();
  }
  return launch_sum_kernel<T, U, kWide>(msg, rows, row_ptr, out, partial,
                                        n_rows, words, n_msg_rows, n_edges,
                                        max_shares, kWarp, device, s);
}

// The word: the widest of 16, 8, 4 and 2 bytes (not below the element)
// that divides a row's bytes and msg's address.
template <typename T>
cudaError_t launch_segment_sum_any(const void* msg, const void* rows,
                                   const void* row_ptr, void* out,
                                   void* scratch, int64_t n_rows,
                                   int64_t width, int64_t n_msg_rows,
                                   int64_t n_edges, int64_t max_shares,
                                   int device, cudaStream_t s) {
  const uintptr_t row_bytes = static_cast<uintptr_t>(width) * sizeof(T);
  const uintptr_t common = row_bytes | reinterpret_cast<uintptr_t>(msg);
  if (common % sizeof(T) != 0) return cudaErrorInvalidValue;
  int word = 16;
  while (common % word != 0) word /= 2;
  const int64_t words = static_cast<int64_t>(row_bytes) / word;
  const auto* r = static_cast<const int64_t*>(rows);
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  auto* sc = static_cast<float*>(scratch);
  switch (word) {
    case 16:
      return launch_segment_sum<T, uint4>(msg, r, rp, out, sc, n_rows, words,
                                          n_msg_rows, n_edges, max_shares,
                                          device, s);
    case 8:
      return launch_segment_sum<T, uint2>(msg, r, rp, out, sc, n_rows, words,
                                          n_msg_rows, n_edges, max_shares,
                                          device, s);
    case 4:
      return launch_segment_sum<T, uint32_t>(msg, r, rp, out, sc, n_rows,
                                             words, n_msg_rows, n_edges,
                                             max_shares, device, s);
    default:
      if constexpr (sizeof(T) == 2) {
        return launch_segment_sum<T, uint16_t>(msg, r, rp, out, sc, n_rows,
                                               words, n_msg_rows, n_edges,
                                               max_shares, device, s);
      }
      return cudaErrorInvalidValue;
  }
}

// --- K2 ---------------------------------------------------------------

constexpr int kGatherThreads = 256;
constexpr int kGatherBlocksPerSm = 2048 / kGatherThreads;
constexpr int kUnroll = 4;          // 16-byte chunks in flight per thread

// The table row of edge e, or -1 on the pad tail.
__device__ __forceinline__ int64_t source_row(const int64_t* __restrict__ idx,
                                              int64_t e, int64_t n_real,
                                              int64_t n_table_rows) {
  if (e >= n_real) return -1;
  const int64_t r = __ldg(idx + e);
  if (r < 0 || r >= n_table_rows) __trap();
  return r;
}

template <typename U>
constexpr int kChunk = 16 / sizeof(U);   // words in 16 bytes

template <typename U>
union Chunk {
  uint4 v;
  U w[kChunk<U>];
};

// The chunk whose first word is (edge e, column c), word by word: a
// chunk may straddle edges.
template <typename U>
__device__ __forceinline__ Chunk<U> gather_chunk(
    const U* __restrict__ table, const int64_t* __restrict__ idx,
    int64_t n_table_rows, int64_t width, int64_t n_real, int64_t e,
    int64_t c) {
  Chunk<U> out;
  int64_t r = source_row(idx, e, n_real, n_table_rows);
#pragma unroll
  for (int j = 0; j < kChunk<U>; ++j) {
    out.w[j] = r >= 0 ? __ldg(table + r * width + c) : U{};
    if (++c == width && j + 1 < kChunk<U>) {
      c = 0;
      r = source_row(idx, ++e, n_real, n_table_rows);
    }
  }
  return out;
}

// U is an unsigned word of 2, 4, 8 or 16 bytes (the copy moves bits),
// width counts words, and out is E * width words; chunk k covers words head + k * kN ..
// head + (k + 1) * kN - 1, 16-byte aligned. Each thread starts at chunk
// t and steps by the grid's thread count, i.e. by step_q edges and
// step_r columns. Block 0 also copies the head (words before the first
// aligned chunk) and the tail (after the last whole chunk).
template <typename U>
__global__ void __launch_bounds__(kGatherThreads)
gather_rows_sorted_kernel(const U* __restrict__ table,
                          const int64_t* __restrict__ idx,
                          U* __restrict__ out, int64_t n_table_rows,
                          int64_t width, int64_t n_real, int64_t n_words,
                          int64_t head, int64_t n_chunks, int64_t step_q,
                          int64_t step_r) {
  constexpr int kN = kChunk<U>;
  if (blockIdx.x == 0) {
    const int64_t tail = head + n_chunks * kN;
    int64_t o = -1;
    if (threadIdx.x < head) {
      o = threadIdx.x;
    } else if (threadIdx.x >= kN && threadIdx.x - kN < n_words - tail) {
      o = tail + threadIdx.x - kN;
    }
    if (o >= 0) {
      const int64_t r =
          source_row(idx, o / width, n_real, n_table_rows);
      out[o] = r >= 0 ? table[r * width + o % width] : U{};
    }
  }
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kGatherThreads + threadIdx.x;
  const int64_t n_threads = static_cast<int64_t>(gridDim.x) * kGatherThreads;
  const int64_t first = head + t * kN;
  int64_t e = first / width;
  int64_t c = first - e * width;
  uint4* dst = reinterpret_cast<uint4*>(out + head);
  for (int64_t k0 = t; k0 < n_chunks; k0 += kUnroll * n_threads) {
    Chunk<U> chunk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u * n_threads < n_chunks) {
        chunk[u] = gather_chunk<U>(table, idx, n_table_rows, width, n_real,
                                   e, c);
      }
      e += step_q;
      c += step_r;
      if (c >= width) {
        c -= width;
        ++e;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u * n_threads < n_chunks) {
        __stcs(dst + k0 + u * n_threads, chunk[u].v);
      }
    }
  }
}

template <typename U>
cudaError_t launch_gather(const void* table, const void* idx, void* out,
                          int64_t n_table_rows, int64_t width,
                          int64_t n_edges, int64_t n_real, int device,
                          cudaStream_t s) {
  constexpr int kN = kChunk<U>;
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const uintptr_t out_addr = reinterpret_cast<uintptr_t>(out);
  const int64_t n_words = n_edges * width;
  const int64_t head = std::min<int64_t>(
      n_words, static_cast<int64_t>((16 - out_addr % 16) % 16 / sizeof(U)));
  const int64_t n_chunks = (n_words - head) / kN;
  const int64_t per_block = int64_t{kGatherThreads} * kUnroll;
  const int64_t blocks = std::max<int64_t>(
      1, std::min<int64_t>((n_chunks + per_block - 1) / per_block,
                           int64_t{sms} * kGatherBlocksPerSm));
  const int64_t step = blocks * kGatherThreads * kN;
  gather_rows_sorted_kernel<U>
      <<<static_cast<unsigned>(blocks), kGatherThreads, 0, s>>>(
          static_cast<const U*>(table), static_cast<const int64_t*>(idx),
          static_cast<U*>(out), n_table_rows, width, n_real, n_words, head,
          n_chunks, step / width, step % width);
  return cudaGetLastError();
}

}  // namespace

// K1. dtype: 0 = float32, 1 = bfloat16. rows: int64 [n_edges] or null
// (then msg has n_edges = n_msg_rows rows). scratch: float32
// [2 * max_shares * width]. Returns a cudaError_t as int.
extern "C" int dmp_segment_sum_sorted(const void* msg, const void* rows,
                                      const void* row_ptr, void* out,
                                      void* scratch, int64_t n_rows,
                                      int64_t width, int64_t n_msg_rows,
                                      int64_t n_edges, int64_t max_shares,
                                      int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  if (max_shares <= 0 || max_shares >= INT32_MAX ||
      n_rows + n_edges >= INT32_MAX / 2 || width >= INT32_MAX ||
      (rows == nullptr && n_edges != n_msg_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_segment_sum_any<float>(msg, rows, row_ptr, out, scratch,
                                        n_rows, width, n_msg_rows, n_edges,
                                        max_shares, device, s);
  } else if (dtype == 1) {
    err = launch_segment_sum_any<__nv_bfloat16>(
        msg, rows, row_ptr, out, scratch, n_rows, width, n_msg_rows, n_edges,
        max_shares, device, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// K4: float32, no row index. Returns a cudaError_t as int.
extern "C" int dmp_csr_segment_sum(const void* msg, const void* row_ptr,
                                   void* out, void* scratch, int64_t n_rows,
                                   int64_t width, int64_t n_edges,
                                   int64_t max_shares, int device,
                                   void* stream) {
  return dmp_segment_sum_sorted(msg, nullptr, row_ptr, out, scratch, n_rows,
                                width, n_edges, n_edges, max_shares, 0,
                                device, stream);
}

// elem_bytes: 4 (float32) or 2 (bfloat16). Returns a cudaError_t as int.
extern "C" int dmp_gather_rows_sorted(const void* table, const void* idx,
                                      void* out, int64_t n_table_rows,
                                      int64_t width, int64_t n_edges,
                                      int64_t n_real, int elem_bytes,
                                      int device, void* stream) {
  if (device < 0 || device >= kMaxDevices ||
      (elem_bytes != 4 && elem_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_edges <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  // the copy moves the widest word (2 to 16 bytes) that divides a row's
  // bytes and both pointers
  const uintptr_t row_bytes = static_cast<uintptr_t>(width) * elem_bytes;
  const uintptr_t common = row_bytes | reinterpret_cast<uintptr_t>(table) |
                           reinterpret_cast<uintptr_t>(out);
  if (common % elem_bytes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int word = 16;
  while (common % word != 0) word /= 2;
  const int64_t words = static_cast<int64_t>(row_bytes) / word;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word) {
    case 16:
      err = launch_gather<uint4>(table, idx, out, n_table_rows, words,
                                 n_edges, n_real, device, s);
      break;
    case 8:
      err = launch_gather<uint2>(table, idx, out, n_table_rows, words,
                                 n_edges, n_real, device, s);
      break;
    case 4:
      err = launch_gather<uint32_t>(table, idx, out, n_table_rows, words,
                                    n_edges, n_real, device, s);
      break;
    default:
      err = launch_gather<uint16_t>(table, idx, out, n_table_rows, words,
                                    n_edges, n_real, device, s);
  }
  return static_cast<int>(err);
}
