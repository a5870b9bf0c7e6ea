// Segment kernels of the UNC DMPNN layer for Hopper (sm_90a).
//
// Both kernels work on the receiver-sorted edge stream that pad_subgraph
// builds (real edges first, sorted by receiver, pad slots at the tail),
// described by a CSR row pointer over its real prefix:
// row_ptr[v] .. row_ptr[v + 1] are the edges whose receiver is v, and
// row_ptr[V] = n_real (ops/segment_kernel.attach_csr_plan).
//
// K1  dmp_segment_sum_sorted: out[v] = sum_{e in row v} msg[e]
//     Replaces the Pallas windowed segment-sum of
//     dualmessagepassing_tpu/ops/segment_kernel.py (_v5_kernel, launched by
//     _v5_impl). The TPU kernel builds a one-hot [T, W] tile per (chunk,
//     window) pass and contracts it with the message chunk on the MXU, so
//     that sums land in 128-lane windows held in VMEM across sequential
//     grid steps. Hopper has no sequential grid and reads narrow rows
//     well, so the kernel here walks the CSR row instead: one warp per
//     output row, lanes across the feature columns (up to 128 columns per
//     pass, 4 per lane), a float32 accumulator in registers, and one write
//     of each output row, zeros for rows no edge reaches. No atomics: the
//     summation order is the stream order, so results are deterministic.
//     Bound: the bytes of msg (E * H * 2 or 4), read once, each edge row
//     coalesced across the warp. Hub rows serialise on their one warp;
//     at the slice's shapes (mean in-degree ~8, max in-degree bounded by
//     the sampler's width per node) that is acceptable for now.
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
// of the sender gather (on a sender-sorted row pointer), and K2 gathers
// the aggregation's cotangent back onto the edges.
//
// K4  dmp_csr_segment_sum: the CSR row-tiled segment-sum of
//     dualmessagepassing_tpu/ops/pallas_scatter.py (_csr_kernel, launched
//     by pallas_csr_segment_sum) computes exactly what K1 computes in
//     float32 on a sorted stream with a row pointer; on Hopper it is K1's
//     kernel behind an entry of its own (f32 only, as the TPU kernel),
//     so that its launches are counted apart.
//
// The launchers take PyTorch's current stream, allocate nothing, and
// return cudaGetLastError() so the Python wrapper can raise on a refused
// launch. An index outside its table, or a row pointer outside the
// stream, traps the kernel (a device-side fault reported at the next
// synchronisation) instead of reading out of bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;   // 8 warps, 256 threads per block
constexpr int kColsPerLane = 4;    // one pass covers 128 columns

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
segment_sum_sorted_kernel(const T* __restrict__ msg,
                          const int32_t* __restrict__ row_ptr,
                          T* __restrict__ out, int64_t n_rows,
                          int64_t width, int64_t n_edges) {
  const int lane = threadIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                      threadIdx.y;
  if (row >= n_rows) return;
  const int64_t begin = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  if (begin < 0 || end < begin || end > n_edges) __trap();
  T* dst = out + row * width;
  for (int64_t c0 = 0; c0 < width; c0 += kWarp * kColsPerLane) {
    float acc[kColsPerLane] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int64_t e = begin; e < end; ++e) {
      const T* src = msg + e * width;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int64_t c = c0 + lane + j * kWarp;
        if (c < width) acc[j] += to_f32(src[c]);
      }
    }
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int64_t c = c0 + lane + j * kWarp;
      if (c < width) dst[c] = from_f32<T>(acc[j]);
    }
  }
}

inline dim3 grid_for(int64_t rows) {
  return dim3(static_cast<unsigned>((rows + kRowsPerBlock - 1) /
                                    kRowsPerBlock));
}

// --- K2 ---------------------------------------------------------------

constexpr int kGatherThreads = 256;
constexpr int kGatherBlocksPerSm = 2048 / kGatherThreads;
constexpr int kUnroll = 4;          // 16-byte chunks in flight per thread
constexpr int kMaxDevices = 64;

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

int g_sm_count[kMaxDevices];

template <typename U>
cudaError_t launch_gather(const void* table, const void* idx, void* out,
                          int64_t n_table_rows, int64_t width,
                          int64_t n_edges, int64_t n_real, int device,
                          cudaStream_t s) {
  constexpr int kN = kChunk<U>;
  if (g_sm_count[device] <= 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &g_sm_count[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const uintptr_t out_addr = reinterpret_cast<uintptr_t>(out);
  const int64_t n_words = n_edges * width;
  const int64_t head = std::min<int64_t>(
      n_words, static_cast<int64_t>((16 - out_addr % 16) % 16 / sizeof(U)));
  const int64_t n_chunks = (n_words - head) / kN;
  const int64_t per_block = int64_t{kGatherThreads} * kUnroll;
  const int64_t blocks = std::max<int64_t>(
      1, std::min<int64_t>((n_chunks + per_block - 1) / per_block,
                           int64_t{g_sm_count[device]} * kGatherBlocksPerSm));
  const int64_t step = blocks * kGatherThreads * kN;
  gather_rows_sorted_kernel<U>
      <<<static_cast<unsigned>(blocks), kGatherThreads, 0, s>>>(
          static_cast<const U*>(table), static_cast<const int64_t*>(idx),
          static_cast<U*>(out), n_table_rows, width, n_real, n_words, head,
          n_chunks, step / width, step % width);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t as int.
extern "C" int dmp_segment_sum_sorted(const void* msg, const void* row_ptr,
                                      void* out, int64_t n_rows,
                                      int64_t width, int64_t n_edges,
                                      int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kWarp, kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* rp = static_cast<const int32_t*>(row_ptr);
  if (dtype == 0) {
    segment_sum_sorted_kernel<float><<<grid_for(n_rows), block, 0, s>>>(
        static_cast<const float*>(msg), rp, static_cast<float*>(out),
        n_rows, width, n_edges);
  } else if (dtype == 1) {
    segment_sum_sorted_kernel<__nv_bfloat16>
        <<<grid_for(n_rows), block, 0, s>>>(
            static_cast<const __nv_bfloat16*>(msg), rp,
            static_cast<__nv_bfloat16*>(out), n_rows, width, n_edges);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4: float32 only. Returns a cudaError_t as int.
extern "C" int dmp_csr_segment_sum(const void* msg, const void* row_ptr,
                                   void* out, int64_t n_rows, int64_t width,
                                   int64_t n_edges, int device,
                                   void* stream) {
  return dmp_segment_sum_sorted(msg, row_ptr, out, n_rows, width, n_edges,
                                0, device, stream);
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
