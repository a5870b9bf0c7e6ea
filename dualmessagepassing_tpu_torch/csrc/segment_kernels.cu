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
//     chunk as one-hot [T, W] @ window MXU passes. Here it is a bit copy:
//     one warp per output row, lanes across the columns. Bound: the bytes
//     of the output (E * W * 2 or 4); the table rows it reads are served
//     from L2, because the stream is receiver-sorted and neighbouring
//     warps read the same or adjacent rows. The copy moves raw bits, so
//     the result is bitwise equal to table[idx] for f32 and bf16.
//
// Both launchers take PyTorch's current stream, allocate nothing, and
// return cudaGetLastError() so the Python wrapper can raise on a refused
// launch. An index outside its table, or a row pointer outside the
// stream, traps the kernel (a device-side fault reported at the next
// synchronisation) instead of reading out of bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// U is an unsigned integer of the element's size: the copy moves bits.
template <typename U>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
gather_rows_sorted_kernel(const U* __restrict__ table,
                          const int64_t* __restrict__ idx,
                          U* __restrict__ out, int64_t n_table_rows,
                          int64_t width, int64_t n_edges, int64_t n_real) {
  const int lane = threadIdx.x;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.y;
  if (e >= n_edges) return;
  U* dst = out + e * width;
  if (e >= n_real) {
    for (int64_t c = lane; c < width; c += kWarp) dst[c] = U(0);
    return;
  }
  const int64_t r = idx[e];
  if (r < 0 || r >= n_table_rows) __trap();
  const U* src = table + r * width;
  for (int64_t c = lane; c < width; c += kWarp) dst[c] = src[c];
}

inline dim3 grid_for(int64_t rows) {
  return dim3(static_cast<unsigned>((rows + kRowsPerBlock - 1) /
                                    kRowsPerBlock));
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

// elem_bytes: 4 (float32) or 2 (bfloat16). Returns a cudaError_t as int.
extern "C" int dmp_gather_rows_sorted(const void* table, const void* idx,
                                      void* out, int64_t n_table_rows,
                                      int64_t width, int64_t n_edges,
                                      int64_t n_real, int elem_bytes,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_edges <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kWarp, kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  if (elem_bytes == 4) {
    gather_rows_sorted_kernel<uint32_t><<<grid_for(n_edges), block, 0, s>>>(
        static_cast<const uint32_t*>(table), ix, static_cast<uint32_t*>(out),
        n_table_rows, width, n_edges, n_real);
  } else if (elem_bytes == 2) {
    gather_rows_sorted_kernel<uint16_t><<<grid_for(n_edges), block, 0, s>>>(
        static_cast<const uint16_t*>(table), ix, static_cast<uint16_t*>(out),
        n_table_rows, width, n_edges, n_real);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
