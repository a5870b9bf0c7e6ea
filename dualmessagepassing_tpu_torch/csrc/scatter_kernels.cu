// Segment-sum over an UNSORTED edge stream for Hopper (sm_90a).
//
// K3  dmp_segment_sum_unsorted: out[v] += msg[e] for every edge e whose
//     receiver v = recv[e] lies in [0, n_rows); edges with a receiver
//     outside that range are dropped. out is float32 and zeroed by the
//     caller; msg is float32 or bfloat16 and is summed in float32.
//     Replaces the Pallas full-V accumulator segment-sum of
//     dualmessagepassing_tpu/ops/pallas_scatter.py (_kernel, launched by
//     pallas_segment_sum), which keeps the whole [V, H] accumulator in
//     VMEM and adds one one-hot [V, TILE_E] @ [TILE_E, H] MXU product per
//     edge tile, relying on the TPU's sequential grid to carry the sum.
//     Hopper blocks run in no order, and the accumulator of a large V does
//     not fit a block's shared memory, so the sum is carried by float32
//     atomics in device memory instead: one warp per edge row, lanes
//     across the columns, one red.global.add.f32 per element (atomicAdd
//     whose result is unused compiles to it).
//     Bound: the message bytes read once (E * H * 2 or 4) plus the
//     atomics, which the L2 serves at its own rate; rows that many edges
//     hit serialise on their addresses. The order of the additions
//     changes from run to run, so the result is not bitwise repeatable.
//
// The launcher takes PyTorch's current stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;   // 8 warps, 256 threads per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
segment_sum_unsorted_kernel(const T* __restrict__ msg,
                            const int64_t* __restrict__ recv,
                            float* __restrict__ out, int64_t n_rows,
                            int64_t width, int64_t n_edges) {
  const int lane = threadIdx.x;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.y;
  if (e >= n_edges) return;
  const int64_t r = recv[e];
  if (r < 0 || r >= n_rows) return;   // dropped, as the TPU kernel does
  const T* src = msg + e * width;
  float* dst = out + r * width;
  for (int64_t c = lane; c < width; c += kWarp) {
    atomicAdd(dst + c, to_f32(src[c]));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t as int.
extern "C" int dmp_segment_sum_unsorted(const void* msg, const void* recv,
                                        void* out, int64_t n_rows,
                                        int64_t width, int64_t n_edges,
                                        int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_edges <= 0 || width <= 0 || n_rows <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const dim3 block(kWarp, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((n_edges + kRowsPerBlock - 1) /
                                        kRowsPerBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* rv = static_cast<const int64_t*>(recv);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    segment_sum_unsorted_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(msg), rv, o, n_rows, width, n_edges);
  } else if (dtype == 1) {
    segment_sum_unsorted_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(msg), rv, o, n_rows, width,
        n_edges);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
