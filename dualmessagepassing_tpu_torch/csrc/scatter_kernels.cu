// Segment-sum over an UNSORTED edge stream for Hopper (sm_90a).
//
// K3  dmp_segment_sum_unsorted: out[v] = sum of msg[e] over the edges e
//     whose receiver v = recv[e] lies in [0, n_rows); edges with a
//     receiver outside that range are dropped. out is float32 [V, H] and
//     zeroed here (cudaMemsetAsync on the stream); msg is float32 or
//     bfloat16 [E, H] and is summed in float32.
//     Replaces the Pallas full-V accumulator segment-sum of
//     dualmessagepassing_tpu/ops/pallas_scatter.py (_kernel, launched by
//     pallas_segment_sum), which keeps the whole [V, H] accumulator in
//     VMEM and adds one one-hot [V, TILE_E] @ [TILE_E, H] MXU product per
//     edge tile, relying on the TPU's sequential grid to carry the sum.
//
//     What bounds it: one float32 add per message element into rows the
//     receivers pick in no order, and the E * H * (4 or 2) bytes of msg.
//     The adds go to L2 as atomics. On an NVIDIA H100 80GB HBM3 at 700 W
//     the L2 took 1.1-1.9 TB/s of float32 atomic operands, as scalar or
//     as float4 atomics: the float4 form cuts the atomic instructions
//     four-fold and the time by 0-21 %, not the L2's work (0.092 ms at
//     V x E = 82,465 x 497,664, H = 64, for 127 MB of operands).
//
//     The design: `group` lanes (a power of two) share an edge, each lane
//     one item of 4 columns (a float4 or 4 bfloat16 loaded at once, then
//     one vector red.global.add.v4.f32) or of 1 column; a warp takes
//     32 / group edges per step, and each thread has kUnroll steps, i.e.
//     kUnroll receiver loads and kUnroll message loads, in flight. A
//     grid-stride loop sized to the SM count walks the stream. Items are
//     4 columns where H % 4 == 0 and msg is aligned to 4 elements;
//     otherwise single columns (scalar loads and atomics) — the kernel's
//     own scalar path for a ragged width or a misaligned view, not a
//     fallback.
//     The TPU kernel's resident accumulator has no good counterpart here:
//     a block-private [V, H] copy in shared memory needs float atomic
//     adds there, which sm_90 compiles to compare-and-swap loops
//     (ATOMS.CAST.SPIN), and every variant of it measured slower than
//     this kernel at the kernel bench's sizes (PERF.md, Findings).
//     The order of the additions changes from run to run, so the result
//     is not bitwise repeatable.
//
// The launcher takes PyTorch's current stream, allocates nothing, and
// returns the first CUDA error of the memset or the launch, so the Python
// wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;          // 8 warps; 8 blocks fill an SM
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kUnroll = 4;             // edge steps in flight per thread
constexpr int kMaxDevices = 64;

// One item of kC consecutive message values, as float32. kC == 4 needs
// p aligned to 4 elements (16 bytes for float32, 8 for bfloat16).
__device__ __forceinline__ void load_item(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load_item(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void load_item(const __nv_bfloat16* p,
                                          float (&v)[4]) {
  // bfloat16 -> float32 is the 16 bits moved to the top
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void load_item(const __nv_bfloat16* p,
                                          float (&v)[1]) {
  v[0] = __bfloat162float(p[0]);
}

// out (16-byte aligned rows when kC == 4): one vector atomic per item
__device__ __forceinline__ void add_item(float* p, const float (&v)[4]) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void add_item(float* p, const float (&v)[1]) {
  atomicAdd(p, v[0]);
}

// Warp step s covers edges s * per_warp .. s * per_warp + per_warp - 1;
// lane l takes edge s * per_warp + l / group and items l % group,
// l % group + group, ... of its row.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
segment_sum_unsorted_kernel(const T* __restrict__ msg,
                            const int64_t* __restrict__ recv,
                            float* __restrict__ out, int n_rows, int width,
                            int64_t n_edges, int group) {
  const int lane = threadIdx.x % kWarp;
  const int per_warp = kWarp / group;
  const int sub = lane / group;
  const int first = lane % group;
  const int n_items = width / kC;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t s0 = warp; s0 * per_warp < n_edges;
       s0 += kUnroll * n_warps) {
    int64_t edge[kUnroll];
    int row[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      edge[u] = (s0 + u * n_warps) * per_warp + sub;
      row[u] = -1;
      if (edge[u] < n_edges) {
        const int64_t r = __ldg(recv + edge[u]);
        if (r >= 0 && r < n_rows) row[u] = static_cast<int>(r);  // else dropped
      }
    }
    for (int i = first; i < n_items; i += group) {
      float v[kUnroll][kC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (row[u] >= 0) load_item(msg + edge[u] * width + i * kC, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (row[u] >= 0) {
          add_item(out + static_cast<int64_t>(row[u]) * width + i * kC, v[u]);
        }
      }
    }
  }
}

int g_sm_count[kMaxDevices];

template <typename T, int kC>
cudaError_t launch(const void* msg, const void* recv, void* out, int n_rows,
                   int width, int64_t n_edges, int device, cudaStream_t s) {
  if (g_sm_count[device] <= 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &g_sm_count[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  // lanes per edge: the items of a row, rounded up to a power of two
  int group = 1;
  while (group < width / kC && group < kWarp) group <<= 1;
  const int64_t steps = (n_edges + kWarp / group - 1) / (kWarp / group);
  const int64_t per_block = int64_t{kUnroll} * kWarpsPerBlock;
  const int64_t blocks = std::min<int64_t>(
      (steps + per_block - 1) / per_block,
      int64_t{g_sm_count[device]} * (2048 / kThreads));
  segment_sum_unsorted_kernel<T, kC>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<const T*>(msg), static_cast<const int64_t*>(recv),
          static_cast<float*>(out), n_rows, width, n_edges, group);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. out must be 16-byte aligned.
// Returns a cudaError_t as int.
extern "C" int dmp_segment_sum_unsorted(const void* msg, const void* recv,
                                        void* out, int64_t n_rows,
                                        int64_t width, int64_t n_edges,
                                        int dtype, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices || (dtype != 0 && dtype != 1) ||
      n_rows > INT32_MAX || width > INT32_MAX ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, static_cast<size_t>(n_rows * width) * 4, s);
  if (err != cudaSuccess || n_edges <= 0) return static_cast<int>(err);
  const int v = static_cast<int>(n_rows);
  const int h = static_cast<int>(width);
  const uintptr_t quad_bytes = dtype == 0 ? 16 : 8;
  const bool quads =
      h % 4 == 0 && reinterpret_cast<uintptr_t>(msg) % quad_bytes == 0;
  if (dtype == 0) {
    err = quads ? launch<float, 4>(msg, recv, out, v, h, n_edges, device, s)
                : launch<float, 1>(msg, recv, out, v, h, n_edges, device, s);
  } else {
    err = quads ? launch<__nv_bfloat16, 4>(msg, recv, out, v, h, n_edges,
                                           device, s)
                : launch<__nv_bfloat16, 1>(msg, recv, out, v, h, n_edges,
                                           device, s);
  }
  return static_cast<int>(err);
}
