// Keypoint patch gather (P1) and BRIEF sample gather (P2) of the ORB
// extractor, for sm_90a.
//
// P1 replaces the TPU kernel profile_patch.py::make_pallas_patches (body
// _dma_kernel): per keypoint (level, y, x), the 32x32 window of the blurred
// [L, H, W] level stack around it, written as [N, 32, 32] float32. The start
// is clamped into the stack as lax.dynamic_slice clamps it,
// y0 = clamp(y - 15, 0, H - 32) and x0 = clamp(x - 15, 0, W - 32), so a
// keypoint anywhere (padding lanes included) reads in bounds; the level is
// clamped to [0, L) the same way.
//
// P2 replaces profile_patch.py::pallas_take (body _gather_kernel): per
// keypoint, the 512 BRIEF sample intensities take_along_axis(patch[1024],
// table[abin]) of its flattened patch, where abin is the keypoint's
// orientation bin and table [64, 512] the rotated sample offsets. The table
// lookup happens inside the kernel (no [N, 512] index tensor is built), and
// each sample is rounded to bf16 on its store, as the extractor rounds the
// sampled intensities (round-to-nearest-even, returned as float32).
//
// What bounds them on an H100: both are pure data movement. P1 at N = 1024
// reads 4 MiB of windows and writes 4 MiB (~8.4 MB, ~2.5 us at 3.35 TB/s);
// P2 reads the 4 MiB of patches plus 128 KiB of table and writes 2 MiB
// (~6.4 MB, ~1.9 us). At these sizes one launch costs about as much as the
// copy itself. The design keeps every global access coalesced: in P1 a warp
// copies one 32-float row of a window (one 128-byte read, one 128-byte
// write); in P2 a block stages its 4 KiB patch in shared memory with
// coalesced loads and its threads gather from there, so the random sample
// pattern never touches device memory.
//
// Entry points: plain C functions, launched on the caller's stream, with no
// synchronisation and no allocation. Each returns cudaGetLastError() after
// the launch (0 = success).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 32;             // window side
constexpr int kHalf = 15;              // window start = center - 15
constexpr int kPatchArea = kPatch * kPatch;
constexpr int kSampleThreads = 256;

// One block of 32 x 32 threads per keypoint: warp r copies row r.
__global__ void __launch_bounds__(kPatch * kPatch)
patch_gather_kernel(const float* __restrict__ stack, const int32_t* __restrict__ kps,
                    float* __restrict__ out, int L, int H, int W) {
  const int n = blockIdx.x;
  const int c = threadIdx.x;
  const int r = threadIdx.y;
  const int lvl = min(max(kps[3 * n + 0], 0), L - 1);
  const int y0 = min(max(kps[3 * n + 1] - kHalf, 0), H - kPatch);
  const int x0 = min(max(kps[3 * n + 2] - kHalf, 0), W - kPatch);
  const int64_t src = (static_cast<int64_t>(lvl) * H + (y0 + r)) * W + (x0 + c);
  out[static_cast<int64_t>(n) * kPatchArea + r * kPatch + c] = stack[src];
}

// One block per keypoint: stage the patch, gather S samples from it.
__global__ void __launch_bounds__(kSampleThreads)
sample_gather_kernel(const float* __restrict__ patches, const int32_t* __restrict__ abin,
                     const int32_t* __restrict__ table, float* __restrict__ out, int S) {
  __shared__ float patch[kPatchArea];
  const int n = blockIdx.x;
  const float* row = patches + static_cast<int64_t>(n) * kPatchArea;
  for (int i = threadIdx.x; i < kPatchArea; i += kSampleThreads) patch[i] = row[i];
  __syncthreads();
  const int32_t* offsets = table + static_cast<int64_t>(abin[n]) * S;
  float* dst = out + static_cast<int64_t>(n) * S;
  for (int s = threadIdx.x; s < S; s += kSampleThreads) {
    dst[s] = __bfloat162float(__float2bfloat16_rn(patch[offsets[s]]));
  }
}

}  // namespace

extern "C" int patch_gather_launch(const void* stack, const void* kps, void* out, int n,
                                   int L, int H, int W, void* stream) {
  if (n <= 0) return 0;
  patch_gather_kernel<<<n, dim3(kPatch, kPatch), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stack), static_cast<const int32_t*>(kps),
      static_cast<float*>(out), L, H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sample_gather_launch(const void* patches, const void* abin, const void* table,
                                    void* out, int n, int S, void* stream) {
  if (n <= 0) return 0;
  sample_gather_kernel<<<n, kSampleThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(patches), static_cast<const int32_t*>(abin),
      static_cast<const int32_t*>(table), static_cast<float*>(out), S);
  return static_cast<int>(cudaGetLastError());
}
