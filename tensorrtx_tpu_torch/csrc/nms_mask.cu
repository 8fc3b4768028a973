// One-pass NMS keep mask for Hopper (sm_90a).
//
// Replaces the TPU kernel tensorrtx_tpu/ops/pallas/nms_pallas.py::
// nms_mask_pallas (body _nms_kernel), itself a reformulation of the
// reference's yolo11/src/postprocess.cu:89-111. For each candidate i of an
// image, i is killed if a valid same-class candidate j of higher priority
// (score_j > score_i, or equal score and j < i) overlaps it with
// IoU > thresh; keep_i = score_i > 0 && !killed.
//
// What bounds it: at the main path's N = max_det = 300 an image is at most
// 90k IoU tests of ~18 flops, a bound of microseconds (by operations) that
// no launch reaches; what a launch takes is the length of its longest
// dependent chain. The first design (one thread per row walking j = 0..N-1
// one candidate at a time, 3 blocks at B = 1) measured 0.047-0.049 ms at
// both B = 1 and B = 32 on an H100: up to 300 dependent steps, each ending
// in an IEEE division, with almost all of the card idle.
//
// Design: a warp per row. The block (kWarps rows of one image) stages the
// image's N candidates in shared memory as structure-of-arrays, 7 planes
// (x1, y1, x2, y2, score, class and the box area, computed once here in the
// IoU's own operation order): 8.4 KB at N = 300, 57 KB at MAX_N = 2048,
// above the 48 KB default, so the kernel opts in to more dynamic shared
// memory once per device. At step t lane l tests candidate j = 32 t + l,
// and the warp stops at the first step in which any lane kills row i
// (__any_sync): at most ceil(N / 32) = 10 dependent steps at N = 300. A
// row with score <= 0 writes 0 and walks nothing. The grid is
// (ceil(N / kWarps), B): 38 blocks at B = 1, so the work spreads over the
// card's SMs. The N x N IoU matrix never exists.
//
// Bit-exactness: the IoU keeps the Pallas kernel's operation order
// (nms_pallas.py:38-56), and every product, sum and quotient is rounded on
// its own (__fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, plus -fmad=false at
// build), so no multiply-add is contracted into an FMA and the mask is
// bit-equal to the plain version's. Which j kills row i does not change the
// mask, so the warp may stop at any killer; every j is tested for priority,
// so the input need not be sorted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // rows per block, one warp each
constexpr int kMaxN = 2048;        // ops/cuda/nms_mask.py MAX_N
constexpr int kPlanes = 7;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f), fmaxf(__fsub_rn(y2, y1), 0.0f));
}

__global__ void __launch_bounds__(kWarps * 32)
nms_mask_kernel(const float* __restrict__ boxes,    // (B, N, 4) xyxy
                const float* __restrict__ scores,   // (B, N), invalid <= 0
                const float* __restrict__ classes,  // (B, N)
                uint8_t* __restrict__ keep,         // (B, N)
                int n, float thresh) {
  extern __shared__ float smem[];
  float* sx1 = smem;
  float* sy1 = sx1 + n;
  float* sx2 = sy1 + n;
  float* sy2 = sx2 + n;
  float* ssc = sy2 + n;
  float* scl = ssc + n;
  float* sar = scl + n;

  const int b = blockIdx.y;
  const float* bx = boxes + static_cast<size_t>(b) * n * 4;
  const float* sc = scores + static_cast<size_t>(b) * n;
  const float* cl = classes + static_cast<size_t>(b) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(bx)[j];
    sx1[j] = v.x;
    sy1[j] = v.y;
    sx2[j] = v.z;
    sy2[j] = v.w;
    ssc[j] = sc[j];
    scl[j] = cl[j];
    sar[j] = box_area(v.x, v.y, v.z, v.w);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;                       // the whole warp: i is the warp's row
  const float si = ssc[i];
  bool killed = false;
  if (si > 0.0f) {                          // warp-uniform
    const float x1 = sx1[i], y1 = sy1[i], x2 = sx2[i], y2 = sy2[i];
    const float ci = scl[i], area_i = sar[i];
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      bool kills = false;
      if (j < n) {
        const float sj = ssc[j];
        if (sj > 0.0f && scl[j] == ci && (sj > si || (sj == si && j < i))) {
          const float il = fmaxf(x1, sx1[j]);
          const float it = fmaxf(y1, sy1[j]);
          const float ir = fminf(x2, sx2[j]);
          const float ib = fminf(y2, sy2[j]);
          const float inter = __fmul_rn(fmaxf(__fsub_rn(ir, il), 0.0f),
                                        fmaxf(__fsub_rn(ib, it), 0.0f));
          const float uni = __fsub_rn(__fadd_rn(area_i, sar[j]), inter);
          const float iou = inter > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
          kills = iou > thresh;
        }
      }
      if (__any_sync(0xffffffffu, kills)) {
        killed = true;
        break;
      }
    }
  }
  if (lane == 0) keep[static_cast<size_t>(b) * n + i] = (si > 0.0f && !killed) ? 1 : 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); the caller allocates
// `keep` and checks the code. boxes must be 16-byte aligned (a contiguous
// float32 (B, N, 4) tensor from the caching allocator is); N <= 2048.
extern "C" int nms_mask_launch(const float* boxes, const float* scores,
                               const float* classes, uint8_t* keep, int batch,
                               int n, float thresh, void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kPlanes * static_cast<size_t>(n) * sizeof(float);
  if (smem > 48 * 1024) {
    // the opt-in above the 48 KB default holds per device, once
    static bool opted[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!opted[dev]) {
      err = cudaFuncSetAttribute(nms_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kPlanes * kMaxN * static_cast<int>(sizeof(float)));
      if (err != cudaSuccess) return static_cast<int>(err);
      opted[dev] = true;
    }
  }
  const dim3 grid((n + kWarps - 1) / kWarps, batch);
  nms_mask_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, classes, keep, n, thresh);
  return static_cast<int>(cudaGetLastError());
}
