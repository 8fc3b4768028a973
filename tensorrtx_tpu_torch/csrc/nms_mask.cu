// One-pass NMS keep mask for Hopper (sm_90a).
//
// Replaces the TPU kernel tensorrtx_tpu/ops/pallas/nms_pallas.py::
// nms_mask_pallas (body _nms_kernel), itself a reformulation of the
// reference's yolo11/src/postprocess.cu:89-111. For each candidate i of an
// image, i is killed if a valid same-class candidate j of higher priority
// (score_j > score_i, or equal score and j < i) overlaps it with
// IoU > thresh; keep_i = score_i > 0 && !killed.
//
// What bounds it: at the main path's N = max_det = 300 an image is 90k pairs
// of ~20 flops, so one launch is a few microseconds of work and the kernel
// is bound by launch latency, not by bytes or flops. The design is the
// simple one: one block per (image, 128-row tile); the block stages the
// image's N candidates in shared memory as structure-of-arrays (6 planes,
// 7.2 KB at N = 300), and each thread owns one row i and walks j in [0, N),
// stopping at the first killer. The N x N IoU matrix never exists.
//
// Bit-exactness: the IoU keeps the Pallas kernel's operation order
// (nms_pallas.py:38-56), and every product, sum and quotient is rounded on
// its own (__fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, plus -fmad=false at
// build), so no multiply-add is contracted into an FMA and the mask is
// bit-equal to the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowTile = 128;

__global__ void __launch_bounds__(kRowTile)
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
  }
  __syncthreads();

  const int i = blockIdx.x * kRowTile + threadIdx.x;
  if (i >= n) return;
  const float x1 = sx1[i], y1 = sy1[i], x2 = sx2[i], y2 = sy2[i];
  const float si = ssc[i], ci = scl[i];
  const float area_i = __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f),
                                 fmaxf(__fsub_rn(y2, y1), 0.0f));
  bool killed = false;
  if (si > 0.0f) {
    for (int j = 0; j < n; ++j) {
      const float sj = ssc[j];
      if (!(sj > 0.0f) || scl[j] != ci) continue;
      if (!(sj > si || (sj == si && j < i))) continue;
      const float il = fmaxf(x1, sx1[j]);
      const float it = fmaxf(y1, sy1[j]);
      const float ir = fminf(x2, sx2[j]);
      const float ib = fminf(y2, sy2[j]);
      const float inter = __fmul_rn(fmaxf(__fsub_rn(ir, il), 0.0f),
                                    fmaxf(__fsub_rn(ib, it), 0.0f));
      const float area_j = __fmul_rn(fmaxf(__fsub_rn(sx2[j], sx1[j]), 0.0f),
                                     fmaxf(__fsub_rn(sy2[j], sy1[j]), 0.0f));
      const float uni = __fsub_rn(__fadd_rn(area_i, area_j), inter);
      const float iou = inter > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
      if (iou > thresh) {
        killed = true;
        break;
      }
    }
  }
  keep[static_cast<size_t>(b) * n + i] = (si > 0.0f && !killed) ? 1 : 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); the caller allocates
// `keep` and checks the code. boxes must be 16-byte aligned (a contiguous
// float32 (B, N, 4) tensor from the caching allocator is).
extern "C" int nms_mask_launch(const float* boxes, const float* scores,
                               const float* classes, uint8_t* keep, int batch,
                               int n, float thresh, void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kRowTile - 1) / kRowTile, batch);
  const size_t smem = 6 * static_cast<size_t>(n) * sizeof(float);
  nms_mask_kernel<<<grid, kRowTile, smem, static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, classes, keep, n, thresh);
  return static_cast<int>(cudaGetLastError());
}
