// Float direct convolutions on the planar (B, H, C, W) layout for Hopper
// (sm_90a): 3x3 stride-1 SAME and 1x1, fused bias, activation and residual.
//
// Replaces the TPU kernels tensorrtx_tpu/ops/pallas/conv_planar.py::
// conv3x3_planar and ::conv1x1_planar. Per output element (b, y, co, x):
//
//   o   = bias[co] + sum over taps (ky, kx) and channels c of
//         w[ky, kx, c, co] * in[b, y + ky - K/2, c, x + kx - K/2]   (float32; zero outside the map)
//   o   = act(o)                       (SiLU o*(1/(1+e^-o)), ReLU, none)
//   o  += res[b, y, co, x]             (residual added AFTER the activation)
//   out = o in the input's dtype (float32 or bf16)
//
// Weights are HWIO (K, K, C, Co) float32, as the JAX package passes them.
// The sum runs in float32 in this kernel's own order (channel chunk, then
// channel, then tap, with fused multiply-adds), so it equals the plain
// version (a float32 cuDNN convolution) within float32 rounding, not bit
// for bit.
//
// What bounds it: at the shapes it is held on (C <= 48, Co <= 64, W = 160
// or 640) a 3x3 output element costs 9C multiply-adds and 4-6 bytes of
// traffic, so most launches sit near the line between bytes and the 67
// TFLOP/s float32 (non-tensor-core) rate; the C = 3 stem shape is bound by
// its 16-channel output writes. Design (simple and right first): one block
// of 128 threads per (image row b*H + y, tile of 16 output channels, tile
// of 128 columns). For each chunk of 16 input channels the block stages
// the K input rows of those channels (128 + K - 1 columns, zero-padded) and
// the chunk's weights for its 16 output channels in static shared memory
// (34 KB for K = 3), then each thread owns one output column and
// accumulates 16 output channels in registers, reading the weights as
// float4 broadcasts. The JAX kernel's TPU-specific moves (lane rolls, row
// tiles sized to VMEM, the f32 scratch around 16-bit data) have no
// counterpart: threads along W read neighbouring addresses, and the halo
// is part of the staged tile. Tensor cores (TF32 or bf16 mma) are left to
// a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTW = 128;   // output columns per block (one per thread)
constexpr int kCoT = 16;   // output channels per block
constexpr int kCC = 16;    // input channels staged per chunk

enum Act { kActNone = 0, kActSilu = 1, kActRelu = 2 };
enum Kind { kF32 = 0, kBf16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, int K>
__global__ void __launch_bounds__(kTW)
conv_planar_kernel(const T* __restrict__ x,        // (B, H, C, W)
                   const float* __restrict__ w,    // (K, K, C, Co)
                   const float* __restrict__ bias, // (Co,) or null
                   const T* __restrict__ res,      // (B, H, Co, W) or null
                   T* __restrict__ out,            // (B, H, Co, W)
                   int act, int H, int C, int W, int Co) {
  constexpr int P = K / 2;
  constexpr int kCols = kTW + 2 * P;
  __shared__ float xs[K][kCC][kCols];
  __shared__ __align__(16) float ws[K * K][kCC][kCoT];

  const int row = blockIdx.x;            // b * H + y
  const int y = row % H;
  const int b = row / H;
  const int co0 = blockIdx.y * kCoT;
  const int w0 = blockIdx.z * kTW;
  const int tid = threadIdx.x;

  float acc[kCoT];
#pragma unroll
  for (int j = 0; j < kCoT; ++j) acc[j] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    const int cc = min(kCC, C - c0);
    for (int i = tid; i < K * kCC * kCols; i += kTW) {
      const int col = i % kCols;
      const int c = (i / kCols) % kCC;
      const int r = i / (kCols * kCC);
      const int iy = y + r - P;
      const int ix = w0 + col - P;
      float v = 0.0f;
      if (c < cc && iy >= 0 && iy < H && ix >= 0 && ix < W) {
        v = to_f(x[((static_cast<size_t>(b) * H + iy) * C + c0 + c) * W + ix]);
      }
      xs[r][c][col] = v;
    }
    for (int i = tid; i < K * K * kCC * kCoT; i += kTW) {
      const int j = i % kCoT;
      const int c = (i / kCoT) % kCC;
      const int t = i / (kCoT * kCC);
      float v = 0.0f;
      if (c < cc && co0 + j < Co) v = w[(static_cast<size_t>(t) * C + c0 + c) * Co + co0 + j];
      ws[t][c][j] = v;
    }
    __syncthreads();
    for (int c = 0; c < cc; ++c) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float v = xs[ky][c][tid + kx];
          const float4* wv = reinterpret_cast<const float4*>(&ws[ky * K + kx][c][0]);
#pragma unroll
          for (int q = 0; q < kCoT / 4; ++q) {
            const float4 wq = wv[q];
            acc[4 * q + 0] = fmaf(wq.x, v, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(wq.y, v, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(wq.z, v, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(wq.w, v, acc[4 * q + 3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int ox = w0 + tid;
  if (ox >= W) return;
#pragma unroll
  for (int j = 0; j < kCoT; ++j) {
    const int co = co0 + j;
    if (co >= Co) break;
    float o = acc[j];
    if (bias != nullptr) o = __fadd_rn(o, bias[co]);
    if (act == kActSilu) {
      o = __fmul_rn(o, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-o))));
    } else if (act == kActRelu) {
      o = fmaxf(o, 0.0f);
    }
    const size_t o_idx = ((static_cast<size_t>(row)) * Co + co) * W + ox;
    if (res != nullptr) o = __fadd_rn(o, to_f(res[o_idx]));
    store(out + o_idx, o);
  }
}

template <typename T, int K>
int launch(const void* x, const float* w, const float* bias, const void* res, void* out,
           int act, int B, int H, int C, int W, int Co, cudaStream_t stream) {
  const dim3 grid(B * H, (Co + kCoT - 1) / kCoT, (W + kTW - 1) / kTW);
  conv_planar_kernel<T, K><<<grid, kTW, 0, stream>>>(
      static_cast<const T*>(x), w, bias, static_cast<const T*>(res), static_cast<T*>(out),
      act, H, C, W, Co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); the caller allocates
// `out` and checks the code. k: 3 (SAME, stride 1) or 1. kind: 0 float32,
// 1 bf16 (x, res and out share it). act: 0 none, 1 SiLU, 2 ReLU. bias and
// res may be null. All tensors are contiguous.
extern "C" int conv_planar_launch(const void* x, const float* w, const float* bias,
                                  const void* res, void* out, int k, int kind, int act,
                                  int B, int H, int C, int W, int Co, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 3) {
    return kind == kF32 ? launch<float, 3>(x, w, bias, res, out, act, B, H, C, W, Co, st)
                        : launch<__nv_bfloat16, 3>(x, w, bias, res, out, act, B, H, C, W, Co, st);
  }
  return kind == kF32 ? launch<float, 1>(x, w, bias, res, out, act, B, H, C, W, Co, st)
                      : launch<__nv_bfloat16, 1>(x, w, bias, res, out, act, B, H, C, W, Co, st);
}
