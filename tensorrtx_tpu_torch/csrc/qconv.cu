// Int8-resident conv with a fused requant epilogue for Hopper (sm_90a):
// 3x3 (stride 1 or 2) and 1x1, int8 NHWC in, int8 NHWC or float out.
//
// Replaces the TPU kernels tensorrtx_tpu/ops/pallas/qconv.py::qconv3x3 and
// ::qconv1x1, and the XLA form of the same contract in
// tensorrtx_tpu/ops/qchain.py (ChainCtx.conv / conv_add / conv_out), which
// the JAX package uses for every shape its Pallas gate refuses. Per output
// element (b, oy, ox, co):
//
//   acc = sum over taps (ky, kx) and channels c of x[b, iy, ix, c] * w[co, ky, kx, c]
//         (int32, exact; iy = oy*stride + ky - k/2, zero outside the map)
//   o   = (float)acc * scale[co] + bias[co]          (scale = s_in * s_w)
//   o  += (float)res[b, oy, ox, co] * res_scale      (conv+add fusion)
//   o   = act(o)                                     (SiLU o*(1/(1+e^-o)), ReLU, none)
//   out = clip(rint(o / s_out), -127, 127) as int8, or o as float32 / bf16
//
// Every product, sum and quotient of the epilogue is rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, and -fmad=false at build), and rintf
// rounds half to even as jnp.round and torch.round do, so the output is the
// plain version's up to the last bit of expf in SiLU.
//
// What bounds it: at YOLO11n-640 the maps are small (80x80 and below,
// C <= 512). The int8 MACs of one forward (about 2.3 G per image) over the
// 1,979 TOP/s dense int8 peak take ~2.3 us per image; its activations and
// weights (a few MB per image) over 3.35 TB/s take about as long, so most
// convs are bound by bytes, and at batch 1 by the launch itself.
//
// Design (simple and right first): an implicit GEMM with M = output pixels
// (B*Ho*Wo, flattened over the batch), N = output channels, K = taps x C.
// A block of 256 threads owns a 64-pixel x 64-channel output tile. For each
// tap and each 32-channel slice of C it stages the 64 input rows (zero where
// the tap falls in the padding) and the 64 weight rows (OHWI) in shared
// memory as 32-bit words of four int8 values; each thread accumulates a 4x4
// sub-tile with __dp4a. A channel count that is not a multiple of 32 is
// zero-filled in the last slice, and one that is not a multiple of 4 (or an
// unaligned pointer) is read byte by byte. Tensor cores (int8 mma.sync or
// wgmma) and TMA are left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kKW = 8;        // 32-bit words per K slice (32 int8 channels)
constexpr int kLd = kKW + 1;  // padded shared-memory row (bank spread)
constexpr int kThreads = 256;
constexpr int kLoads = kBM * kKW / kThreads;  // words each thread stages

enum Act { kActNone = 0, kActSilu = 1, kActRelu = 2 };
enum OutKind { kOutInt8 = 0, kOutF32 = 1, kOutBf16 = 2 };

// Four int8 channels [c, c+4) of one row as a word; channels >= C are 0.
__device__ __forceinline__ int load_word(const int8_t* row, int c, int C, bool vec) {
  if (vec) return c < C ? *reinterpret_cast<const int*>(row + c) : 0;
  uint32_t v = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (c + t < C) v |= static_cast<uint32_t>(static_cast<uint8_t>(row[c + t])) << (8 * t);
  }
  return static_cast<int>(v);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
qconv_kernel(const int8_t* __restrict__ x,       // (B, H, W, C)
             const int8_t* __restrict__ w,       // (Co, K, K, C)
             const float* __restrict__ scale,    // (Co,)
             const float* __restrict__ bias,     // (Co,) or null
             const float* __restrict__ s_out,    // scalar, int8 output only
             const int8_t* __restrict__ res,     // (B, Ho, Wo, Co) or null
             const float* __restrict__ res_scale,
             void* __restrict__ out,             // (B, Ho, Wo, Co)
             int out_kind, int act, int H, int W, int C, int Co, int Ho,
             int Wo, int stride, int M, int vec) {
  __shared__ int As[kBM][kLd];
  __shared__ int Bs[kBN][kLd];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int pad = K / 2;
  const bool v4 = vec != 0;

  // the rows this thread stages: pixel (b, oy, ox) and output channel
  int ld_b[kLoads], ld_oy[kLoads], ld_ox[kLoads], ld_co[kLoads], ld_wd[kLoads];
  bool ld_pm[kLoads];
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int idx = tid + r * kThreads;
    const int row = idx / kKW;
    ld_wd[r] = idx % kKW;
    const int m = m0 + row;
    ld_pm[r] = m < M;
    const int mm = ld_pm[r] ? m : 0;
    ld_ox[r] = mm % Wo;
    ld_oy[r] = (mm / Wo) % Ho;
    ld_b[r] = mm / (Wo * Ho);
    ld_co[r] = n0 + row;
  }

  const int tx = tid % 16;  // output channels tx + 16j
  const int ty = tid / 16;  // output pixels ty + 16i
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int tap = 0; tap < K * K; ++tap) {
    const int ky = tap / K, kx = tap % K;
    for (int c0 = 0; c0 < C; c0 += 4 * kKW) {
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int row = (tid + r * kThreads) / kKW;
        const int c = c0 + 4 * ld_wd[r];
        int a = 0;
        if (ld_pm[r]) {
          const int iy = ld_oy[r] * stride + ky - pad;
          const int ix = ld_ox[r] * stride + kx - pad;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
            const int8_t* p = x + ((static_cast<size_t>(ld_b[r]) * H + iy) * W + ix) * C;
            a = load_word(p, c, C, v4);
          }
        }
        As[row][ld_wd[r]] = a;
        int bw = 0;
        if (ld_co[r] < Co) {
          const int8_t* p = w + (static_cast<size_t>(ld_co[r]) * K * K + tap) * C;
          bw = load_word(p, c, C, v4);
        }
        Bs[row][ld_wd[r]] = bw;
      }
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < kKW; ++kw) {
        int av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[ty + 16 * i][kw];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[tx + 16 * j][kw];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const float so = out_kind == kOutInt8 ? *s_out : 1.0f;
  const float rs = res != nullptr ? *res_scale : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx + 16 * j;
      if (co >= Co) continue;
      const size_t o_idx = static_cast<size_t>(m) * Co + co;
      float o = __fmul_rn(__int2float_rn(acc[i][j]), scale[co]);
      if (bias != nullptr) o = __fadd_rn(o, bias[co]);
      if (res != nullptr) o = __fadd_rn(o, __fmul_rn(static_cast<float>(res[o_idx]), rs));
      if (act == kActSilu) {
        o = __fmul_rn(o, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-o))));
      } else if (act == kActRelu) {
        o = fmaxf(o, 0.0f);
      }
      if (out_kind == kOutInt8) {
        const float q = fminf(fmaxf(rintf(__fdiv_rn(o, so)), -127.0f), 127.0f);
        static_cast<int8_t*>(out)[o_idx] = static_cast<int8_t>(q);
      } else if (out_kind == kOutF32) {
        static_cast<float*>(out)[o_idx] = o;
      } else {
        static_cast<__nv_bfloat16*>(out)[o_idx] = __float2bfloat16_rn(o);
      }
    }
  }
}

template <int K>
int launch(const int8_t* x, const int8_t* w, const float* scale, const float* bias,
           const float* s_out, const int8_t* res, const float* res_scale, void* out,
           int out_kind, int act, int B, int H, int W, int C, int Co, int stride,
           int vec, void* stream) {
  const int pad = K / 2;
  const int Ho = (H + 2 * pad - K) / stride + 1;
  const int Wo = (W + 2 * pad - K) / stride + 1;
  const int M = B * Ho * Wo;
  if (M <= 0 || Co <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((M + kBM - 1) / kBM, (Co + kBN - 1) / kBN);
  qconv_kernel<K><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, scale, bias, s_out, res, res_scale, out, out_kind, act, H, W, C, Co,
      Ho, Wo, stride, M, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError(); the caller
// allocates `out` and checks the code. out_kind: 0 int8, 1 float32,
// 2 bfloat16. act: 0 none, 1 SiLU, 2 ReLU. bias and res may be null; s_out
// and res_scale point at one float on the device. vec != 0 promises that
// C % 4 == 0 and that x and w are 4-byte aligned.
extern "C" int qconv3x3_launch(const int8_t* x, const int8_t* w, const float* scale,
                               const float* bias, const float* s_out,
                               const int8_t* res, const float* res_scale, void* out,
                               int out_kind, int act, int B, int H, int W, int C,
                               int Co, int stride, int vec, void* stream) {
  return launch<3>(x, w, scale, bias, s_out, res, res_scale, out, out_kind, act, B, H,
                   W, C, Co, stride, vec, stream);
}

extern "C" int qconv1x1_launch(const int8_t* x, const int8_t* w, const float* scale,
                               const float* bias, const float* s_out,
                               const int8_t* res, const float* res_scale, void* out,
                               int out_kind, int act, int B, int H, int W, int C,
                               int Co, int vec, void* stream) {
  return launch<1>(x, w, scale, bias, s_out, res, res_scale, out, out_kind, act, B, H,
                   W, C, Co, 1, vec, stream);
}
