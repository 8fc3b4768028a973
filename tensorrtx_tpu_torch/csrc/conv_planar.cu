// Float direct convolutions on the planar (B, H, C, W) layout for Hopper
// (sm_90a): 3x3 stride-1 SAME and 1x1, fused bias, activation and residual.
//
// Replaces the TPU kernels tensorrtx_tpu/ops/pallas/conv_planar.py::
// conv3x3_planar (conv_planar_kernel<T, 3>) and ::conv1x1_planar
// (conv1x1_planar_kernel<T>). Per output element (b, y, co, x):
//
//   o   = bias[co] + sum over taps (ky, kx) and channels c of
//         w[ky, kx, c, co] * in[b, y + ky - K/2, c, x + kx - K/2]   (float32; zero outside the map)
//   o   = act(o)                       (SiLU o*(1/(1+e^-o)), ReLU, none)
//   o  += res[b, y, co, x]             (residual added AFTER the activation)
//   out = o in the input's dtype (float32 or bf16)
//
// Weights are HWIO (K, K, C, Co) float32, as the JAX package passes them.
// The sums run in float32 in each kernel's own order with fused
// multiply-adds, so they equal the plain version (a float32 cuDNN
// convolution) within float32 rounding, not bit for bit.
//
// 3x3. What bounds it: at the shapes it is held on (C <= 48, Co <= 64,
// W = 160 or 640) an output element costs 9C multiply-adds and 4-6 bytes
// of traffic, so most launches sit near the line between bytes and the 67
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
//
// 1x1. Each image row is a (Co, C) x (C, W) product. What bounds it: at the
// held shapes, (160, 32, 160) -> 32 with SiLU and (160, 48, 160) -> 64 with
// a residual, B = 32 moves 786 MB in float32 (0.235 ms at 3.35 TB/s) and
// 393 MB in bf16 (0.117 ms) for 6.7 GFLOP (0.100 ms at 67 TFLOP/s): float32
// is bound by bytes, bf16 sits on the line between bytes and FMAs. The
// first design ran the 3x3 template with K = 1 and took 7-9x its bound:
// threads idle on the column tile past W = 160, each input row read again
// for each 16-channel tile, element-wise staging, two barriers per 16
// channels, and the residual read from device memory in the epilogue with
// nothing to overlap it.
//
// Design (conv1x1_planar_kernel): one block per (run of R consecutive rows,
// tile of up to 64 output channels, tile of columns), with R set so that
// the grid is one wave of the blocks the card holds at once. Co is split
// only above 64 channels and W only where the block's threads (512 in
// float32, 320 in bf16) cannot cover it at 4 columns each, so at the held
// shapes each input row is read from device memory once. The block stages
// its weights (C x Co tile floats, 12 KB at C = 48, Co = 64) and bias in
// shared memory once, then streams its rows through a double buffer:
// 16-byte cp.async pieces of row r + 1 and of its residual rows arrive
// while row r is computed, with one barrier a row (at most 32 KB of input
// channels a stage; more channels take several stages with their weight
// slices). Each thread owns a register tile of 4 columns x 8 output
// channels: per input channel one 16-byte (float32) or 8-byte (bf16) read
// of its columns and two float4 weight broadcasts feed 32 FMAs. Threads map
// column groups first, so W = 160 with Co = 64 is 40 x 8 = 320 threads and
// none idle. The epilogue takes the residual from shared memory and writes
// the output 4 columns at a time. bf16 caps the registers so that two
// blocks share an SM (one block's epilogue and barrier overlap the other's
// FMAs); float32, whose double buffer with the residual fills most of the
// SM's shared memory, keeps more registers for the unrolled loop. A row that
// is not 16-byte aligned (W * itemsize % 16 != 0, or x or the residual
// misaligned) is staged element by element, and a ragged column group or an
// unaligned output is stored column by column. SiLU is
// __fdividef(o, 1 + __expf(-o)): no division slow path; its error is a few
// ulp plus __expf's (2 + 1.16|o| ulp of e^-o), under 1e-5 relative for
// |o| < 64 and far inside the 1e-4 tolerance. Tensor cores stay out: the
// contract sums float32 weights in float32, TF32's 10-bit mantissa misses
// the 1e-4 float32 bar, and float32 is bound by bytes.

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

// ---------------------------------------------------------------------------
// 1x1
// ---------------------------------------------------------------------------

constexpr int kStageBytes = 32 * 1024;     // input bytes of one stage at most
constexpr int kWeightBytes = 16 * 1024;    // weight bytes of one stage at most
constexpr int kMaxDevices = 64;

// Threads of a block at most, and blocks an SM must hold at once (which
// caps the registers): bf16 runs two blocks an SM of at most 320 threads
// and 102 registers, float32 one of up to 512 threads with 128 registers.
template <typename T> struct Block1x1 { static constexpr int kThreads = 512, kMinBlocks = 1; };
template <> struct Block1x1<__nv_bfloat16> { static constexpr int kThreads = 320, kMinBlocks = 2; };

struct Geom1x1 {
  int rows;            // B * H
  int C, W, Co, act;
  int rows_per_block;  // R: the block's run of consecutive rows
  int cot;             // output channels per block, a multiple of 8
  int wt;              // columns per block, a multiple of 8
  int cc;              // input channels per stage
  int nch;             // stages per row, ceil(C / cc) and at least 1
  int vec_in;          // x and the residual staged by 16-byte cp.async pieces
  int vec_out;         // output written 4 columns at a time
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 4 consecutive values: 16-byte aligned float32, 8-byte aligned bf16
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float act1(float o, int act) {
  if (act == kActSilu) return __fdividef(o, 1.0f + __expf(-o));
  if (act == kActRelu) return fmaxf(o, 0.0f);
  return o;
}

template <typename T>
__global__ void __launch_bounds__(Block1x1<T>::kThreads, Block1x1<T>::kMinBlocks)
conv1x1_planar_kernel(const T* __restrict__ x,         // (B, H, C, W)
                      const float* __restrict__ w,     // (C, Co)
                      const float* __restrict__ bias,  // (Co,) or null
                      const T* __restrict__ res,       // (B, H, Co, W) or null
                      T* __restrict__ out,             // (B, H, Co, W)
                      const Geom1x1 g) {
  extern __shared__ __align__(16) unsigned char smem1[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int co0 = blockIdx.y * g.cot;
  const int con = min(g.cot, g.Co - co0);       // this block's output channels
  const int w0 = blockIdx.z * g.wt;
  const int wt = min(g.wt, g.W - w0);           // this block's columns
  const int row0 = blockIdx.x * g.rows_per_block;
  const int nrows = min(g.rows_per_block, g.rows - row0);
  const bool one_slice = g.nch == 1;            // all of C in one stage: weights staged once
  const int xstage = g.cc * g.wt, wstage = g.cc * g.cot, rstage = g.cot * g.wt;
  float* bs = reinterpret_cast<float*>(smem1);                            // [cot]
  float* ws = bs + g.cot;                                                 // [C][cot] or [2][cc][cot]
  T* xs = reinterpret_cast<T*>(ws + (one_slice ? g.C : 2 * g.cc) * g.cot);  // [2][cc][wt]
  T* rs = xs + 2 * xstage;                                                // [2][cot][wt]

  // weights of channels [c0, c0 + cn) for the block's output channels, 0 past Co
  auto stage_w = [&](float* dst, int c0, int cn) {
    for (int i = tid; i < cn * g.cot; i += nt) {
      const int c = i / g.cot, j = i - c * g.cot;
      if (j < con) cp_async4(dst + i, w + static_cast<size_t>(c0 + c) * g.Co + co0 + j);
      else dst[i] = 0.0f;
    }
  };
  // n rows of the block's columns, g.W apart in src, g.wt apart in dst
  auto stage_rows = [&](T* dst, const T* src, int n) {
    if (g.vec_in) {
      constexpr int kPer = 16 / sizeof(T);
      const int pieces = wt / kPer;
      for (int i = tid; i < n * pieces; i += nt) {
        const int c = i / pieces, p = i - c * pieces;
        cp_async16(dst + c * g.wt + p * kPer, src + static_cast<size_t>(c) * g.W + p * kPer);
      }
    } else {
      for (int i = tid; i < n * wt; i += nt) {
        const int c = i / wt, col = i - c * wt;
        dst[c * g.wt + col] = src[static_cast<size_t>(c) * g.W + col];
      }
    }
  };
  // stage s (row s / nch, channel slice s % nch) into buffer s & 1; the
  // residual row comes with the row's last slice
  const int stages = nrows * g.nch;
  auto load_stage = [&](int s) {
    const int r = s / g.nch, ch = s - r * g.nch, c0 = ch * g.cc;
    const int cn = min(g.cc, g.C - c0);
    stage_rows(xs + (s & 1) * xstage, x + (static_cast<size_t>(row0 + r) * g.C + c0) * g.W + w0, cn);
    if (!one_slice) stage_w(ws + (s & 1) * wstage, c0, cn);
    if (res != nullptr && ch == g.nch - 1)
      stage_rows(rs + (s & 1) * rstage, res + (static_cast<size_t>(row0 + r) * g.Co + co0) * g.W + w0,
                 con);
    cp_async_commit();
  };

  for (int i = tid; i < g.cot; i += nt) bs[i] = bias != nullptr && i < con ? bias[co0 + i] : 0.0f;
  if (one_slice) stage_w(ws, 0, g.C);           // with stage 0's group
  load_stage(0);

  // thread -> 4 columns (column groups first, so a warp reads one row run) x 8 channels
  const int ng = g.wt / 4;
  const bool active = tid < ng * (g.cot / 8);
  const int col = 4 * (tid % ng);
  const int q8 = 8 * (tid / ng);
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  for (int s = 0; s < stages; ++s) {
    cp_async_wait_all();       // this thread's pieces of stage s have landed
    __syncthreads();           // everyone's have, and buffer (s + 1) & 1 is free
    if (s + 1 < stages) load_stage(s + 1);
    const int r = s / g.nch, ch = s - r * g.nch;
    const int cn = min(g.cc, g.C - ch * g.cc);
    if (!active) continue;
    const T* xb = xs + (s & 1) * xstage + col;
    const float* wb = (one_slice ? ws : ws + (s & 1) * wstage) + q8;
#pragma unroll 4
    for (int c = 0; c < cn; ++c) {
      const float4 v = load4(xb + c * g.wt);
      const float4 wa = load4(wb + c * g.cot);
      const float4 wc = load4(wb + c * g.cot + 4);
      const float xv[4] = {v.x, v.y, v.z, v.w};
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wc.x, wc.y, wc.z, wc.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(wv[j], xv[i], acc[j][i]);
    }
    if (ch + 1 < g.nch) continue;
    if (col < wt) {
      const size_t base = (static_cast<size_t>(row0 + r) * g.Co + co0) * g.W + w0 + col;
      const T* rb = rs + (s & 1) * rstage + col;
      const bool full = g.vec_out && col + 4 <= wt;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = q8 + j;
        if (cl >= con) continue;   // no break: the loop must unroll, acc stay in registers
        const float bj = bs[cl];
        float4 v = make_float4(act1(acc[j][0] + bj, g.act), act1(acc[j][1] + bj, g.act),
                               act1(acc[j][2] + bj, g.act), act1(acc[j][3] + bj, g.act));
        if (res != nullptr) {
          const float4 rv = load4(rb + cl * g.wt);
          v.x += rv.x;
          v.y += rv.y;
          v.z += rv.z;
          v.w += rv.w;
        }
        T* o = out + base + static_cast<size_t>(cl) * g.W;
        if (full) {
          store4(o, v);
        } else {
          const float ov[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (col + i < wt) store(o + i, ov[i]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }
int round_up(int a, int b) { return ceil_div(a, b) * b; }
bool aligned(const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// The 1x1 of element type T: Co in tiles of <= 64 channels, W in tiles the
// block's threads cover at 4 columns each, and rows in runs so that the
// grid is one wave of the blocks the current device holds at once.
template <typename T>
int launch_1x1(const void* x, const float* w, const float* bias, const void* res, void* out,
               int act, int B, int H, int C, int W, int Co, cudaStream_t stream) {
  // per device: the SM count, and the kernel's opt-in there to shared
  // memory above the 48 KB default
  static int sms[kMaxDevices];
  static bool opted[kMaxDevices];
  const void* fn = reinterpret_cast<const void*>(conv1x1_planar_kernel<T>);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }

  Geom1x1 g;
  g.rows = B * H;
  g.C = C;
  g.W = W;
  g.Co = Co;
  g.act = act;
  constexpr int isz = static_cast<int>(sizeof(T));
  const int co_tiles = ceil_div(Co, 64);
  g.cot = round_up(ceil_div(Co, co_tiles), 8);
  const int max_groups = (Block1x1<T>::kThreads / (g.cot / 8)) & ~1;   // 4-column groups per block
  const int w_tiles = ceil_div(ceil_div(W, 4), max_groups);
  g.wt = round_up(ceil_div(W, w_tiles), 8);
  g.cc = max(1, min(C, min(kStageBytes / (g.wt * isz), kWeightBytes / (g.cot * 4))));
  g.nch = C > 0 ? ceil_div(C, g.cc) : 1;
  g.vec_in = aligned(x, 16) && (res == nullptr || aligned(res, 16)) && (W * isz) % 16 == 0;
  g.vec_out = W % 4 == 0 && aligned(out, 4 * isz);
  const int threads = round_up(g.wt / 4 * (g.cot / 8), 32);
  const int stage = g.cc * g.wt * isz + (g.nch == 1 ? 0 : 4 * g.cc * g.cot) +
                    (res != nullptr ? g.cot * g.wt * isz : 0);
  const int smem = 4 * g.cot + (g.nch == 1 ? 4 * C * g.cot : 0) + 2 * stage;

  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(sms[dev]) * max(per_sm, 1);
  const long long row_blocks = max(1LL, blocks / (co_tiles * w_tiles));
  g.rows_per_block = static_cast<int>((g.rows + row_blocks - 1) / row_blocks);
  const dim3 grid(ceil_div(g.rows, g.rows_per_block), co_tiles, w_tiles);
  conv1x1_planar_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), w, bias, static_cast<const T*>(res), static_cast<T*>(out), g);
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
  return kind == kF32 ? launch_1x1<float>(x, w, bias, res, out, act, B, H, C, W, Co, st)
                      : launch_1x1<__nv_bfloat16>(x, w, bias, res, out, act, B, H, C, W, Co, st);
}
