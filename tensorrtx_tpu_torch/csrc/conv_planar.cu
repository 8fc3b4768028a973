// Float direct convolutions on the planar (B, H, C, W) layout for Hopper
// (sm_90a): 3x3 stride-1 SAME and 1x1, fused bias, activation and residual.
//
// Replaces the TPU kernels tensorrtx_tpu/ops/pallas/conv_planar.py::
// conv3x3_planar (conv3x3_planar_kernel<T, kMma>) and ::conv1x1_planar
// (conv1x1_planar_kernel<T>). Per output element (b, y, co, x):
//
//   o   = bias[co] + sum over taps (ky, kx) and channels c of
//         w[ky, kx, c, co] * in[b, y + ky - K/2, c, x + kx - K/2]   (float32; zero outside the map)
//   o   = act(o)                       (SiLU o*(1/(1+e^-o)), ReLU, none)
//   o  += res[b, y, co, x]             (residual added AFTER the activation)
//   out = o in the input's dtype (float32 or bf16)
//
// Weights are HWIO (K, K, C, Co) float32, as the JAX package passes them.
// The sums run in float32 in each kernel's own order, so they equal the
// plain version (a float32 cuDNN convolution) within float32 rounding, not
// bit for bit.
//
// 3x3. What bounds it, at B = 32 on the held shapes (bytes at 3.35 TB/s;
// FMAs at 67 TFLOP/s float32): the stem (640, 3, 640) -> 16 with SiLU
// moves 996 MB in float32 (0.297 ms) and 498 MB in bf16 (0.149) for 11.3
// GFLOP (0.169); (160, 16, 160) -> 8 with ReLU 79 / 39 MB (0.023 / 0.012)
// for 1.9 GFLOP (0.028); (160, 8, 160) -> 16 with SiLU and a residual
// 131 / 66 MB (0.039 / 0.020) for 1.9 GFLOP (0.028). So float32 is bound
// by bytes and the stem decides it; bf16 on the CUDA cores by FMAs, on
// the tensor cores by bytes.
//
// Both forms share the 1x1's structure with the halo rows: a block per
// (run of R rows of one image, tile of output channels, tile of columns)
// in one wave (R from the SM count and the blocks an SM holds), weights
// staged once, and a ring of 4 input rows of all C channels: while row y
// is computed from rows y - 1, y, y + 1, 16-byte cp.async pieces bring
// row y + 2 and row y's residual, with one barrier a row. Runs never
// cross an image, so the ring starts at y = 0 with a zero row; each
// staged row carries a zero (or the neighbouring tile's) column on each
// side, its data 16 bytes in, so the kx = +-1 taps need no masks. Rows
// that are not 16-byte aligned are staged element by element; channels
// past the ring's 64 KB (CUDA cores) take several stages of 3 rows with
// their weight slices, double-buffered.
//
// The CUDA-core form (float32; bf16 with 9 C > 288): a thread owns 4
// columns x 8 output channels; per (c, ky) it reads 6 staged values and 3
// x 8 weights as float4 broadcasts for 96 FMAs; SiLU is
// __fdividef(o, 1 + __expf(-o)) (a few ulp, far inside the 1e-4 float32
// bar); 16-byte stores. Measured on the H100 (planar_probe.py, dev runs):
// the FMA loop runs near a third of the FMA peak and the stem's epilogue
// (two SFU operations an output) costs about as much as its FMAs, so the
// stem takes 0.55 ms in float32, 1.9x its byte bound. Float32 as three
// TF32 products on the tensor cores (the 1e-4 bar rules out one) measured
// 0.87 ms on the stem and was dropped.
//
// The tensor-core form (bf16, 9 C <= 288): per row an implicit GEMM on
// mma.sync m16n8k16, A = the weights (16 output channels x 16 taps, k =
// 9 c + 3 ky + kx) as bf16 hi = bf16(w) plus lo = bf16(w - hi) (what is
// left is under 2^-17 |w|; the products of bf16 inputs are exact, the
// sums float32), built once per block into fragments; B = the taps of 8
// columns, gathered from the ring by a per-block table of each tap's
// place. A warp owns 4 tiles of 8 columns x 16 channels. The bias seeds
// the sums; SiLU is o (1 + tanh.approx(o / 2)) / 2, one SFU operation
// (error under 2^-12 |o|, 16x under a bf16 step, inside the 2^-7 bar).
// On the CUDA cores the bf16 FMAs alone would take 0.169 ms of the
// stem's 0.149 ms byte bound; on the tensor cores they take under 0.03.
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

enum Act { kActNone = 0, kActSilu = 1, kActRelu = 2 };
enum Kind { kF32 = 0, kBf16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

// ---------------------------------------------------------------------------
// 3x3
// ---------------------------------------------------------------------------

constexpr int kRingBytes = 64 * 1024;      // the ring of staged input rows at most
constexpr int kWeight3Bytes = 48 * 1024;   // staged float32 weights at most
constexpr int kMmaMaxTaps = 288;           // 9 C the tensor-core form (bf16) takes at most
constexpr int kMmaNT = 4;                  // its warps' column tiles of 8
constexpr int kMmaMaxWarps = 16;           // warps of its block

// The CUDA-core form: blocks of at most 320 threads, two an SM (which caps
// the registers at 96). The tensor-core form: up to 16 warps.
template <bool kMma> struct Block3x3 { static constexpr int kThreads = 320, kMinBlocks = 2; };
template <> struct Block3x3<true> { static constexpr int kThreads = 32 * kMmaMaxWarps, kMinBlocks = 1; };

struct Geom3x3 {
  int H, C, W, Co, act;
  int rows_per_block;  // R: the block's run of consecutive rows of one image
  int runs;            // runs per image, ceil(H / R)
  int cot;             // output channels per block: a multiple of 8 (16 on the tensor cores)
  int wt;              // columns per block: a multiple of 8 (32 on the tensor cores)
  int wtp;             // a staged row's pitch: wt and 16 bytes on each side
  int cc;              // input channels per stage
  int nch;             // stages per row, ceil(C / cc) and at least 1 (1 on the tensor cores)
  int ksteps;          // tensor cores: k-steps of 16 taps, ceil(9 C / 16)
  int vec_in;          // x and the residual staged by 16-byte cp.async pieces
  int vec_out;         // output written 4 (CUDA cores) or 2 (tensor cores) columns at a time
};

// i = tid, tid + nt, ... < n * m as (i / m, i % m), with the divisions
// made once for the walk and none a step
struct Walk {
  int c, p, dc, dp, m;
  __device__ Walk(int m_, int tid, int nt) : m(m_) {
    c = tid / m;
    p = tid - c * m;
    dc = nt / m;
    dp = nt - dc * m;
  }
  template <typename F>
  __device__ __forceinline__ void run(int n, F f) const {
    for (int i = c, j = p; i < n;) {
      f(i, j);
      i += dc;
      j += dp;
      if (j >= m) {
        j -= m;
        ++i;
      }
    }
  }
};

// d += a b on the tensor cores: a 16x16 bf16 (row-major fragment), b 16x8
// bf16 (column-major: b0 holds k = 2t, 2t + 1 of column g, b1 k + 8), d
// 16x8 float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  return *reinterpret_cast<const unsigned short*>(&h);
}

// The tensor-core form's activation: SiLU as o (1 + tanh(o / 2)) / 2 with
// one tanh.approx (relative error about 2^-11, so the SiLU's is under
// 2^-12 |o|, 16x under a bf16 rounding step), one SFU operation where
// __expf and __fdividef take two
__device__ __forceinline__ float act_bf16(float o, int act) {
  if (act == kActSilu) {
    float t;
    asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * o));
    return o * fmaf(0.5f, t, 0.5f);
  }
  if (act == kActRelu) return fmaxf(o, 0.0f);
  return o;
}

// kMma: the tensor-core form (T is bf16); else CUDA-core FMAs
template <typename T, bool kMma>
__global__ void __launch_bounds__(Block3x3<kMma>::kThreads, Block3x3<kMma>::kMinBlocks)
conv3x3_planar_kernel(const T* __restrict__ x,         // (B, H, C, W)
                      const float* __restrict__ w,     // (3, 3, C, Co)
                      const float* __restrict__ bias,  // (Co,) or null
                      const T* __restrict__ res,       // (B, H, Co, W) or null
                      T* __restrict__ out,             // (B, H, Co, W)
                      const Geom3x3 g) {
  extern __shared__ __align__(16) unsigned char smem3[];
  constexpr int kPad = 16 / sizeof(T);          // a staged row's data starts 16 bytes in
  const int tid = threadIdx.x, nt = blockDim.x;
  const int co0 = blockIdx.y * g.cot;
  const int con = min(g.cot, g.Co - co0);       // this block's output channels
  const int w0 = blockIdx.z * g.wt;
  const int wt = min(g.wt, g.W - w0);           // this block's columns
  const int b = blockIdx.x / g.runs;
  const int y0 = (blockIdx.x - b * g.runs) * g.rows_per_block;
  const int nrows = min(g.rows_per_block, g.H - y0);
  const bool one_slice = g.nch == 1;            // all of C in one stage: a ring of 4 rows
  const int nslots = one_slice ? 4 : 6;         // else 3 rows a stage, double-buffered
  const int xslot = g.cc * g.wtp, wstage = 9 * g.cc * g.cot, rstage = g.cot * g.wt;
  // weights: float32 [C][3][3][cot] or [2][cc][3][3][cot]; on the tensor
  // cores A fragments, lo and hi, [ksteps][2][32 lanes][4], and each tap's
  // place in the ring, [ksteps * 16]
  const int wfloats = kMma ? g.ksteps * (256 + 16) : (one_slice ? g.C : 2 * g.cc) * 9 * g.cot;
  float* bs = reinterpret_cast<float*>(smem3);                    // [cot]
  float* ws = bs + g.cot;
  T* xs = reinterpret_cast<T*>(ws + wfloats);                     // [nslots][cc][wtp]
  T* rs = xs + nslots * xslot;                                    // [2][cot][wt]

  // the slot of stage s's input row y - 1 + t (t = 0, 1, 2)
  auto slot = [&](int s, int t) {
    return xs + (one_slice ? (s + t) & 3 : 3 * (s & 1) + t) * xslot;
  };
  // float32 weights of channels [c0, c0 + cn) for the block's output
  // channels, as [c][ky][kx][cot], 0 past Co
  auto stage_w = [&](float* dst, int c0, int cn) {
    for (int i = tid; i < cn * 9 * g.cot; i += nt) {
      const int c = i / (9 * g.cot), k = i - c * 9 * g.cot;
      const int tap = k / g.cot, j = k - tap * g.cot;
      if (j < con) cp_async4(dst + i, w + (static_cast<size_t>(tap) * g.C + c0 + c) * g.Co + co0 + j);
      else dst[i] = 0.0f;
    }
  };
  // the pieces of a staged row: 16-byte ones, or elements with the halo
  // columns, or the residual's elements; their walks divide once here
  const int pieces = g.vec_in ? wt / kPad : 0;
  const Walk walk_x(g.vec_in ? pieces : wt + 2, tid, nt);
  const Walk walk_r(g.vec_in ? pieces : wt, tid, nt);
  auto stage_x = [&](T* dst, int iy, int c0, int cn) {
    if (iy < 0 || iy >= g.H) {
      for (int i = tid; i < cn * g.wtp * static_cast<int>(sizeof(T)) / 16; i += nt)
        reinterpret_cast<float4*>(dst)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      return;
    }
    const T* src = x + (static_cast<size_t>(b * g.H + iy) * g.C + c0) * g.W + w0;
    if (g.vec_in) {
      walk_x.run(cn, [&](int c, int p) {
        cp_async16(dst + c * g.wtp + kPad + p * kPad, src + static_cast<size_t>(c) * g.W + p * kPad);
      });
      // halo columns inside the map, 4 bytes each (a bf16 pair, aligned);
      // those outside it stay as zeroed at the start
      constexpr int kH = 4 / sizeof(T);
      const bool left = w0 > 0, right = w0 + wt < g.W;
      if (left || right)
        for (int c = tid; c < cn; c += nt) {
          if (left) cp_async4(dst + c * g.wtp + kPad - kH, src + static_cast<size_t>(c) * g.W - kH);
          if (right) cp_async4(dst + c * g.wtp + kPad + wt, src + static_cast<size_t>(c) * g.W + wt);
        }
    } else {
      walk_x.run(cn, [&](int c, int p) {
        const int ix = w0 + p - 1;
        store(dst + c * g.wtp + kPad + p - 1,
              ix >= 0 && ix < g.W ? to_f(src[static_cast<size_t>(c) * g.W + p - 1]) : 0.0f);
      });
    }
  };
  // the residual row: con rows of the block's columns
  auto stage_r = [&](T* dst, const T* src) {
    if (g.vec_in) {
      walk_r.run(con, [&](int c, int p) {
        cp_async16(dst + c * g.wt + p * kPad, src + static_cast<size_t>(c) * g.W + p * kPad);
      });
    } else {
      walk_r.run(con, [&](int c, int p) { dst[c * g.wt + p] = src[static_cast<size_t>(c) * g.W + p]; });
    }
  };
  // stage s (row s / nch, channel slice s % nch): its input rows not yet
  // staged (the ring's new row y + 1, or all three), its weight slice, and
  // the row's residual with its last slice
  const int stages = nrows * g.nch;
  auto load_stage = [&](int s) {
    const int r = one_slice ? s : s / g.nch, ch = s - r * g.nch, c0 = ch * g.cc;
    const int cn = min(g.cc, g.C - c0);
    for (int t = one_slice && s > 0 ? 2 : 0; t < 3; ++t) stage_x(slot(s, t), y0 + r + t - 1, c0, cn);
    if (!one_slice) stage_w(ws + (s & 1) * wstage, c0, cn);
    if (res != nullptr && ch == g.nch - 1)
      stage_r(rs + (s & 1) * rstage, res + (static_cast<size_t>(b * g.H + y0 + r) * g.Co + co0) * g.W + w0);
    cp_async_commit();
  };

  for (int i = tid; i < g.cot; i += nt) bs[i] = bias != nullptr && i < con ? bias[co0 + i] : 0.0f;
  for (int i = tid; i < nslots * xslot * static_cast<int>(sizeof(T)) / 16; i += nt)
    reinterpret_cast<float4*>(xs)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (kMma) {
    // A[m][k] = w[tap][c][co0 + m] with k = 9 c + 3 ky + kx, split as
    // hi = bf16(w) and lo = bf16(w - hi), 0 past Co and past 9 C;
    // fragments of pairs (m, k), (m, k + 1) at m = g (+ 8), k = 2t (+ 8).
    // And tap k's place, ky * xslot + c * wtp + kx from row y - 1 of the
    // ring at the halo column left of the thread's, or past 9 C a staged
    // value that A multiplies by 0.
    uint32_t* af = reinterpret_cast<uint32_t*>(ws);
    int* toff = reinterpret_cast<int*>(ws + 256 * g.ksteps);
    const int K = 9 * g.C;
    auto wv = [&](int m, int k) {
      if (m >= con || k >= K) return 0.0f;
      const int c = k / 9, tap = k - 9 * c;
      return w[(static_cast<size_t>(tap) * g.C + c) * g.Co + co0 + m];
    };
    for (int i = tid; i < g.ksteps * 128; i += nt) {
      const int r = i & 3, ln = (i >> 2) & 31, ks = i >> 7;
      const int m = (ln >> 2) + 8 * (r & 1);
      const int k = 16 * ks + 2 * (ln & 3) + 8 * (r >> 1);
      const float v0 = wv(m, k), v1 = wv(m, k + 1);
      const float h0 = __bfloat162float(__float2bfloat16_rn(v0));
      const float h1 = __bfloat162float(__float2bfloat16_rn(v1));
      af[(2 * ks) * 128 + ln * 4 + r] = bf16_bits(v0 - h0) | bf16_bits(v1 - h1) << 16;
      af[(2 * ks + 1) * 128 + ln * 4 + r] = bf16_bits(h0) | bf16_bits(h1) << 16;
    }
    for (int k = tid; k < g.ksteps * 16; k += nt) {
      int o = xslot;
      if (k < K) {
        const int c = k / 9, tap = k - 9 * c, ky = tap / 3;
        o = ky * xslot + c * g.wtp + tap - 3 * ky;
      }
      toff[k] = o;
    }
  }
  __syncthreads();                              // the zeros land before any row does
  if (!kMma && one_slice) stage_w(ws, 0, g.C);  // with stage 0's group
  load_stage(0);

  if constexpr (kMma) {
    // warp -> kMmaNT tiles of 8 columns, all 16 channels; lane (gq, tq) =
    // (lane / 4, lane % 4). The ring's rows lie xslot apart but wrap: rows
    // of slot 4 and on are read 4 slots back.
    const int lane = tid & 31, cb = 8 * kMmaNT * (tid >> 5), gq = lane >> 2, tq = lane & 3;
    const uint4* afr = reinterpret_cast<const uint4*>(ws) + lane;
    const int* toff = reinterpret_cast<const int*>(ws + 256 * g.ksteps);
    const float b_lo = bs[gq], b_hi = bs[gq + 8];
    for (int s = 0; s < stages; ++s) {
      cp_async_wait_all();     // this thread's pieces of stage s have landed
      __syncthreads();         // everyone's have, and the slot stage s + 1 fills is free
      if (s + 1 < stages) load_stage(s + 1);
      // row y - 1 left of the thread's column; places at or past lim wrap
      const T* row0 = slot(s, 0) + kPad - 1 + cb + gq;
      const int wrap = 4 * xslot, lim = (4 - (s & 3)) * xslot;
      float acc[kMmaNT][4];
#pragma unroll
      for (int n8 = 0; n8 < kMmaNT; ++n8) {
        acc[n8][0] = acc[n8][1] = b_lo;
        acc[n8][2] = acc[n8][3] = b_hi;
      }
      for (int ks = 0; ks < g.ksteps; ++ks) {
        const uint4 al = afr[64 * ks], ah = afr[64 * ks + 32];
        // B[k][n]: taps k = 16 ks + 2 tq + {0, 1, 8, 9} at column gq
        const unsigned short* pk[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = toff[16 * ks + 2 * tq + (j & 1) + 8 * (j >> 1)];
          pk[j] = reinterpret_cast<const unsigned short*>(row0 + (o >= lim ? o - wrap : o));
        }
#pragma unroll
        for (int n8 = 0; n8 < kMmaNT; ++n8) {
          const uint32_t b0 = pk[0][8 * n8] | static_cast<uint32_t>(pk[1][8 * n8]) << 16;
          const uint32_t b1 = pk[2][8 * n8] | static_cast<uint32_t>(pk[3][8 * n8]) << 16;
          mma_bf16(acc[n8], al, b0, b1);   // the small part first
          mma_bf16(acc[n8], ah, b0, b1);
        }
      }
      // acc[n8]: channels gq (0, 1) and gq + 8 (2, 3), columns 2 tq and
      // 2 tq + 1 of tile n8
      T* orow = out + (static_cast<size_t>(b * g.H + y0 + s) * g.Co + co0) * g.W + w0;
      const T* rb = rs + (s & 1) * rstage;
#pragma unroll
      for (int n8 = 0; n8 < kMmaNT; ++n8)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cl = gq + 8 * h, col = cb + 8 * n8 + 2 * tq;
          const bool two = col + 1 < wt;
          float v0 = act_bf16(acc[n8][2 * h], g.act);
          float v1 = act_bf16(acc[n8][2 * h + 1], g.act);
          if (cl < con && col < wt) {
            if (res != nullptr) {
              v0 += to_f(rb[cl * g.wt + col]);
              if (two) v1 += to_f(rb[cl * g.wt + col + 1]);
            }
            T* o = orow + static_cast<size_t>(cl) * g.W + col;
            if (two && g.vec_out) {
              *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
            } else {
              store(o, v0);
              if (two) store(o + 1, v1);
            }
          }
        }
    }
  } else {
    // thread -> 4 columns (column groups first, so a warp reads one row
    // run) x 8 channels
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
      cp_async_wait_all();     // this thread's pieces of stage s have landed
      __syncthreads();         // everyone's have, and the slots stage s + 1 fills are free
      if (s + 1 < stages) load_stage(s + 1);
      const int r = one_slice ? s : s / g.nch, ch = s - r * g.nch;
      const int cn = min(g.cc, g.C - ch * g.cc);
      if (!active) continue;
      const T* xr[3] = {slot(s, 0) + kPad + col, slot(s, 1) + kPad + col, slot(s, 2) + kPad + col};
      const float* wb = (one_slice ? ws : ws + (s & 1) * wstage) + q8;
#pragma unroll 2
      for (int c = 0; c < cn; ++c) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          // the 6 staged values of the thread's 4 columns and their halo
          const T* xp = xr[ky] + c * g.wtp;
          const float4 v = load4(xp);
          const float xv[6] = {to_f(xp[-1]), v.x, v.y, v.z, v.w, to_f(xp[4])};
          const float* wk = wb + (c * 9 + ky * 3) * g.cot;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float4 wa = load4(wk + kx * g.cot);
            const float4 wc = load4(wk + kx * g.cot + 4);
            const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wc.x, wc.y, wc.z, wc.w};
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(wv[j], xv[i + kx], acc[j][i]);
          }
        }
      }
      if (ch + 1 < g.nch) continue;
      if (col < wt) {
        const size_t base = (static_cast<size_t>(b * g.H + y0 + r) * g.Co + co0) * g.W + w0 + col;
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
}

// One form's launch: the per-device SM count and shared-memory opt-in,
// and each image's rows in runs of R, R chosen so that the blocks take the
// fewest waves of the blocks the device holds at once, each wave as short
// as it can be.
template <typename T, bool kMma>
int launch_3x3_form(const void* x, const float* w, const float* bias, const void* res, void* out,
                    int B, Geom3x3 g, int co_tiles, int w_tiles, int threads, int smem,
                    cudaStream_t stream) {
  static int sms[kMaxDevices];
  static bool opted[kMaxDevices];
  const void* fn = reinterpret_cast<const void*>(conv3x3_planar_kernel<T, kMma>);
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
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a block of R rows stages R + 2 of them; runs never cross an image
  const long long slots = static_cast<long long>(sms[dev]) * max(per_sm, 1);
  const long long tiles = static_cast<long long>(co_tiles) * w_tiles;
  long long best = -1;
  g.rows_per_block = 1;
  for (int r = 1; r <= g.H; ++r) {
    const long long cost = (B * ceil_div(g.H, r) * tiles + slots - 1) / slots * (r + 2);
    if (best < 0 || cost < best) {
      best = cost;
      g.rows_per_block = r;
    }
  }
  g.runs = ceil_div(g.H, g.rows_per_block);
  const dim3 grid(B * g.runs, co_tiles, w_tiles);
  conv3x3_planar_kernel<T, kMma><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), w, bias, static_cast<const T*>(res), static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

// The 3x3 of element type T. bf16 with 9 C <= 288 runs on the tensor
// cores: Co in tiles of 16 channels, W in tiles of <= 512 columns.
// Otherwise (float32, or bf16 with more channels) the CUDA-core form: Co in tiles of <= 64 channels, W in tiles the block's
// threads cover at 4 columns each, and C in one stage where the ring of 4
// rows and the weights fit, else in slices of cc channels, 3 rows and the
// slice's weights a stage, double-buffered.
template <typename T>
int launch_3x3(const void* x, const float* w, const float* bias, const void* res, void* out,
               int act, int B, int H, int C, int W, int Co, cudaStream_t stream) {
  Geom3x3 g;
  g.H = H;
  g.C = C;
  g.W = W;
  g.Co = Co;
  g.act = act;
  constexpr int isz = static_cast<int>(sizeof(T));
  g.vec_in = aligned(x, 16) && (res == nullptr || aligned(res, 16)) && (W * isz) % 16 == 0;
  if (isz == 2 && 9 * C <= kMmaMaxTaps) {
    const int co_tiles = ceil_div(Co, 16);
    const int w_tiles = ceil_div(W, 8 * kMmaNT * kMmaMaxWarps);
    g.cot = 16;
    g.wt = round_up(ceil_div(W, w_tiles), 8 * kMmaNT);
    g.wtp = g.wt + 2 * (16 / isz);
    if (4LL * C * g.wtp * isz <= kRingBytes) {
      g.cc = max(C, 1);
      g.nch = 1;
      g.ksteps = ceil_div(9 * C, 16);
      g.vec_out = W % 2 == 0 && aligned(out, 2 * isz);
      const int smem = 4 * g.cot + 4 * (256 + 16) * g.ksteps + 4 * g.cc * g.wtp * isz +
                       (res != nullptr ? 2 * g.cot * g.wt * isz : 0);
      return launch_3x3_form<__nv_bfloat16, true>(x, w, bias, res, out, B, g, co_tiles, w_tiles,
                                                  g.wt / (8 * kMmaNT) * 32, smem, stream);
    }
  }
  const int co_tiles = ceil_div(Co, 64);
  g.cot = round_up(ceil_div(Co, co_tiles), 8);
  const int max_groups = (Block3x3<false>::kThreads / (g.cot / 8)) & ~1;   // 4-column groups a block
  const int w_tiles = ceil_div(ceil_div(W, 4), max_groups);
  g.wt = round_up(ceil_div(W, w_tiles), 8);
  g.wtp = g.wt + 2 * (16 / isz);
  if (4LL * C * g.wtp * isz <= kRingBytes && 36LL * C * g.cot <= kWeight3Bytes) {
    g.cc = max(C, 1);
    g.nch = 1;
  } else {
    g.cc = max(1, min(C, min(kRingBytes / (6 * g.wtp * isz), kWeight3Bytes / (72 * g.cot))));
    g.nch = ceil_div(C, g.cc);
  }
  g.ksteps = 0;
  g.vec_out = W % 4 == 0 && aligned(out, 4 * isz);
  const int threads = round_up(g.wt / 4 * (g.cot / 8), 32);
  const int smem = 4 * g.cot + 36 * (g.nch == 1 ? C : 2 * g.cc) * g.cot +
                   (g.nch == 1 ? 4 : 6) * g.cc * g.wtp * isz +
                   (res != nullptr ? 2 * g.cot * g.wt * isz : 0);
  return launch_3x3_form<T, false>(x, w, bias, res, out, B, g, co_tiles, w_tiles, threads, smem,
                                   stream);
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
    return kind == kF32 ? launch_3x3<float>(x, w, bias, res, out, act, B, H, C, W, Co, st)
                        : launch_3x3<__nv_bfloat16>(x, w, bias, res, out, act, B, H, C, W, Co, st);
  }
  return kind == kF32 ? launch_1x1<float>(x, w, bias, res, out, act, B, H, C, W, Co, st)
                      : launch_1x1<__nv_bfloat16>(x, w, bias, res, out, act, B, H, C, W, Co, st);
}
