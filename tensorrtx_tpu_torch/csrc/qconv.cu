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
// plain version's up to the last bit of expf in SiLU. Both kernels below
// share that epilogue (`epilogue_values`). With scale 1, no bias, no
// activation and a float32 exit the output is the int32 sum rounded to
// float32, which is the sum itself for a 1x1 (|acc| <= 127^2 * C < 2^24 for
// C <= 1040): the check that the GEMM is exact, bit for bit.
//
// What bounds it: at YOLO11n-640 the maps are small (80x80 and below, 160x160
// in the float-resident tier, C <= 512). The int8 MACs of one forward (about
// 2.3 G per image) over the 1,979 TOP/s dense int8 peak take ~2.3 us per
// image; its activations and weights (a few MB per image) over 3.35 TB/s
// take about as long, so the GEMM is bound by bytes, and at batch 1 by the
// launch itself. The epilogue is not: an int8 exit with SiLU costs an expf
// and two IEEE divisions per output (each a dependent chain with a slow-path
// branch the compiler will not schedule across), which at batch 32 takes
// several times longer than the output's bytes.
//
// 1x1 (`qconv1x1_mma_kernel`): a GEMM on the int8 tensor cores, M = output
// pixels (B*H*W), N = Co, K = C. The NHWC activations are M x K row-major and
// the OHWI weights N x K with K contiguous, the operand layouts of
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32, so nothing is transposed. A block
// of 8 warps (4 x 2) computes 128-pixel x 64-channel tiles, a warp 32 x 32
// (2 m16 x 4 n8 fragments, 32 int32 sums a thread); a conv with fewer such
// tiles than the card has SMs takes 32 x 32 tiles (warps of 16 x 16), so that
// more SMs share its epilogue. K is staged
// in 64-byte slices by 16-byte cp.async copies into a ring of kStages slices;
// rows are padded to 80 bytes, which puts the 8 rows of each ldmatrix in 8
// different 16-byte bank groups. The last slice is zero-filled past C, rows
// past M and Co are zero and never stored. A channel count that is not a
// multiple of 16, or a pointer that is not 16-byte aligned, is staged byte by
// byte into the same zero-filled layout.
// The convs are short in K (C <= 512: at most 8 slices) and long in M, so a
// block that loaded, computed and stored one tile would wait on memory most
// of its life. One wave of blocks runs instead, each walking its share of
// the output tiles, and its slices form one stream across them, so the ring
// keeps loading the next tiles through this tile's mma steps and epilogue.
// Tiles are numbered N-tile fastest, so the blocks that read one activation
// tile run together and share it through L2. At the end of a tile the warps
// put their sums in shared memory, and each thread then runs the epilogue of
// 8 consecutive channels of a row: one residual load and one 8/16/32-byte
// store for the 8, where the fragments' own layout would give 2-channel
// pieces with their own addresses and guards.
// `stage_slice` and `mma_kstep` take any row source, so an implicit-GEMM 3x3
// can reuse them with the taps as an outer K loop.
//
// 3x3 (`qconv_kernel<3>`): an implicit GEMM on the integer pipes. A block of
// 256 threads owns a 64-pixel x 64-channel output tile. For each tap and each
// 32-channel slice of C it stages the 64 input rows (zero where the tap falls
// in the padding) and the 64 weight rows (OHWI) in shared memory as 32-bit
// words of four int8 values; each thread accumulates a 4x4 sub-tile with
// __dp4a. A channel count that is not a multiple of 32 is zero-filled in the
// last slice, and one that is not a multiple of 4 (or an unaligned pointer)
// is read byte by byte. Its move to the tensor cores is the next change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Act { kActNone = 0, kActSilu = 1, kActRelu = 2 };
enum OutKind { kOutInt8 = 0, kOutF32 = 1, kOutBf16 = 2 };

// ---------------------------------------------------------------------------
// the epilogue, shared by both kernels
// ---------------------------------------------------------------------------

struct Epilogue {
  const float* scale;      // (Co,)
  const float* bias;       // (Co,) or null
  const float* s_out;      // scalar, int8 output only
  const int8_t* res;       // (M, Co) or null
  const float* res_scale;  // scalar, with res
  void* out;               // (M, Co)
  int out_kind, act, Co;
};

// o of N output elements from their int32 sums, each operation rounded
// alone: sc = scale[co]; bi = bias[co], added when there is a bias; r the
// residual, added when there is one. The N elements go through each step
// together, so their (branch-free) exponentials interleave; each element
// sees the same operations in the same order whatever N is.
template <int ACT, int N>
__device__ __forceinline__ void epilogue_values(const Epilogue& e, const int (&acc)[N],
                                                const float (&sc)[N], const float (&bi)[N],
                                                const int8_t (&r)[N], float rs, float (&o)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    o[j] = __fmul_rn(__int2float_rn(acc[j]), sc[j]);
    if (e.bias != nullptr) o[j] = __fadd_rn(o[j], bi[j]);
    if (e.res != nullptr) o[j] = __fadd_rn(o[j], __fmul_rn(static_cast<float>(r[j]), rs));
  }
  if (ACT == kActSilu) {
    float d[N];
#pragma unroll
    for (int j = 0; j < N; ++j) d[j] = __fadd_rn(1.0f, expf(-o[j]));
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = __fmul_rn(o[j], __fdiv_rn(1.0f, d[j]));
  }
  if (ACT == kActRelu) {
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = fmaxf(o[j], 0.0f);
  }
}

__device__ __forceinline__ int8_t requant(float o, float so) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(o, so)), -127.0f), 127.0f));
}

// Stores o as element o_idx of the output.
template <int OUT>
__device__ __forceinline__ void store_out(void* out, size_t o_idx, float o, float so) {
  if (OUT == kOutInt8) {
    static_cast<int8_t*>(out)[o_idx] = requant(o, so);
  } else if (OUT == kOutF32) {
    static_cast<float*>(out)[o_idx] = o;
  } else {
    static_cast<__nv_bfloat16*>(out)[o_idx] = __float2bfloat16_rn(o);
  }
}

// The epilogue of one output element, activation and output kind read at
// run time (the 3x3 kernel's form).
__device__ __forceinline__ void epilogue(const Epilogue& e, int m, int co, int acc, float so,
                                         float rs) {
  const size_t o_idx = static_cast<size_t>(m) * e.Co + co;
  const int a[1] = {acc};
  const float sc[1] = {e.scale[co]};
  const float bi[1] = {e.bias != nullptr ? e.bias[co] : 0.0f};
  const int8_t r[1] = {e.res != nullptr ? e.res[o_idx] : static_cast<int8_t>(0)};
  float o[1];
  if (e.act == kActSilu) {
    epilogue_values<kActSilu, 1>(e, a, sc, bi, r, rs, o);
  } else if (e.act == kActRelu) {
    epilogue_values<kActRelu, 1>(e, a, sc, bi, r, rs, o);
  } else {
    epilogue_values<kActNone, 1>(e, a, sc, bi, r, rs, o);
  }
  if (e.out_kind == kOutInt8) {
    store_out<kOutInt8>(e.out, o_idx, o[0], so);
  } else if (e.out_kind == kOutF32) {
    store_out<kOutF32>(e.out, o_idx, o[0], so);
  } else {
    store_out<kOutBf16>(e.out, o_idx, o[0], so);
  }
}

// ---------------------------------------------------------------------------
// 1x1: int8 GEMM on the tensor cores (mma.sync m16n8k32)
// ---------------------------------------------------------------------------

constexpr int kBK = 64;         // K bytes (int8 channels) per staged slice
constexpr int kLdS = kBK + 16;  // padded shared row: 8 ldmatrix rows, 8 bank groups
constexpr int kStages = 3;      // slices in flight

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes past src_bytes are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 matrices of 16-bit pairs (here: 8 rows x 16 int8) from shared
// memory; lane l gives the row address of matrix l / 8 and receives, in r[j],
// row l / 4 bytes 4(l % 4)..+3 of matrix j: the m16n8k32 operand fragments.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stages channels [k0, k0 + kBK) of ROWS rows into s (row stride kLdS bytes).
// src(r) points at channel 0 of row r, or is null for a row of zeros;
// channels >= C are zero. vec: C % 16 == 0 and every row 16-byte aligned, so
// each 16-byte chunk is whole or wholly past C and goes by cp.async; else the
// chunk is read byte by byte. `any` is a valid global address (unread).
template <int ROWS, int THREADS, typename Src>
__device__ __forceinline__ void stage_slice(int8_t* s, Src src, const int8_t* any, int k0,
                                            int C, bool vec, int tid) {
  constexpr int kChunksPerRow = kBK / 16;
  static_assert(ROWS * kChunksPerRow % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < ROWS * kChunksPerRow / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / kChunksPerRow;
    const int c = k0 + (i % kChunksPerRow) * 16;
    int8_t* d = s + r * kLdS + (c - k0);
    const int8_t* p = src(r);
    if (vec) {
      const bool in = p != nullptr && c < C;
      cp_async16(d, in ? p + c : any, in ? 16 : 0);
    } else {
      uint32_t v[4] = {0, 0, 0, 0};
      if (p != nullptr) {
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          if (c + b < C)
            v[b / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[c + b])) << (8 * (b % 4));
        }
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// One 32-byte K step of a warp's (16*MI) x (8*NI) tile: A rows from `a`
// (16*MI staged rows), B rows from `b` (8*NI staged rows), both at byte kb
// of the slice. acc[mi][ni] is the m16n8 fragment: c0, c1 = row g, columns
// 2t, 2t+1; c2, c3 = row g + 8 (g = lane / 4, t = lane % 4).
template <int MI, int NI>
__device__ __forceinline__ void mma_kstep(const int8_t* a, const int8_t* b, int kb, int lane,
                                          int (&acc)[MI][NI][4]) {
  static_assert(NI % 2 == 0, "B fragments load in pairs of n8 tiles");
  uint32_t af[MI][4], bf[NI / 2][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)  // a0: rows 0-7, a1: rows 8-15, a2/a3: bytes 16-31
    ldmatrix_x4(af[mi], a + (mi * 16 + (lane & 15)) * kLdS + kb + (lane >> 4) * 16);
#pragma unroll
  for (int nj = 0; nj < NI / 2; ++nj)  // b0, b1 of n8 tile 2nj, then of 2nj + 1
    ldmatrix_x4(bf[nj], b + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * kLdS + kb +
                            ((lane >> 3) & 1) * 16);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
      mma_s8(acc[mi][ni], af[mi], bf[ni / 2][(ni & 1) * 2], bf[ni / 2][(ni & 1) * 2 + 1]);
}

// The epilogue of 8 consecutive output channels co0.. of pixel m from their
// int32 sums: one 8-byte residual load and one 8-, 16- or 32-byte store when
// the 8 lie inside Co and Co % 8 == 0 (aligned: the caller allocates `out`),
// else element by element. sc, bi: scale and bias of the 8 channels.
template <int ACT, int OUT>
__device__ __forceinline__ void epilogue8(const Epilogue& e, int m, int co0, const int (&a)[8],
                                          const float (&sc)[8], const float (&bi)[8], float so,
                                          float rs, bool whole) {
  const size_t o_idx = static_cast<size_t>(m) * e.Co + co0;
  union { uint2 u; int8_t b[8]; } r;
  r.u = make_uint2(0, 0);
  if (e.res != nullptr) {
    if (whole && (reinterpret_cast<uintptr_t>(e.res) & 7) == 0) {
      r.u = *reinterpret_cast<const uint2*>(e.res + o_idx);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (co0 + j < e.Co) r.b[j] = e.res[o_idx + j];
    }
  }
  float o[8];
  epilogue_values<ACT, 8>(e, a, sc, bi, r.b, rs, o);
  if (whole) {
    if (OUT == kOutInt8) {
      union { uint2 u; int8_t b[8]; } q;
#pragma unroll
      for (int j = 0; j < 8; ++j) q.b[j] = requant(o[j], so);
      *reinterpret_cast<uint2*>(static_cast<int8_t*>(e.out) + o_idx) = q.u;
    } else if (OUT == kOutF32) {
      float4* p = reinterpret_cast<float4*>(static_cast<float*>(e.out) + o_idx);
      p[0] = make_float4(o[0], o[1], o[2], o[3]);
      p[1] = make_float4(o[4], o[5], o[6], o[7]);
    } else {
      union { uint4 u; uint32_t w[4]; } q;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
        q.w[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(e.out) + o_idx) = q.u;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (co0 + j < e.Co) store_out<OUT>(e.out, o_idx + j, o[j], so);
}

// Work item i is the output tile (M tile i / N tiles, N tile i % N tiles);
// block b takes items b, b + G, b + 2G, ... (G blocks), its K slices one
// stream across them. The sums of an item go through shared memory (Cs) to
// the epilogue, 8 consecutive channels of a row per thread at a time.
template <int WARPS_M, int WARPS_N, int kMI, int kNI, int ACT>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, 512 / (WARPS_M * WARPS_N * 32))
qconv1x1_mma_kernel(const int8_t* __restrict__ x,  // (M, C)
                    const int8_t* __restrict__ w,  // (Co, C)
                    Epilogue ep, int M, int C, int vec) {
  // a warp's tile: kMI m16 x kNI n8 fragments
  constexpr int BM = WARPS_M * 16 * kMI, BN = WARPS_N * 8 * kNI;
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int kSlice = (BM + BN) * kLdS;  // bytes of one staged slice
  constexpr int kLdC = BN + 8;              // int32 row of Cs: 8-byte stores spread
  constexpr int kGroups = BN / 8;           // 8-channel groups of a row
  constexpr int kRowsPerPass = kThreads / kGroups;
  static_assert(BM % kRowsPerPass == 0, "whole epilogue passes");
  extern __shared__ __align__(128) int8_t smem[];
  int* Cs = reinterpret_cast<int*>(smem + kStages * kSlice);  // BM x kLdC sums

  const int Co = ep.Co;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n_tiles = (Co + BN - 1) / BN;
  const int items = ((M + BM - 1) / BM) * n_tiles;
  const int G = gridDim.x;
  const int nk = (C + kBK - 1) / kBK;
  const int bid = blockIdx.x;
  const int total = bid < items ? ((items - 1 - bid) / G + 1) * nk : 0;
  const bool v16 = vec != 0;

  auto stage = [&](int s) {  // slice s of this block's stream
    const int item = bid + (s / nk) * G, kt = s % nk;
    const int m0 = (item / n_tiles) * BM, n0 = (item % n_tiles) * BN;
    auto a_row = [&](int r) -> const int8_t* {
      return m0 + r < M ? x + static_cast<size_t>(m0 + r) * C : nullptr;
    };
    auto b_row = [&](int r) -> const int8_t* {
      return n0 + r < Co ? w + static_cast<size_t>(n0 + r) * C : nullptr;
    };
    int8_t* d = smem + (s % kStages) * kSlice;
    stage_slice<BM, kThreads>(d, a_row, x, kt * kBK, C, v16, tid);
    stage_slice<BN, kThreads>(d + BM * kLdS, b_row, w, kt * kBK, C, v16, tid);
  };

  const int g = lane >> 2, t = lane & 3;
  const float so = ep.out_kind == kOutInt8 ? *ep.s_out : 1.0f;
  const float rs = ep.res != nullptr ? *ep.res_scale : 0.0f;
  const int cg = tid % kGroups, r0 = tid / kGroups;  // this thread's epilogue slots

  int acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) stage(s);
    cp_async_commit();
  }
  int kt = 0, item = bid;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();  // slice s has landed (this thread's copies)
    __syncthreads();               // ... and everyone's; slice s - 1 and Cs are consumed
    if (s + kStages - 1 < total) stage(s + kStages - 1);
    cp_async_commit();
    const int8_t* d = smem + (s % kStages) * kSlice;
    const int8_t* a = d + wm * 16 * kMI * kLdS;
    const int8_t* b = d + (BM + wn * 8 * kNI) * kLdS;
    mma_kstep<kMI, kNI>(a, b, 0, lane, acc);
    if (kt * kBK + 32 < C) mma_kstep<kMI, kNI>(a, b, 32, lane, acc);
    if (++kt < nk) continue;

    // the tile's sums to Cs: fragment (mi, ni) rows g, g + 8, columns 2t, 2t + 1
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const int row = wm * 16 * kMI + mi * 16 + g + 8 * h;
          const int col = wn * 8 * kNI + ni * 8 + 2 * t;
          *reinterpret_cast<int2*>(Cs + row * kLdC + col) =
              make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0;
        }
    __syncthreads();

    const int m0 = (item / n_tiles) * BM;
    const int co0 = (item % n_tiles) * BN + cg * 8;
    if (co0 < Co) {
      const bool whole = co0 + 8 <= Co && (Co & 7) == 0;
      float sc[8], bi[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = min(co0 + j, Co - 1);
        sc[j] = ep.scale[co];
        bi[j] = ep.bias != nullptr ? ep.bias[co] : 0.0f;
      }
      auto run = [&](auto kind) {
        constexpr int OUT = decltype(kind)::value;
#pragma unroll
        for (int p = 0; p < BM / kRowsPerPass; ++p) {
          const int row = r0 + p * kRowsPerPass;
          if (m0 + row >= M) break;
          union { int4 u[2]; int v[8]; } sums;
          sums.u[0] = *reinterpret_cast<const int4*>(Cs + row * kLdC + cg * 8);
          sums.u[1] = *reinterpret_cast<const int4*>(Cs + row * kLdC + cg * 8 + 4);
          epilogue8<ACT, OUT>(ep, m0 + row, co0, sums.v, sc, bi, so, rs, whole);
        }
      };
      if (ep.out_kind == kOutInt8) {
        run(std::integral_constant<int, kOutInt8>());
      } else if (ep.out_kind == kOutF32) {
        run(std::integral_constant<int, kOutF32>());
      } else {
        run(std::integral_constant<int, kOutBf16>());
      }
    }
    kt = 0;
    item += G;
  }
}

// ---------------------------------------------------------------------------
// 3x3: implicit GEMM on the integer pipes (__dp4a)
// ---------------------------------------------------------------------------

constexpr int kBM = 64;       // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kKW = 8;        // 32-bit words per K slice (32 int8 channels)
constexpr int kLd = kKW + 1;  // padded shared-memory row (bank spread)
constexpr int kThreads = 256;
constexpr int kLoads = kBM * kKW / kThreads;  // words each thread stages

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
             Epilogue ep, int H, int W, int C, int Ho, int Wo, int stride, int M, int vec) {
  __shared__ int As[kBM][kLd];
  __shared__ int Bs[kBN][kLd];

  const int Co = ep.Co;
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

  const float so = ep.out_kind == kOutInt8 ? *ep.s_out : 1.0f;
  const float rs = ep.res != nullptr ? *ep.res_scale : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx + 16 * j;
      if (co < Co) epilogue(ep, m, co, acc[i][j], so, rs);
    }
  }
}

// The card's SM count, or 0 when the runtime cannot tell.
int sm_count() {
  static int sms = 0;
  int dev = 0;
  if (sms == 0 && cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// One wave of qconv1x1_mma_kernel blocks at most, over all the work items.
template <int WARPS_M, int WARPS_N, int MI, int NI, int ACT>
int launch_1x1(const int8_t* x, const int8_t* w, const Epilogue& ep, int M, int C, int vec,
               cudaStream_t stream) {
  constexpr int BM = WARPS_M * 16 * MI, BN = WARPS_N * 8 * NI;
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int kSmem = kStages * (BM + BN) * kLdS + BM * (BN + 8) * 4;
  auto kernel = qconv1x1_mma_kernel<WARPS_M, WARPS_N, MI, NI, ACT>;
  static int resident = 0;  // blocks the card holds at once
  if (resident == 0) {
    int per_sm = 0;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sm_count() * (per_sm > 0 ? per_sm : 1);
  }
  const long long items = static_cast<long long>((M + BM - 1) / BM) * ((ep.Co + BN - 1) / BN);
  const int grid = static_cast<int>(items < resident ? items : resident);
  kernel<<<grid, kThreads, kSmem, stream>>>(x, w, ep, M, C, vec);
  return static_cast<int>(cudaGetLastError());
}

// The tile: 128 x 64 (8 warps of 32 x 32); a conv too small to give each SM
// one such tile takes 32 x 32 tiles (4 warps of 16 x 16), so more SMs share
// its epilogue and each thread runs 8 outputs, not 32.
template <int ACT>
int launch_1x1_tiles(const int8_t* x, const int8_t* w, const Epilogue& ep, int M, int C,
                     int vec, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorNoDevice);
  const long long big = static_cast<long long>((M + 127) / 128) * ((ep.Co + 63) / 64);
  if (big < sms) return launch_1x1<2, 2, 1, 2, ACT>(x, w, ep, M, C, vec, stream);
  return launch_1x1<4, 2, 2, 4, ACT>(x, w, ep, M, C, vec, stream);
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError(); the caller
// allocates `out` and checks the code. out_kind: 0 int8, 1 float32,
// 2 bfloat16. act: 0 none, 1 SiLU, 2 ReLU. bias and res may be null; s_out
// and res_scale point at one float on the device. For the 3x3, vec != 0
// promises that C % 4 == 0 and that x and w are 4-byte aligned; for the
// 1x1, that C % 16 == 0 and that x and w are 16-byte aligned.
extern "C" int qconv3x3_launch(const int8_t* x, const int8_t* w, const float* scale,
                               const float* bias, const float* s_out,
                               const int8_t* res, const float* res_scale, void* out,
                               int out_kind, int act, int B, int H, int W, int C,
                               int Co, int stride, int vec, void* stream) {
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const int M = B * Ho * Wo;
  if (M <= 0 || Co <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((M + kBM - 1) / kBM, (Co + kBN - 1) / kBN);
  qconv_kernel<3><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, Epilogue{scale, bias, s_out, res, res_scale, out, out_kind, act, Co}, H, W,
      C, Ho, Wo, stride, M, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qconv1x1_launch(const int8_t* x, const int8_t* w, const float* scale,
                               const float* bias, const float* s_out,
                               const int8_t* res, const float* res_scale, void* out,
                               int out_kind, int act, int B, int H, int W, int C,
                               int Co, int vec, void* stream) {
  const int M = B * H * W;
  if (M <= 0 || Co <= 0) return static_cast<int>(cudaSuccess);
  const Epilogue ep = Epilogue{scale, bias, s_out, res, res_scale, out, out_kind, act, Co};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act == kActSilu) return launch_1x1_tiles<kActSilu>(x, w, ep, M, C, vec, st);
  if (act == kActRelu) return launch_1x1_tiles<kActRelu>(x, w, ep, M, C, vec, st);
  return launch_1x1_tiles<kActNone>(x, w, ep, M, C, vec, st);
}
