// Int8-resident conv with a fused requant epilogue for Hopper (sm_90a):
// 3x3 (stride 1 or 2) and 1x1, int8 NHWC in, int8 NHWC or float out; or a
// bf16 / float32 NHWC input that the conv quantizes itself (below).
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
// float32, which is the sum itself while |acc| < 2^24 (always for a 1x1 with
// C <= 1040, a 3x3 with C <= 115, and far beyond for random int8 inputs): the
// check that the GEMM is exact, bit for bit.
//
// What bounds it: at YOLO11n-640 the maps are small (80x80 and below, 320x320
// and 160x160 in the float-resident tier's stems, C <= 512). The int8 MACs of
// one forward (about 2.3 G per image for the 1x1s, 1.8-2.1 G for the 3x3s)
// over the 1,979 TOP/s dense int8 peak take ~2 us per image; its activations
// and weights (a few MB per image) over 3.35 TB/s take about as long, so the
// GEMMs are bound by bytes, and at batch 1 by the launch itself. The epilogue
// is not: an int8 exit with SiLU costs an expf and two IEEE divisions per
// output (each a dependent chain with a slow-path branch the compiler will
// not schedule across), which at batch 32 takes several times longer than the
// output's bytes.
//
// Both kernels are GEMMs on the int8 tensor cores
// (mma.sync.m16n8k32.row.col.s32.s8.s8.s32): M = output pixels (B*Ho*Wo),
// N = Co, K = the taps' channels. The A operand is M x K row-major and the
// OHWI weights are N x K with K contiguous, the operand layouts of the mma,
// so nothing is transposed. K is staged in 64-byte slices by cp.async copies
// into a ring of kStages slices; rows are padded to 80 bytes, which puts the
// 8 rows of each ldmatrix in 8 different 16-byte bank groups. K, M and Co
// tails are zero-filled, and rows past M and Co are never stored.
// The convs are short in K and long in M, so a block that loaded, computed
// and stored one tile would wait on memory most of its life. One wave of
// blocks runs instead, each walking its share of the output tiles, and its
// slices form one stream across them, so the ring keeps loading the next
// tiles through this tile's mma steps and epilogue. Tiles are numbered N-tile
// fastest, so the blocks that read one activation tile run together and
// share it through L2. At the end of a tile the warps put their sums in
// shared memory, and each thread then runs the epilogue of 8 consecutive
// channels of a row (`tile_epilogue`): one residual load and one
// 8/16/32-byte store for the 8, where the fragments' own layout would give
// 2-channel pieces with their own addresses and guards.
// Tiles: 128 pixels x 64 channels (8 warps of 32 x 32: 2 m16 x 4 n8
// fragments, 32 int32 sums a thread); a conv with fewer such tiles than the
// card has SMs takes 32 x 32 tiles (warps of 16 x 16), so that more SMs share
// its K loop and epilogue.
//
// 1x1 (`qconv1x1_mma_kernel`): K = C, row m of A is input pixel m. A channel
// count that is not a multiple of 16, or a pointer that is not 16-byte
// aligned, is staged byte by byte into the same zero-filled layout.
//
// 3x3 (`qconv3x3_mma_kernel`): an implicit GEMM, K = 9*C ordered (tap, c),
// tap = 3*ky + kx, which is the OHWI weight's own order: the weight is the
// (Co, 9C) B operand as it lies. Row m of A at K index tap*C + c is channel c
// of input pixel (oy*s + ky - 1, ox*s + kx - 1), zero in the padding. K is
// flattened across taps, not padded per tap: at C = 16 a 64-byte slice holds
// four taps, and the C = 3 stem's whole K of 27 is one 32-byte mma step.
// Each 16-byte chunk of a slice finds its own tap (`stage_taps`): with
// C % 16 == 0 it lies in one tap and goes by one 16-byte cp.async, with
// C % 8 == 0 by two 8-byte ones, both through L1, which serves the nine taps'
// reads of each pixel. A thread stages the same chunk column of its rows, so
// it finds each row's pixel once a tile (by multiply-shift division) and
// advances its chunk's tap once a slice. Otherwise (the C = 3 stem, unaligned
// pointers) a warp stages 32 consecutive K bytes of a row at a time, lane l
// byte l (`stage_bytes`), so that each lane's tap is found once a slice and
// each row costs one load and one store a lane. The time goes, at these
// shapes, to the instructions of each slice and tile and to the epilogue, not
// to the bytes (the A operand re-reads each pixel for nine taps, from L1 and
// L2): hence the flat K, the per-tile and per-slice index work kept out of
// the inner loops, and the tiles by Co: a 64-wide tile would spend most of its
// mma steps and epilogue threads on columns past Co = 8, 16 or 32 (see the
// launchers). Activation and exit are read at run time, so the 3x3 is built
// once per tile shape.
//
// Input rows: pixel p of x lies at x + p * P (the pixel stride, P >= C), so a
// channel slice of a wider NHWC map is read where it lies, with no copy.
//
// A float source, for the 1x1 (the float-resident int8 tier, which quantizes
// every conv input by x / sx): the kernel takes the bf16 or float32 map and
// the 0-d scale sx and quantizes it while it stages it, by the division form
// with no division per element (quant_math.cuh, bit-equal to
// clip(rint(x / sx), +-127)), which replaces a standalone quantize launch
// (quantize.cu) and, for a channel slice, the copy in front of it: 16-byte
// cp.async pieces of the raw slice go into kStages - 1 float slots, and once
// they have landed the thread that copied them quantizes them into the int8
// slice, one slice ahead of the mma steps (`quantize_slice`). The 3x3 takes
// int8 only: its gather reads each pixel once per tap, so a quantize there
// runs nine times a pixel, and a quantize prologue in the same launch (a grid
// sync between it and the GEMM) measured level with the standalone quantize
// launch in front of it (on the H100), which its caller makes instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "quant_math.cuh"

namespace {

enum Act { kActNone = 0, kActSilu = 1, kActRelu = 2 };
enum OutKind { kOutInt8 = 0, kOutF32 = 1, kOutBf16 = 2 };
enum SrcKind { kSrcInt8 = 0, kSrcBf16 = 1, kSrcF32 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// How an A element of source type T reaches the int8 operand: an int8
// source as it is; a float one quantized at the 0-d input scale sx by the
// division form (quant_math.cuh), bit-equal to clip(rint(x / sx), +-127).
template <typename T>
struct AQuant {
  DivQuant q;
  __device__ __forceinline__ void init(const float* sx) { q = div_quant(*sx); }
  __device__ __forceinline__ int8_t operator()(T v) const {
    return quantize_div_s8(to_float(v), q);
  }
};

template <>
struct AQuant<int8_t> {
  __device__ __forceinline__ void init(const float*) {}
  __device__ __forceinline__ int8_t operator()(int8_t v) const { return v; }
};

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
  int out_kind, act, Co;   // act: read by the 3x3 kernel; the 1x1 is built per activation
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

// ---------------------------------------------------------------------------
// the tensor-core pieces, shared by both kernels
// ---------------------------------------------------------------------------

constexpr int kBK = 64;            // K bytes (int8 channels) per staged slice
constexpr int kChunks = kBK / 16;  // 16-byte chunks of a slice row
constexpr int kLdS = kBK + 16;     // padded shared row: 8 ldmatrix rows, 8 bank groups
constexpr int kStages = 3;         // slices in flight

// How a slice is read: 16-byte cp.async chunks (K % 16 == 0, rows 16-byte
// aligned), 8-byte ones (K % 8 == 0, rows 8-byte aligned), or byte by byte.
// kCopyFloat: a float source's 16-byte pieces through a float slot (the 1x1).
enum Copy { kCopyBytes = 1, kCopy8 = 8, kCopy16 = 16, kCopyFloat = 32 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes past src_bytes are zero.
// kL1: through L1 (.ca), where the same bytes are read again soon (the 3x3
// reads each pixel for nine taps); else from L2 only (.cg).
template <bool kL1 = false>
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  if (kL1) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  }
}

// The same for 8 bytes (through L1: .cg takes 16-byte copies only).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
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

// Stages K bytes [k0, k0 + kBK) of ROWS rows into s (row stride kLdS bytes).
// src(r) points at K element 0 of row r, or is null for a row of zeros;
// bytes >= K are zero. With kCopy16 (kCopy8) each 16-byte chunk (8-byte half)
// of an int8 source is whole or wholly past K and goes by cp.async (kL1: see
// cp_async16); with kCopyBytes it is read element by element (a float
// source's through `quant`, an AQuant, which quantizes it). `any` is a valid
// global address (unread). The quantize is kept out of unrolled code: its
// copies there cost the 1x1's float instances a tenth of their time.
template <int ROWS, int THREADS, bool kL1 = false, typename Src, typename Q>
__device__ __forceinline__ void stage_slice(int8_t* s, Src src, const void* any, int k0, int K,
                                            int copy, int tid, const Q& quant) {
  constexpr int kAll = ROWS * kChunks;
  static_assert(kAll % THREADS == 0 || kAll < THREADS, "whole chunks per thread");
  using T = std::remove_cv_t<std::remove_pointer_t<decltype(src(0))>>;
#pragma unroll
  for (int j = 0; j < (kAll + THREADS - 1) / THREADS; ++j) {
    const int i = tid + j * THREADS;
    if (kAll < THREADS && i >= kAll) break;
    const int r = i / kChunks;
    const int c = k0 + (i % kChunks) * 16;
    int8_t* d = s + r * kLdS + (c - k0);
    const T* p = src(r);
    if (sizeof(T) == 1 && copy == kCopy16) {
      const bool in = p != nullptr && c < K;
      cp_async16<kL1>(d, in ? static_cast<const void*>(p + c) : any, in ? 16 : 0);
    } else if (sizeof(T) == 1 && copy == kCopy8) {
#pragma unroll
      for (int h = 0; h < 16; h += 8) {
        const bool in = p != nullptr && c + h < K;
        cp_async8(d + h, in ? static_cast<const void*>(p + c + h) : any, in ? 8 : 0);
      }
    } else if (sizeof(T) > 1) {  // a float source's odd layouts: a rolled loop keeps it small
#pragma unroll 1
      for (int b = 0; b < 16; ++b) d[b] = p != nullptr && c + b < K ? quant(p[c + b]) : 0;
    } else {
      uint32_t v[4] = {0, 0, 0, 0};
      if (p != nullptr) {
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          if (c + b < K) {
            const uint32_t q = static_cast<uint8_t>(quant(p[c + b]));
            v[b / 4] |= q << (8 * (b % 4));
          }
        }
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// A float source's A slice goes through shared memory twice (the 1x1):
// stage_float_slice copies the raw values by 16-byte cp.async
// into a float slot, kBK elements a row, and once they have landed the thread
// that copied them quantizes them into the int8 slice (`quantize_chunk`), so
// that the ldmatrix/mma steps read int8 as for an int8 source. A 16-byte
// piece holds kPiece elements (8 bf16, 4 float32).
template <typename T>
constexpr int kPiece = 16 / static_cast<int>(sizeof(T));

// Stages K elements [k0, k0 + kBK) of ROWS rows of a float source into f
// (row stride kBK elements), each chunk of 16 elements by 16-byte pieces that
// are whole or wholly past K (K % kPiece == 0; rows 16-byte aligned); the
// chunks are stage_slice's, thread by thread.
template <int ROWS, int THREADS, typename T, typename Src>
__device__ __forceinline__ void stage_float_slice(T* f, Src src, const T* any, int k0, int K,
                                                  int tid) {
  constexpr int kAll = ROWS * kChunks;
#pragma unroll
  for (int j = 0; j < (kAll + THREADS - 1) / THREADS; ++j) {
    const int i = tid + j * THREADS;
    if (kAll < THREADS && i >= kAll) break;
    const int r = i / kChunks;
    const int c = k0 + (i % kChunks) * 16;
    T* d = f + r * kBK + (c - k0);
    const T* p = src(r);
#pragma unroll
    for (int e = 0; e < 16; e += kPiece<T>) {
      const bool in = p != nullptr && c + e < K;
      cp_async16(d + e, in ? p + c + e : any, in ? 16 : 0);
    }
  }
}

// 16 staged float elements at src (shared) into 16 int8 at dst (shared),
// 16 bytes of src at a time: the guesses, packed as they come, and, if one
// lies near a half-integer, each byte again by the exact path (a rolled
// loop, read again from src). Few values live at once: the 1x1 runs this
// beside its tile's sums.
template <typename T>
__device__ __forceinline__ void quantize_chunk(int8_t* dst, const T* src, const AQuant<T>& quant) {
  static_assert(sizeof(T) > 1, "a float source");
  constexpr int E = kPiece<T>;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint32_t w[4];
  bool near = false;
#pragma unroll
  for (int l = 0; l < 16 / E; ++l) {
    const uint4 raw = s4[l];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int g = 0; g < E / 4; ++g) {
      const float x[4] = {to_float(e[4 * g]), to_float(e[4 * g + 1]), to_float(e[4 * g + 2]),
                          to_float(e[4 * g + 3])};
      uint32_t b[4];
      near |= quantize_div_guesses(x, quant.q, b);
      w[l * E / 4 + g] = pack_low_bytes(b[0], b[1], b[2], b[3]);
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  if (__builtin_expect(near, 0)) {
#pragma unroll 1
    for (int k = 0; k < 16; ++k) dst[k] = quantize_div_s8(to_float(src[k]), quant.q);
  }
}

// The chunks of ROWS rows that stage_float_slice gave this thread, from the
// float slot f into the int8 slice a (row stride kLdS bytes).
template <int ROWS, int THREADS, typename T>
__device__ __forceinline__ void quantize_slice(int8_t* a, const T* f, int tid,
                                               const AQuant<T>& quant) {
  constexpr int kAll = ROWS * kChunks;
#pragma unroll
  for (int j = 0; j < (kAll + THREADS - 1) / THREADS; ++j) {
    const int i = tid + j * THREADS;
    if (kAll < THREADS && i >= kAll) break;
    const int r = i / kChunks, c = (i % kChunks) * 16;
    quantize_chunk(a + r * kLdS + c, f + r * kBK + c, quant);
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

// A warp's sums into its (16*MI) x (8*NI) block of Cs at (row0, col0), row
// stride ldc int32, and its accumulators back to 0: fragment (mi, ni) holds
// rows g, g + 8 and columns 2t, 2t + 1.
template <int MI, int NI>
__device__ __forceinline__ void fragments_to_smem(int* Cs, int ldc, int row0, int col0,
                                                  int lane, int (&acc)[MI][NI][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int row = row0 + mi * 16 + g + 8 * h, col = col0 + ni * 8 + 2 * t;
        *reinterpret_cast<int2*>(Cs + row * ldc + col) =
            make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0;
      }
}

// A tile of WARPS_M x WARPS_N warps of MI m16 x NI n8 fragments each.
template <int WARPS_M, int WARPS_N, int MI, int NI>
struct Tile {
  static constexpr int BM = WARPS_M * 16 * MI, BN = WARPS_N * 8 * NI;
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  static constexpr int kSmem = kStages * (BM + BN) * kLdS + BM * (BN + 8) * 4;
  // a float source adds its A slots: kStages - 1 of them (the 1x1)
  template <typename T>
  static constexpr int smem() {
    return kSmem + (sizeof(T) == 1 ? 0 : (kStages - 1) * BM * kBK * static_cast<int>(sizeof(T)));
  }
  static long long items(int M, int Co) {
    return static_cast<long long>((M + BM - 1) / BM) * ((Co + BN - 1) / BN);
  }
};

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

// The epilogue of the BM-row output tile at (m0, n0) from its sums in Cs
// (row stride ldc int32). `groups` 8-channel groups (a power of two) span
// the tile's channels: thread tid runs group tid % groups of rows
// tid / groups, + THREADS / groups, ...
template <int ACT, int BM, int THREADS>
__device__ __forceinline__ void tile_epilogue(const Epilogue& ep, const int* Cs, int ldc, int m0,
                                              int n0, int M, int groups, int tid, float so,
                                              float rs) {
  const int cg = tid % groups, step = THREADS / groups;
  const int co0 = n0 + cg * 8;
  if (co0 >= ep.Co || tid / groups >= BM) return;
  const bool whole = co0 + 8 <= ep.Co && (ep.Co & 7) == 0;
  float sc[8], bi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = min(co0 + j, ep.Co - 1);
    sc[j] = ep.scale[co];
    bi[j] = ep.bias != nullptr ? ep.bias[co] : 0.0f;
  }
  auto run = [&](auto kind) {
    constexpr int OUT = decltype(kind)::value;
    for (int row = tid / groups; row < BM && m0 + row < M; row += step) {
      union { int4 u[2]; int v[8]; } sums;
      sums.u[0] = *reinterpret_cast<const int4*>(Cs + row * ldc + cg * 8);
      sums.u[1] = *reinterpret_cast<const int4*>(Cs + row * ldc + cg * 8 + 4);
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

// ---------------------------------------------------------------------------
// 1x1: int8 GEMM
// ---------------------------------------------------------------------------

// Work item i is the output tile (M tile i / N tiles, N tile i % N tiles);
// block b takes items b, b + G, b + 2G, ... (G blocks), its K slices one
// stream across them. Row m of A is x + m * P (P: the pixel stride, >= C).
// T: the source's element type. A float source's A slices are staged by
// cp.async into a ring of kStages - 1 float slots (copy_a == kCopyFloat): once a
// slice has landed, each thread quantizes the chunks it copied into the int8
// slice, one slice ahead of the mma steps, before the barrier that opens the
// slice to them; a slot is refilled only after that barrier. Otherwise (copy_a ==
// kCopyBytes) each element is loaded and quantized as it is staged.
template <int WARPS_M, int WARPS_N, int kMI, int kNI, int ACT, typename T>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, 512 / (WARPS_M * WARPS_N * 32))
qconv1x1_mma_kernel(const T* __restrict__ x,       // (M, P): C channels a pixel
                    const int8_t* __restrict__ w,  // (Co, C)
                    Epilogue ep, int M, int C, int P, int copy_a, int copy_b,
                    const float* __restrict__ sx) {
  using Tl = Tile<WARPS_M, WARPS_N, kMI, kNI>;
  constexpr int BM = Tl::BM, BN = Tl::BN, kThreads = Tl::kThreads;
  constexpr int kSlice = (BM + BN) * kLdS;  // bytes of one staged slice
  constexpr int kLdC = BN + 8;              // int32 row of Cs: 8-byte stores spread
  constexpr bool kFloat = sizeof(T) > 1;
  extern __shared__ __align__(128) int8_t smem[];
  int* Cs = reinterpret_cast<int*>(smem + kStages * kSlice);  // BM x kLdC sums
  T* fring = reinterpret_cast<T*>(smem + kStages * kSlice + BM * kLdC * 4);

  const int Co = ep.Co;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n_tiles = (Co + BN - 1) / BN;
  const int items = ((M + BM - 1) / BM) * n_tiles;
  const int G = gridDim.x;
  const int nk = (C + kBK - 1) / kBK;
  const int bid = blockIdx.x;
  const int total = bid < items ? ((items - 1 - bid) / G + 1) * nk : 0;
  const bool fvec = kFloat && copy_a == kCopyFloat;
  AQuant<T> aq;
  aq.init(sx);
  const AQuant<int8_t> none{};

  auto stage = [&](int s) {  // slice s of this block's stream
    const int item = bid + (s / nk) * G, kt = s % nk;
    const int m0 = (item / n_tiles) * BM, n0 = (item % n_tiles) * BN;
    auto a_row = [&](int r) -> const T* {
      return m0 + r < M ? x + static_cast<size_t>(m0 + r) * P : nullptr;
    };
    auto b_row = [&](int r) -> const int8_t* {
      return n0 + r < Co ? w + static_cast<size_t>(n0 + r) * C : nullptr;
    };
    int8_t* d = smem + (s % kStages) * kSlice;
    if (fvec) {
      stage_float_slice<BM, kThreads>(fring + (s % (kStages - 1)) * BM * kBK, a_row, x,
                                      kt * kBK, C, tid);
    } else {
      stage_slice<BM, kThreads>(d, a_row, x, kt * kBK, C, copy_a, tid, aq);
    }
    stage_slice<BN, kThreads>(d + BM * kLdS, b_row, w, kt * kBK, C, copy_b, tid, none);
  };

  const float so = ep.out_kind == kOutInt8 ? *ep.s_out : 1.0f;
  const float rs = ep.res != nullptr ? *ep.res_scale : 0.0f;

  int acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;

  // A float slice is quantized one slice ahead: slice s + 1 after slice
  // s + 2 is issued and before slice s's mma steps, so the barrier that
  // opens slice s + 1 also covers its int8 A
  auto convert = [&](int s) {
    cp_async_wait<kStages - 2>();  // slice s has landed (this thread's copies)
    if constexpr (kFloat)
      quantize_slice<BM, kThreads>(smem + (s % kStages) * kSlice,
                                   fring + (s % (kStages - 1)) * BM * kBK, tid, aq);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) stage(s);
    cp_async_commit();
  }
  if (fvec && total > 0) convert(0);
  int kt = 0, item = bid;
  for (int s = 0; s < total; ++s) {
    if (!fvec) cp_async_wait<kStages - 2>();  // slice s has landed (this thread's copies)
    __syncthreads();               // ... and everyone's; slice s - 1 and Cs are consumed
    if (s + kStages - 1 < total) stage(s + kStages - 1);
    cp_async_commit();
    if (fvec && s + 1 < total) convert(s + 1);
    const int8_t* d = smem + (s % kStages) * kSlice;
    const int8_t* a = d + wm * 16 * kMI * kLdS;
    const int8_t* b = d + (BM + wn * 8 * kNI) * kLdS;
    mma_kstep<kMI, kNI>(a, b, 0, lane, acc);
    if (kt * kBK + 32 < C) mma_kstep<kMI, kNI>(a, b, 32, lane, acc);
    if (++kt < nk) continue;

    fragments_to_smem<kMI, kNI>(Cs, kLdC, wm * 16 * kMI, wn * 8 * kNI, lane, acc);
    __syncthreads();
    tile_epilogue<ACT, BM, kThreads>(ep, Cs, kLdC, (item / n_tiles) * BM,
                                     (item % n_tiles) * BN, M, BN / 8, tid, so, rs);
    kt = 0;
    item += G;
  }
}

// ---------------------------------------------------------------------------
// 3x3: implicit GEMM, K = 9*C ordered (tap, c)
// ---------------------------------------------------------------------------

// n / d for 0 <= n < 2^31 by a multiply and a shift, d fixed for a launch
// (Granlund and Montgomery's method, as CUTLASS's FastDivmod): the divisions
// that find a row's pixel and a K byte's tap run per tile and per slice.
struct FastDiv {
  int d;
  uint32_t mul, shr;
};

FastDiv fast_div(int d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    int l = 31 - __builtin_clz(static_cast<unsigned>(d));  // ceil(log2(d))
    if ((d & (d - 1)) != 0) ++l;
    f.mul = static_cast<uint32_t>(((1ull << (31 + l)) + d - 1) / d);
    f.shr = static_cast<uint32_t>(l - 1);
  }
  return f;
}

__device__ __forceinline__ int quot(int n, const FastDiv& f) {
  return f.d == 1 ? n : static_cast<int>(__umulhi(static_cast<uint32_t>(n), f.mul) >> f.shr);
}

// The shape of a 3x3 launch, with the divisors the kernel divides by. P: the
// pixel stride of x in elements (>= C). copy: how the A rows and the
// weights are staged.
struct Geom3x3 {
  int H, W, C, P, stride, M, copy;
  FastDiv Wo, Ho, C_div, n_tiles;
};

// An A row of the 3x3 as a thread stages it: the input pixel under tap
// (0, 0), (iy, ix) = (oy*s - 1, ox*s - 1), and `off`, its element offset in
// x (an address base only: the pixel may lie in the padding). A row past M
// has iy = -4, so that every tap misses the map.
struct TapRow {
  long long off;
  int iy, ix;
};

__device__ __forceinline__ TapRow tap_row(const Geom3x3& g, int m) {
  const int q = quot(m, g.Wo), ox = m - q * g.Wo.d;
  const int b = quot(q, g.Ho), oy = q - b * g.Ho.d;
  TapRow r;
  r.iy = m < g.M ? oy * g.stride - 1 : -4;
  r.ix = ox * g.stride - 1;
  r.off = ((static_cast<long long>(b) * g.H + r.iy) * g.W + r.ix) * g.P;
  return r;
}

// Whether tap (ky, kx) of the row falls inside the map.
__device__ __forceinline__ bool tap_in(const Geom3x3& g, const TapRow& r, int ky, int kx) {
  return static_cast<unsigned>(r.iy + ky) < static_cast<unsigned>(g.H) &&
         static_cast<unsigned>(r.ix + kx) < static_cast<unsigned>(g.W);
}

// Stages one 16-byte chunk of N rows of the 3x3 A operand into d, d + ld,
// d + 2 ld, ... by cp.async (copy kCopy16, or kCopy8 as two halves): K index
// tap*C + c is channel c of pixel (iy + tap / 3, ix + tap % 3) of the row,
// zero in the padding and from tap 9 on. (tap, c): the chunk's first byte.
template <int N>
__device__ __forceinline__ void stage_taps(int8_t* d, int ld, const int8_t* x,
                                           const TapRow (&rows)[N], int tap, int c,
                                           const Geom3x3& g) {
#pragma unroll
  for (int h = 0; h < 16; h += 8) {  // one 16-byte copy, or two 8-byte ones
    if (h % g.copy != 0) continue;
    int t = tap, cc = c + h;
    if (cc >= g.C) {  // the second half opens the next tap (C % 8 == 0)
      cc -= g.C;
      ++t;
    }
    const int ky = t / 3, kx = t - 3 * ky;
    const long long off = static_cast<long long>(ky * g.W + kx) * g.P + cc;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool in = t < 9 && tap_in(g, rows[j], ky, kx);
      const int8_t* p = in ? x + rows[j].off + off : x;
      if (g.copy == kCopy16) {
        cp_async16<true>(d + j * ld, p, in ? 16 : 0);
      } else {
        cp_async8(d + j * ld + h, p, in ? 8 : 0);
      }
    }
  }
}

// Byte-wise staging, a warp at a time: lane l loads one byte of each of N
// rows, src(i) its address for row i (or null for a zero), and stores it at
// d + i * kLdS + l. All N loads are in flight before the first store.
template <int N, typename Src>
__device__ __forceinline__ void stage_bytes(int8_t* d, Src src, int lane) {
  int8_t v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int8_t* p = src(i);
    v[i] = p != nullptr ? *p : static_cast<int8_t>(0);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) d[i * kLdS + lane] = v[i];
}

// The 1x1 kernel's loop over work items and K slices, with the A rows
// gathered from the taps. With cp.async copies a thread stages chunk
// tid % kChunks of A rows tid / kChunks, + kThreads / kChunks, ...: one
// (tap, c) for all its rows, advanced a slice at a time. Byte by byte, warp
// w stages rows w * BM / warps, ... 32 K bytes at a time, lane l byte l; lane
// i holds row i's pixel and hands it to the warp. Pixels are found once a
// tile, when the stream of staged slices reaches the tile.
template <int WARPS_M, int WARPS_N, int kMI, int kNI>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, 512 / (WARPS_M * WARPS_N * 32))
qconv3x3_mma_kernel(const int8_t* __restrict__ x,  // (B, H, W, P)
                    const int8_t* __restrict__ w,  // (Co, 3, 3, C): (Co, 9C)
                    Epilogue ep, Geom3x3 g) {
  using T = Tile<WARPS_M, WARPS_N, kMI, kNI>;
  constexpr int BM = T::BM, BN = T::BN, kThreads = T::kThreads;
  constexpr int kWarps = kThreads / 32;
  constexpr int kSlice = (BM + BN) * kLdS;
  constexpr int kLdC = BN + 8;
  constexpr int kRowStep = kThreads / kChunks;  // between a thread's A rows
  constexpr int kRows = BM / kRowStep;          // A rows a thread stages
  static_assert(BM % kRowStep == 0 && BM % kWarps == 0 && BN % kWarps == 0, "whole rows");
  static_assert(BM / kWarps <= 32, "a lane holds each row of its warp");
  extern __shared__ __align__(128) int8_t smem[];
  int* Cs = reinterpret_cast<int*>(smem + kStages * kSlice);

  const int Co = ep.Co, C = g.C, K = 9 * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n_tiles = g.n_tiles.d;
  const int items = ((g.M + BM - 1) / BM) * n_tiles;
  const int G = gridDim.x;
  const int nk = (K + kBK - 1) / kBK;
  const int bid = blockIdx.x;
  const int total = bid < items ? ((items - 1 - bid) / G + 1) * nk : 0;
  const int a_row0 = tid / kChunks, a_col = (tid % kChunks) * 16;
  const int tap0 = a_col / C, c0 = a_col - tap0 * C;

  // the next slice to stage: slice st_kt of tile st_item, ring slot st_slot
  int st_item = bid, st_kt = 0, st_slot = 0, m0 = 0, n0 = 0, tap = tap0, c = c0;
  TapRow rows[kRows];
  auto stage = [&]() {
    if (st_kt == 0) {
      const int mt = quot(st_item, g.n_tiles);
      m0 = mt * BM;
      n0 = (st_item - mt * n_tiles) * BN;
      if (g.copy == kCopyBytes) {
        rows[0] = tap_row(g, m0 + warp * (BM / kWarps) + min(lane, BM / kWarps - 1));
      } else {
#pragma unroll
        for (int j = 0; j < kRows; ++j) rows[j] = tap_row(g, m0 + a_row0 + j * kRowStep);
      }
      tap = tap0;
      c = c0;
    }
    int8_t* d = smem + st_slot * kSlice;
    const int k0 = st_kt * kBK;
    if (g.copy != kCopyBytes) {
      stage_taps<kRows>(d + a_row0 * kLdS + a_col, kRowStep * kLdS, x, rows, tap, c, g);
      auto b_row = [&](int r) -> const int8_t* {
        return n0 + r < Co ? w + static_cast<size_t>(n0 + r) * K : nullptr;
      };
      stage_slice<BN, kThreads, true>(d + BM * kLdS, b_row, w, k0, K, g.copy, tid,
                                      AQuant<int8_t>{});
      for (c += kBK; c >= C; c -= C) ++tap;
    } else {
#pragma unroll
      for (int h = 0; h < kBK; h += 32) {
        if (h > 0 && k0 + h >= K) break;  // the mma step past K is skipped: unread
        const int k = k0 + h + lane;
        const int t = quot(k, g.C_div), ky = t / 3, kx = t - 3 * ky;
        const long long off = static_cast<long long>(ky * g.W + kx) * g.P + (k - t * C);
        const bool k_in = k < K;
        const int ra = warp * (BM / kWarps), rb = warp * (BN / kWarps);
        stage_bytes<BM / kWarps>(d + ra * kLdS + h, [&](int i) -> const int8_t* {
          TapRow r;
          r.off = __shfl_sync(0xffffffffu, rows[0].off, i);
          r.iy = __shfl_sync(0xffffffffu, rows[0].iy, i);
          r.ix = __shfl_sync(0xffffffffu, rows[0].ix, i);
          return k_in && tap_in(g, r, ky, kx) ? x + r.off + off : nullptr;
        }, lane);
        stage_bytes<BN / kWarps>(d + (BM + rb) * kLdS + h, [&](int i) -> const int8_t* {
          return k_in && n0 + rb + i < Co ? w + static_cast<size_t>(n0 + rb + i) * K + k
                                          : nullptr;
        }, lane);
      }
    }
    st_slot = st_slot + 1 == kStages ? 0 : st_slot + 1;
    if (++st_kt == nk) {
      st_kt = 0;
      st_item += G;
    }
  };

  const float so = ep.out_kind == kOutInt8 ? *ep.s_out : 1.0f;
  const float rs = ep.res != nullptr ? *ep.res_scale : 0.0f;

  int acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) stage();
    cp_async_commit();
  }
  int kt = 0, item = bid;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < total) stage();
    cp_async_commit();
    const int8_t* d = smem + (s % kStages) * kSlice;
    const int8_t* a = d + wm * 16 * kMI * kLdS;
    const int8_t* b = d + (BM + wn * 8 * kNI) * kLdS;
    mma_kstep<kMI, kNI>(a, b, 0, lane, acc);
    if (kt * kBK + 32 < K) mma_kstep<kMI, kNI>(a, b, 32, lane, acc);
    if (++kt < nk) continue;

    fragments_to_smem<kMI, kNI>(Cs, kLdC, wm * 16 * kMI, wn * 8 * kNI, lane, acc);
    __syncthreads();
    const int mt = quot(item, g.n_tiles);
    const int tn0 = (item - mt * n_tiles) * BN;
    int groups = 1;  // the fewest (a power of two) that span the tile's channels
    while (groups < BN / 8 && groups * 8 < Co - tn0) groups *= 2;
    auto epilogue = [&](auto act) {
      tile_epilogue<decltype(act)::value, BM, kThreads>(ep, Cs, kLdC, mt * BM, tn0, g.M, groups,
                                                        tid, so, rs);
    };
    if (ep.act == kActSilu) {
      epilogue(std::integral_constant<int, kActSilu>());
    } else if (ep.act == kActRelu) {
      epilogue(std::integral_constant<int, kActRelu>());
    } else {
      epilogue(std::integral_constant<int, kActNone>());
    }
    kt = 0;
    item += G;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Launch state is kept per device: a process may launch on several cards,
// and the shared-memory opt-in below holds only on the device that was
// current when it was made.
constexpr int kMaxDevices = 64;

// The current device's SM count, or 0 when the runtime cannot tell.
int sm_count() {
  static int sms[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// One wave of `kernel` blocks at most (as many as the current device holds
// at once) over `items` output tiles. `resident` is the calling launcher's
// record, per device, of that wave; the first launch on a device opts the
// kernel in to its dynamic shared memory there (above the 48 KB default).
template <typename Kernel, typename... Args>
int launch_wave(Kernel kernel, int (&resident)[kMaxDevices], int threads, int smem,
                long long items, cudaStream_t stream, Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    const int sms = sm_count();
    if (sms == 0) return static_cast<int>(cudaErrorNoDevice);
    const void* fn = reinterpret_cast<const void*>(kernel);
    int per_sm = 0;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = static_cast<int>(items < resident[dev] ? items : resident[dev]);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The tile: 128 x 64 (8 warps of 32 x 32). A conv with fewer such tiles than
// the card has SMs takes 32 x 32 tiles (4 warps of 16 x 16), so that more SMs
// share its work and each thread runs 8 outputs, not 32. The 3x3 gives Co <= 32
// a 128 x 32 tile (8 warps of 16 x 32) and Co <= 16 a 256 x 16 one (8 warps of
// 32 x 16): with K up to 9C long, mma steps on columns past Co would cost more
// than the 1x1's, and the Co <= 16 convs (the tier's stems) have small K and
// many rows, so a taller tile spreads each tile's fixed cost over more rows.
using BigTile = Tile<4, 2, 2, 4>;
using SmallTile = Tile<2, 2, 1, 2>;

bool small_tiles(int M, int Co) { return BigTile::items(M, Co) < sm_count(); }

// The 1x1 of source type T, built per activation. A float source (the int8
// tier) runs with no activation only: the tier applies its own in torch.
template <int ACT, typename T>
int launch_1x1(const T* x, const int8_t* w, const Epilogue& ep, int M, int C, int P, int copy_a,
               int copy_b, const float* sx, cudaStream_t stream) {
  static int resident[2][kMaxDevices];  // small, big tile
  if (small_tiles(M, ep.Co))
    return launch_wave(qconv1x1_mma_kernel<2, 2, 1, 2, ACT, T>, resident[0], SmallTile::kThreads,
                       SmallTile::smem<T>(), SmallTile::items(M, ep.Co), stream, x, w, ep, M, C,
                       P, copy_a, copy_b, sx);
  return launch_wave(qconv1x1_mma_kernel<4, 2, 2, 4, ACT, T>, resident[1], BigTile::kThreads,
                     BigTile::smem<T>(), BigTile::items(M, ep.Co), stream, x, w, ep, M, C, P,
                     copy_a, copy_b, sx);
}

// Launches the 3x3 kernel on tile T; `resident` is T's record.
template <int WARPS_M, int WARPS_N, int MI, int NI>
int launch_3x3_on(const int8_t* x, const int8_t* w, const Epilogue& ep, Geom3x3 g,
                  int (&resident)[kMaxDevices], cudaStream_t stream) {
  using T = Tile<WARPS_M, WARPS_N, MI, NI>;
  g.n_tiles = fast_div((ep.Co + T::BN - 1) / T::BN);
  return launch_wave(qconv3x3_mma_kernel<WARPS_M, WARPS_N, MI, NI>, resident, T::kThreads,
                     T::kSmem, T::items(g.M, ep.Co), stream, x, w, ep, g);
}

int launch_3x3(const int8_t* x, const int8_t* w, const Epilogue& ep, const Geom3x3& g,
               cudaStream_t stream) {
  static int resident[4][kMaxDevices];  // small, 256 x 16, 128 x 32, 128 x 64
  if (small_tiles(g.M, ep.Co)) return launch_3x3_on<2, 2, 1, 2>(x, w, ep, g, resident[0], stream);
  if (ep.Co <= 16) return launch_3x3_on<8, 1, 2, 2>(x, w, ep, g, resident[1], stream);
  if (ep.Co <= 32) return launch_3x3_on<8, 1, 1, 4>(x, w, ep, g, resident[2], stream);
  return launch_3x3_on<4, 2, 2, 4>(x, w, ep, g, resident[3], stream);
}

bool aligned(const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

// Both launch on `stream` and return cudaGetLastError(); the caller
// allocates `out` and checks the code. x: (B, H, W) pixels of C channels,
// pixel p at x + p * pixel_stride elements (pixel_stride >= C: a channel
// slice of a wider NHWC map is read where it lies). out_kind: 0 int8,
// 1 float32, 2 bfloat16. act: 0 none, 1 SiLU, 2 ReLU. bias and res may be
// null; s_out and res_scale point at one float on the device. The copies
// (16-byte, 8-byte, or element by element) follow from C, the pixel stride
// and the alignment of x and w.
extern "C" int qconv3x3_launch(const int8_t* x, const int8_t* w, const float* scale,
                               const float* bias, const float* s_out, const int8_t* res,
                               const float* res_scale, void* out, int pixel_stride,
                               int out_kind, int act, int B, int H, int W, int C, int Co,
                               int stride, void* stream) {
  if (stride != 1 && stride != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const int M = B * Ho * Wo;
  if (M <= 0 || Co <= 0) return static_cast<int>(cudaSuccess);
  const int P = pixel_stride;
  if (C <= 0 || P < C) return static_cast<int>(cudaErrorInvalidValue);
  int copy = kCopyBytes;
  if (C % 16 == 0 && P % 16 == 0 && aligned(x, 16) && aligned(w, 16)) {
    copy = kCopy16;
  } else if (C % 8 == 0 && P % 8 == 0 && aligned(x, 8) && aligned(w, 8)) {
    copy = kCopy8;
  }
  const Epilogue ep = Epilogue{scale, bias, s_out, res, res_scale, out, out_kind, act, Co};
  const Geom3x3 g{H, W, C, P, stride, M, copy, fast_div(Wo), fast_div(Ho), fast_div(C), {}};
  return launch_3x3(x, w, ep, g, static_cast<cudaStream_t>(stream));
}

// The 1x1 also takes a float source: src_kind 0 int8, 1 bfloat16, 2 float32.
// A float source is quantized in the kernel while it stages each slice, by
// the division form at the 0-d scale sx (read for a float source only),
// bit-equal to clip(rint(x / sx), +-127); it runs with act 0 only.
extern "C" int qconv1x1_launch(const void* x, const float* sx, const int8_t* w,
                               const float* scale, const float* bias, const float* s_out,
                               const int8_t* res, const float* res_scale, void* out,
                               int src_kind, int pixel_stride, int out_kind, int act, int B,
                               int H, int W, int C, int Co, void* stream) {
  const int M = B * H * W;
  if (M <= 0 || Co <= 0) return static_cast<int>(cudaSuccess);
  const int P = pixel_stride;
  if (C <= 0 || P < C) return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep = Epilogue{scale, bias, s_out, res, res_scale, out, out_kind, act, Co};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool b16 = C % 16 == 0 && aligned(w, 16);
  if (src_kind == kSrcInt8) {
    const int copy = b16 && P % 16 == 0 && aligned(x, 16) ? kCopy16 : kCopyBytes;
    const int8_t* xi = static_cast<const int8_t*>(x);
    if (act == kActSilu) return launch_1x1<kActSilu>(xi, w, ep, M, C, P, copy, copy, nullptr, st);
    if (act == kActRelu) return launch_1x1<kActRelu>(xi, w, ep, M, C, P, copy, copy, nullptr, st);
    return launch_1x1<kActNone>(xi, w, ep, M, C, P, copy, copy, nullptr, st);
  }
  // a float source: E elements a 16-byte piece
  const int E = src_kind == kSrcBf16 ? 8 : src_kind == kSrcF32 ? 4 : 0;
  if (E == 0 || act != kActNone) return static_cast<int>(cudaErrorInvalidValue);
  const int copy_a = C % E == 0 && P % E == 0 && aligned(x, 16) ? kCopyFloat : kCopyBytes;
  const int copy_b = b16 ? kCopy16 : kCopyBytes;
  if (src_kind == kSrcBf16)
    return launch_1x1<kActNone>(static_cast<const __nv_bfloat16*>(x), w, ep, M, C, P, copy_a,
                                copy_b, sx, st);
  return launch_1x1<kActNone>(static_cast<const float*>(x), w, ep, M, C, P, copy_a, copy_b, sx,
                              st);
}
