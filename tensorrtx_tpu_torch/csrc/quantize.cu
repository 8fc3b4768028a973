// Symmetric per-tensor int8 quantization for Hopper (sm_90a): the
// round-to-nearest form and the stochastic-rounding form.
//
// Replaces the TPU kernels tensorrtx_tpu/ops/pallas/quantize.py::
// quantize_int8 and ::quantize_int8_stochastic. Per element, with s the
// per-tensor scale:
//
//   quantize_int8, recip form (the Pallas kernel's, quantize.py:22-25):
//       q = clip(rint(x * (1/s)), -127, 127)
//   quantize_int8, div form (the float-resident int8 tier's activation
//   quantize before every non-grouped conv, tensorrtx_tpu/ops/nn.py:98):
//       q = clip(rint(x / s), -127, 127)
//   quantize_int8_stochastic (quantize.py:46-52):
//       v = clip(x * (1/s), -127, 127)
//       q = floor(v) + (u < v - floor(v)),  u uniform on [0, 1) in steps of 2^-24
//
// The stochastic form rounds up with probability frac(v), as floor(v + u)
// does in exact arithmetic, but without the float add v + u, which can round
// up to the next integer (127 + (1 - 2^-24) rounds to 128): q stays within
// [floor(v), ceil(v)], so |q - v| < 1 and |q| <= 127.
//
// Bit-exactness: 1/s is one correctly rounded quotient, x * (1/s) is rounded
// once (__fmul_rn, and -fmad=false at build), and rintf rounds half to even
// as jnp.round and torch.round do. The div form takes no division per
// element: `quantize_div_bits` (quant_math.cuh, shared with the int8 1x1
// that quantizes while it stages) multiplies by 1/s and decides the values
// within 2^-13 of a half-integer by an exact FMA residual, which makes it
// x / s rounded once. So both forms equal the plain versions bit for bit. The two forms themselves can differ
// where x / s lies within an ulp of a half-integer; each is held to its own
// source.
//
// Random bits: Philox4x32-10 (Salmon et al., SC'11), counter-based. The key
// is the 64-bit seed, the counter the element index / 4, and element i takes
// word i % 4 of its counter's output. No state survives a thread or a call,
// so the plain version computes the same bits in int64 torch arithmetic.
// The TPU's own bits (pltpu.prng_random_bits) cannot be reproduced here.
//
// What bounds it: bytes. Each element is read once (4 B float32 or 2 B
// bf16) and written once (1 B int8). At the YOLO11n-640 tier's 75 conv
// inputs (19.11 M elements per image, bf16) that is 57 MB per image, about
// 17 us at 3.35 TB/s. Design: a grid-stride loop in which each thread moves
// 16 bytes of input with one vector load (4 float32 or 8 bf16) and stores
// its int8 results with one 4- or 8-byte store; the stochastic form takes
// four elements per thread, one Philox call. A pointer that is not 16-byte
// aligned (or a ragged tail) takes the element-wise path. The deterministic
// form also reads a channel slice of an NHWC map where it lies (rows of C
// elements P apart; the int8 tier's 3x3 inputs), its output contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;   // 32 blocks of 256 threads per SM

enum Kind { kF32 = 0, kBf16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// The recip form: x * (1/s) rounded once, half to even, clipped.
__device__ __forceinline__ uint32_t q_recip(float x, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
}

// q of element x in the low byte: the division form through the shared
// division-free function (quant_math.cuh), else the recip form.
__device__ __forceinline__ uint32_t q_nearest(float x, const DivQuant& dq, float inv, int div) {
  return div ? quantize_div_bits(x, dq) & 0xffu : q_recip(x, inv);
}

// The V = 16 / sizeof(T) elements of one 16-byte load u (from src) into
// out: the guesses, stored as one 4- or 8-byte word, and, if one of them
// lies near a half-integer, each byte again by the exact path, out of the
// unrolled code (read again from src).
template <typename T>
__device__ __forceinline__ void quantize_piece(const uint4& u, const T* src, int8_t* out,
                                               const DivQuant& dq, float inv, int div) {
  constexpr int V = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&u);
  uint32_t b[V], w[V / 4];
  bool near = false;
  if (div) {
    float xs[V];
#pragma unroll
    for (int k = 0; k < V; ++k) xs[k] = to_f(e[k]);
    near = quantize_div_guesses(xs, dq, b);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) b[k] = q_recip(to_f(e[k]), inv);
  }
#pragma unroll
  for (int k = 0; k < V / 4; ++k)
    w[k] = pack_low_bytes(b[4 * k], b[4 * k + 1], b[4 * k + 2], b[4 * k + 3]);
  if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(out) = w[0];
  } else {
    *reinterpret_cast<uint2*>(out) = make_uint2(w[0], w[V / 4 - 1]);
  }
  if (near) {
#pragma unroll 1
    for (int k = 0; k < V; ++k) out[k] = quantize_div_s8(to_f(src[k]), dq);
  }
}

// n elements in rows of C, row r at x + r * P (P == C: the flat array),
// into the contiguous out. With vec (x and out 16-byte aligned, and C and P
// whole loads) a thread takes one 16-byte load at a time; else an element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ s_ptr,
                int8_t* __restrict__ out, long long n, long long C, long long P, int div,
                int vec) {
  constexpr int V = 16 / sizeof(T);   // elements per 16-byte load
  const float s = *s_ptr;
  const DivQuant dq = div_quant(s);
  const float inv = __fdiv_rn(1.0f, s);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (P != C) {  // a channel slice: the row of load j (element i) found by division
    const long long per = vec ? C / V : C, units = vec ? n / V : n;
    const bool narrow = units < (1ll << 32);  // 32-bit divisions
    for (long long j = tid; j < units; j += step) {
      const long long r = narrow ? static_cast<unsigned>(j) / static_cast<unsigned>(per) : j / per;
      const long long off = r * P + (j - r * per) * (vec ? V : 1);
      if (vec) {
        quantize_piece(*reinterpret_cast<const uint4*>(x + off), x + off, out + j * V, dq, inv,
                       div);
      } else {
        out[j] = static_cast<int8_t>(q_nearest(to_f(x[off]), dq, inv, div));
      }
    }
    return;
  }
  const long long n_vec = vec ? n / V : 0;
  for (long long i = tid; i < n_vec; i += step) {
    quantize_piece(reinterpret_cast<const uint4*>(x)[i], x + i * V, out + i * V, dq, inv, div);
  }
  for (long long i = n_vec * V + tid; i < n; i += step) {
    out[i] = static_cast<int8_t>(q_nearest(to_f(x[i]), dq, inv, div));
  }
}

// Philox4x32-10: ten rounds, the key bumped by the Weyl constants before
// every round but the first (Random123's philox4x32_R).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t q_stochastic(float x, float inv, uint32_t bits) {
  const float v = fminf(fmaxf(__fmul_rn(x, inv), -127.0f), 127.0f);
  const float fl = floorf(v);
  const float u = __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-8f);  // 2^-24
  const float q = u < __fsub_rn(v, fl) ? __fadd_rn(fl, 1.0f) : fl;
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_sr_kernel(const T* __restrict__ x, const float* __restrict__ s_ptr,
                   int8_t* __restrict__ out, long long n, uint32_t k0, uint32_t k1,
                   int vec) {
  const float inv = __fdiv_rn(1.0f, *s_ptr);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long groups = (n + 3) / 4;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += step) {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), 0u, 0u), k0, k1);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
    const long long i0 = 4 * g;
    if (vec && i0 + 4 <= n) {
      float e[4];
      if constexpr (sizeof(T) == 4) {
        const float4 v = reinterpret_cast<const float4*>(x)[g];
        e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
      } else {
        const uint2 v = reinterpret_cast<const uint2*>(x)[g];
        const T* h = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) e[k] = to_f(h[k]);
      }
      uint32_t w = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) w |= q_stochastic(e[k], inv, bits[k]) << (8 * k);
      reinterpret_cast<uint32_t*>(out)[g] = w;
    } else {
      for (int k = 0; k < 4 && i0 + k < n; ++k) {
        out[i0 + k] = static_cast<int8_t>(q_stochastic(to_f(x[i0 + k]), inv, bits[k]));
      }
    }
  }
}

int blocks_for(long long units) {
  const long long b = (units + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError(); the caller
// allocates `out` (n int8, contiguous) and checks the code. kind: 0
// float32, 1 bf16. s points at one float on the device. vec != 0 promises
// that x and out are 16-byte aligned.
//
// quantize_int8_launch reads x as rows of C elements (C divides n), row r at
// x + r * P (P >= C: a channel slice of a wider NHWC map, read where it
// lies; P == C: contiguous). div != 0 selects x / s, else x * (1/s).
extern "C" int quantize_int8_launch(const void* x, const float* s, int8_t* out, long long n,
                                    long long C, long long P, int kind, int div, int vec,
                                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (C <= 0 || P < C || n % C != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int V = kind == kF32 ? 4 : 8;
  // a slice takes 16-byte loads only if its rows are whole loads apart
  const int v = vec && (P == C || (C % V == 0 && P % V == 0));
  const long long units = v ? n / V + 1 : n;
  if (kind == kF32) {
    quantize_kernel<float><<<blocks_for(units), kThreads, 0, st>>>(
        static_cast<const float*>(x), s, out, n, C, P, div, v);
  } else {
    quantize_kernel<__nv_bfloat16><<<blocks_for(units), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), s, out, n, C, P, div, v);
  }
  return static_cast<int>(cudaGetLastError());
}

// seed_lo / seed_hi are the Philox key words.
extern "C" int quantize_int8_stochastic_launch(const void* x, const float* s, int8_t* out,
                                               long long n, int kind,
                                               unsigned int seed_lo, unsigned int seed_hi,
                                               int vec, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for((n + 3) / 4);
  if (kind == kF32) {
    quantize_sr_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), s, out, n, seed_lo, seed_hi, vec);
  } else {
    quantize_sr_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), s, out, n, seed_lo, seed_hi, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
