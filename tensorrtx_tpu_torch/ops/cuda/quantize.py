"""Symmetric per-tensor int8 quantization: the CUDA kernels
`csrc/quantize.cu` and their plain PyTorch versions.

Replace the TPU kernels `tensorrtx_tpu/ops/pallas/quantize.py::
quantize_int8` and `::quantize_int8_stochastic`:

    quantize_int8(x, s)                  clip(round(x · (1/s)), ±127)   the Pallas kernel's form
    quantize_int8(x, s, divide=True)     clip(round(x / s), ±127)       the float-resident int8
                                                                         tier's (`ops/nn.py:98`)
    quantize_int8_stochastic(x, s, seed) v = clip(x · (1/s), ±127); floor(v) + (u < frac(v))

``round`` is half to even. The two deterministic forms can differ where
x / s lies within an ulp of a half-integer, so each is held to its own
source. The stochastic form's u comes from Philox4x32-10 keyed by the
64-bit seed (counter = element index // 4, word = index % 4), so the
kernel and `quantize_int8_stochastic_plain` draw the same bits; the TPU's
own random bits cannot be reproduced.

x is float32 or bfloat16 of any shape: contiguous, or, for
`quantize_int8`, rows of its last dimension (at stride 1) one stride apart,
as a channel slice of an NHWC map is (the kernel reads it where it lies;
the output is contiguous). s is a 0-d float32 tensor (read by the kernel on
the device, no host sync) or a Python float. The wrappers launch the kernel
for CUDA tensors and raise if they cannot; they take the plain version only
for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from tensorrtx_tpu_torch.ops.cuda import build

__all__ = ["quantize_int8", "quantize_int8_plain", "quantize_int8_div_free",
           "quantize_int8_stochastic",
           "quantize_int8_stochastic_plain", "philox4x32_10", "launches",
           "launches_stochastic"]

# Launches of each CUDA kernel in this process (not of the plain versions).
# A launch captured into a CUDA graph counts once, when it is captured;
# the graph's replays launch it again without counting.
launches = 0
launches_stochastic = 0

_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_MASK = 0xFFFFFFFF

_fns = {}


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("quantize"), name)
        if name == "quantize_int8_launch":       # x, s, out, n, C, P, kind, div, vec, stream
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        else:                                    # x, s, out, n, kind, k0, k1, vec, stream
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                    ctypes.c_uint, ctypes.c_uint,
                                                    ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _scalar(v, device) -> torch.Tensor:
    """A 0-d float32 tensor on `device` from a tensor or a Python float."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _reciprocal(s: torch.Tensor) -> torch.Tensor:
    # a true division: `1.0 / tensor` may run as a reciprocal instruction
    return torch.ones_like(s) / s


def quantize_int8_plain(x: torch.Tensor, scale, divide: bool = False) -> torch.Tensor:
    """The kernel's contract in plain torch ops, in float32."""
    s = _scalar(scale, x.device)
    v = x.float() / s if divide else x.float() * _reciprocal(s)
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def quantize_int8_div_free(x: torch.Tensor, scale) -> torch.Tensor:
    """The division form as the kernels compute it (`csrc/quant_math.cuh`),
    in torch ops, with x and s first scaled by 2⁶⁴ when |s| < 2⁻¹⁰⁰ and by
    2⁻⁶⁴ when |s| > 2¹⁰⁰: ``v = clip(x · fl(1/s), ±127)`` rounded half to
    even, except where v lies within 2⁻¹³ of a half-integer h (no such guard
    when s is ±2ᵏ: x·(1/s) is then x / s). There the exact residual
    c = x − h·s (the kernels' FMA; float64 here, exact too) decides: fl(x / s) is h when |c|
    is under half an ulp of h times |s| (or equal to it, with h's last
    mantissa bit even), and q is then the even neighbour round(h); else q is
    h ± ½ on the side of c / s. Equal to ``quantize_int8_plain(x, s,
    divide=True)`` for every input; the tests hold it so."""
    s = _scalar(scale, x.device)
    a = abs(float(s))
    k = 2.0 ** 64 if a < 2.0 ** -100 else 2.0 ** -64 if a > 2.0 ** 100 else 1.0
    ks = s * k
    xk = x.float() * k
    v = torch.clamp(xk * _reciprocal(ks), -127, 127)
    n = torch.round(v)
    bits = int(ks.cpu().view(torch.int32))
    if (bits & 0x7FFFFF) == 0 and (bits >> 23) & 0xFF != 0:
        return n.to(torch.int8)
    d = v - n
    near = d.abs() >= 0.5 - 2.0 ** -13
    h = n + torch.copysign(torch.full_like(d, 0.5), d)
    c = (xk.double() - h.double() * ks.double()).float()
    hb = h.view(torch.int32)
    half_ulp = (((hb >> 23) & 0xFF) - 24).bitwise_left_shift(23).view(torch.float32)
    lim = half_ulp * ks.abs()
    at_h = (c.abs() < lim) | ((c.abs() == lim) & (hb & 1 == 0))
    y = torch.where(at_h, torch.round(h), torch.where((c > 0) == bool(ks > 0), h + 0.5, h - 0.5))
    return torch.where(near, torch.clamp(y, -127, 127), n).to(torch.int8)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a · m for int64 tensors a < 2³² and a
    32-bit constant m, without overflowing int64."""
    p_lo = a * (m & 0xFFFF)                    # < 2⁴⁸
    p_hi = a * (m >> 16)                       # < 2⁴⁸
    return (p_hi + (p_lo >> 16)) >> 16, (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Random123's philox4x32_R with R = 10) on int64 tensors
    holding 32-bit words: counter (c0, c1, c2, c3), key (k0, k1)."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _MASK, (k1 + 0xBB67AE85) & _MASK
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _seed_words(seed: int):
    seed = int(seed) % (1 << 64)
    return seed & _MASK, seed >> 32


def quantize_int8_stochastic_plain(x: torch.Tensor, scale, seed: int) -> torch.Tensor:
    """The stochastic kernel's contract in plain torch ops: the same Philox
    bits in int64 arithmetic, the same float32 steps."""
    k0, k1 = _seed_words(seed)
    v = torch.clamp(x.float().reshape(-1) * _reciprocal(_scalar(scale, x.device)), -127, 127)
    n = v.numel()
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=x.device)
    zero = torch.zeros_like(g)
    bits = torch.stack(philox4x32_10(g & _MASK, g >> 32, zero, zero, k0, k1), 1).reshape(-1)[:n]
    u = (bits >> 8).float() * 2.0 ** -24
    fl = torch.floor(v)
    return (fl + (u < v - fl).float()).to(torch.int8).reshape(x.shape)


def _check(x: torch.Tensor):
    if x.dtype not in _KINDS:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (the kernels read it as a flat array)")


def _rows(x: torch.Tensor):
    """(C, P): x read as rows of C elements P apart, the form
    `quantize_int8_launch` takes. A contiguous x is one flat row (C = P =
    numel); otherwise the rows are its last dimension, at stride 1, with the
    other dimensions laying them out one stride P >= C apart (a channel
    slice of an NHWC map). Raises for any other layout: the kernel does not
    copy."""
    if x.dtype not in _KINDS:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.is_contiguous():
        return x.numel(), x.numel()
    c = x.shape[-1]
    dims = [(n, st) for n, st in zip(x.shape[:-1], x.stride()[:-1]) if n > 1]
    p = dims[-1][1] if dims else c
    if not ((c == 1 or x.stride(-1) == 1) and p >= c
            and all(s0 == s1 * n1 for (_, s0), (n1, s1) in zip(dims, dims[1:]))):
        raise ValueError(f"x {tuple(x.shape)} with strides {x.stride()} is neither contiguous "
                         "nor rows of its last dimension (at stride 1) one stride apart")
    return c, p


def _launch(name, x, scale, *args, rows=None):
    if x.device.type != "cuda":
        raise ValueError(f"no quantize kernel for device {x.device}")
    s = _scalar(scale, x.device)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    head = [x.data_ptr(), s.data_ptr(), out.data_ptr(), x.numel()] + list(rows or ())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher(name)(*head, _KINDS[x.dtype], *args, vec, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    return out


def quantize_int8(x: torch.Tensor, scale, divide: bool = False) -> torch.Tensor:
    """x (any shape) float32/bf16, scale per tensor → int8 of x's shape
    (contiguous), round half to even, saturated to ±127: ``x · (1/s)`` (the
    Pallas kernel's form) or, with ``divide``, ``x / s`` (the int8 tier's).
    x is contiguous or a channel slice (see the module docstring)."""
    global launches
    rows = _rows(x)
    if x.device.type == "cpu":
        return quantize_int8_plain(x, scale, divide).contiguous()
    out = _launch("quantize_int8_launch", x, scale, int(divide), rows=rows)
    launches += 1
    return out


def quantize_int8_stochastic(x: torch.Tensor, scale, seed: int) -> torch.Tensor:
    """Stochastic-rounding int8 quantize of x (any shape) float32/bf16:
    ``floor(v) + (u < frac(v))`` with ``v = clip(x · (1/s), ±127)`` and u
    uniform on [0, 1) from Philox4x32-10 keyed by ``seed`` (0 ≤ seed < 2⁶⁴;
    other ints are taken mod 2⁶⁴). The same seed gives the same output."""
    global launches_stochastic
    _check(x)
    if x.device.type == "cpu":
        return quantize_int8_stochastic_plain(x, scale, seed)
    out = _launch("quantize_int8_stochastic_launch", x, scale, *_seed_words(seed))
    launches_stochastic += 1
    return out
