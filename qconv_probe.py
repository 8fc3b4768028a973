"""Where the int8 convs' time goes, on one NVIDIA card.

    python3 qconv_probe.py [--tier] [--layer [--package DIR]]
                           [--against NAME=path/to/qconv.cu ...]

Builds `tensorrtx_tpu_torch/csrc/qconv.cu` as `chip_smoke.py` does and
prints one JSON line per measurement:

  epilogue   qconv1x1 at three shapes of the int8 paths with each
             activation (none, SiLU) and exit (int8, bf16, float32), and the
             GEMM-exact form (float32, scale 1, no bias); beside them
             `torch._int_mm` on the same operands and the shape's byte bound
  tier       with --tier: `chip_smoke.phase_qconv_tier`, the float-resident
             tier's launches from their bf16 inputs (the 1×1 quantizing in
             the kernel, the 3×3 after quantize_int8) against the unfused
             route (copy, quantize_int8, int8-source conv) at B = 1 and 32,
             with the time per shape of both kernels in both routes
  layer      with --layer: the tier's int8-conv layer of one forward, every
             `ops/quant_ctx.quant_conv2d` call (80) on bf16 inputs laid out
             as the forward lays them out, timed together at B = 1 and 32
             with its largest device items; --package DIR times the
             `tensorrtx_tpu_torch` under DIR (another checkout, such as the
             parent commit unpacked), so that two trees can be timed on
             the same card in turns, each in its own process
  paths      with --against: every 3×3 and every 1×1 launch of one forward
             of the chained int8 path and of the float-resident tier, at
             B = 1 and 32, timed for this build and for each named source
             built with the same flags (the same exported `qconv3x3_launch`
             and `qconv1x1_launch`), in turns (this, other, other, this);
             the GEMM-exact output of each build must be bit-equal to the
             plain version's sums; then, at B = 32, each build's 3×3 time
             per distinct launch shape (`qconv3x3_shapes`, path
             "<path>:<build>")

Device times come from `torch.profiler` (`chip_smoke._timings`). Weights are
random, as in `chip_smoke.py`; the tier is calibrated as there (entropy on 8
frames): the scales set where x / sx falls against half-integers, which the
1×1's quantize pays for. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

# (B, H, W, C, Co): two of the chain's largest 1×1 convs at B = 32, a head conv at B = 1
EPILOGUE_SHAPES = [
    (32, 80, 80, 80, 80), (32, 80, 80, 64, 64), (1, 20, 20, 128, 64)]


def _launchers(lib):
    """{k: the library's qconv{k}x{k}_launch}, typed as ops/cuda/qconv.py
    types them (the other source must export the same interface)."""
    fns = {}
    for k, n in ((3, 8), (1, 9)):   # n pointers, then 9 ints (`qconv._launcher`)
        fn = getattr(lib, f"qconv{k}x{k}_launch")
        fn.argtypes = [ctypes.c_void_p] * n + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[k] = fn
    return fns


def _builds(against, out_dir):
    """name → {k: qconv{k}x{k}_launch} of this checkout's build and of each
    other source, compiled with the same nvcc flags."""
    from tensorrtx_tpu_torch.ops.cuda import build

    libs = {"this": _launchers(build.load("qconv"))}
    out_dir.mkdir(parents=True, exist_ok=True)
    for spec in against:
        name, src = spec.split("=", 1)
        out = out_dir / f"libqconv_{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *build.KERNELS["qconv"][1], "-o",
               str(out), src]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        libs[name] = _launchers(ctypes.CDLL(str(out.resolve())))
    return libs


def probe_epilogue(device):
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    rng = np.random.default_rng(3)
    for b, h, w, c, co in EPILOGUE_SHAPES:
        xq = torch.from_numpy(rng.integers(-127, 128, (b, h, w, c), dtype=np.int8)).to(device)
        wq = torch.from_numpy(rng.integers(-127, 128, (co, 1, 1, c), dtype=np.int8)).to(device)
        scale = torch.full((co,), 1e-4, device=device)
        bias = torch.from_numpy(rng.normal(0, 0.3, co).astype(np.float32)).to(device)
        s_out = torch.tensor(0.05, device=device)
        fns = {}
        for act in (None, "silu"):
            for out in ("int8", "bf16", "f32"):
                kw = {"act": act, "out_float": out != "int8",
                      "out_dtype": torch.bfloat16 if out == "bf16" else torch.float32}
                fns[f"{act or 'none'}_{out}_us"] = (
                    lambda kw=kw: qk.qconv1x1(xq, wq, scale, bias, s_out, **kw), 20)
        ones = torch.ones_like(scale)
        fns["gemm_exact_us"] = (lambda: qk.qconv1x1(xq, wq, ones, None, None, act=None,
                                                    out_float=True, out_dtype=torch.float32), 20)
        fns["int_mm_us"] = (lambda: torch._int_mm(xq.reshape(-1, c), wq.reshape(co, c).t()), 20)
        t = cs._timings(**fns)
        spec = {"hw": (h, w), "c": c, "wq": wq, "kw": {"out_float": False}, "residual": False}
        row = {k: v * 1e3 for k, v in t.items() if k != "ms_source"}
        cs.log("epilogue", batch=b, hw=[h, w], c=c, co=co, outputs=b * h * w * co,
               bound_int8_exit_us=cs._qconv_work(spec, b)[0] / cs.HBM_BYTES_PER_S * 1e6,
               ms_source=t["ms_source"], **row)


def probe_tier_layer(device, top=8):
    """Every `quant_conv2d` call of one tier forward, recorded at B = 1
    (kernel, channels, pixel stride, map size, weights, scales), then timed
    together at each batch on random bf16 inputs of the same layout: the
    last C channels of a ``channels_last`` map as wide as the pixel stride,
    viewed as NCHW, with |x / sx| up to about 200. Whatever the timed tree's
    `quant_conv2d` does with its input (copies, quantize launches, the
    kernels) is in the time."""
    from tensorrtx_tpu_torch.ops import quant_ctx

    qe, _, _ = cs._calibrated("bf16", device, cs.SIZE, "entropy", conf_thresh=0.25)
    specs, real = [], quant_ctx.quant_conv2d

    def hook(x, wq, scale, sx, bias, stride):
        b, c, h, w = x.shape
        specs.append((c, x.stride(3) if w > 1 else c, h, w, wq, scale, sx, bias, stride))
        return real(x, wq, scale, sx, bias, stride)
    quant_ctx.quant_conv2d = hook
    try:
        qe(np.zeros((1, cs.SIZE, cs.SIZE, 3), np.float32))
    finally:
        quant_ctx.quant_conv2d = real
    gen = torch.Generator(device=device).manual_seed(21)
    for b in (1, 32):
        calls = []
        for c, p, h, w, wq, scale, sx, bias, stride in specs:
            wide = (torch.randn((b, p, h, w), generator=gen, device=device) * (50 * sx)).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            calls.append((wide[:, p - c:], wq, scale, sx, bias, stride))
        outs = [real(*a) for a in calls]
        if not all(bool(torch.isfinite(o.float()).all()) for o in outs):
            raise AssertionError("the tier's int8 convs gave non-finite outputs")
        del outs
        row = {}
        for k in (3, 1):
            sel = [a for a in calls if a[1].shape[1] == k]
            row[f"ms_{k}x{k}"] = cs._timings(ms=(lambda: [real(*a) for a in sel], 10))["ms"]
        ms, items, source = cs._device_profile(lambda: [real(*a) for a in calls], 10, top)
        cs.log("tier_layer", package=str(Path(quant_ctx.__file__).resolve().parents[2]),
               batch=b, calls=len(calls), sliced=sum(sp[1] != sp[0] for sp in specs), ms=ms,
               **row, ms_source=source, top_device_items=items)


def probe_paths(device, libs):
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    ce = cs._chained("bf16", device, cs.SIZE, conf_thresh=0.25)
    cal, _ = cs.frames_of(cs.synthetic_frames(4, [(cs.SIZE, cs.SIZE)] * cs.CAL_FRAMES),
                          (cs.SIZE, cs.SIZE))
    ce.calibrate([cal])
    qe, _, _ = cs._calibrated("bf16", device, cs.SIZE, "entropy", conf_thresh=0.25)
    paths = {"chain": cs.main_path_qconvs(ce, cs.SIZE),
             "tier": [dict(sp, kw={k: v for k, v in sp["kw"].items() if k != "sx"})
                      for sp in cs.fq_main_path_calls(qe, cs.SIZE)]}   # int8 sources
    rng = np.random.default_rng(7)
    names = list(libs)
    order = [names[0], *names[1:], *names[1:][::-1], names[0]]
    try:
        for path, all_specs in paths.items():
            for kernel, k in (("qconv3x3", 3), ("qconv1x1", 1)):
                fn = getattr(qk, kernel)
                specs = [s for s in all_specs if s["name"] == kernel]
                for b in (1, 32):
                    calls = [cs._qconv_args(sp, b, rng, device) for sp in specs]
                    row = {}
                    for name in names:
                        qk._fns[k] = libs[name][k]
                        for (a, kw), sp in zip(calls, specs):
                            cs._check_gemm_exact(f"{name} {path} B={b} {sp['hw']} C={sp['c']}",
                                                 a, kw)
                    for name in order:
                        qk._fns[k] = libs[name][k]
                        t = cs._timings(ms=(lambda: [fn(*a, **kw) for a, kw in calls], 10))
                        row.setdefault(f"{name}_ms", []).append(t["ms"])
                    lib = {}
                    if k == 1:   # the same GEMM; the 3×3's im2col yardstick is in chip_smoke.py
                        mats = [(a[0].reshape(-1, a[0].shape[-1]),
                                 a[1].reshape(a[1].shape[0], -1).t()) for a, _ in calls]
                        lib["library_ms"] = cs._timings(
                            ms=(lambda: [torch._int_mm(x, w) for x, w in mats], 10))["ms"]
                    n_bytes = sum(cs._qconv_work(sp, b)[0] for sp in specs)
                    cs.log("paths", kernel=kernel, path=path, batch=b, launches=len(specs),
                           gemm_exact="bit-equal", bound_ms=n_bytes / cs.HBM_BYTES_PER_S * 1e3,
                           **lib, **row)
                    if k == 3 and b == 32:
                        for name in names:
                            qk._fns[k] = libs[name][k]
                            cs._qconv3x3_per_shape(f"{path}:{name}",
                                                   [(a, kw, sp) for (a, kw), sp in zip(calls, specs)],
                                                   b)
    finally:
        qk._fns.clear()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=SRC.cu",
                    help="another qconv.cu (same interface, beside its own quant_math.cuh) "
                         "to time on the paths' 3×3 and 1×1 shapes")
    ap.add_argument("--tier", action="store_true",
                    help="time the tier's launches against the unfused route")
    ap.add_argument("--layer", action="store_true",
                    help="time the tier's quant_conv2d calls of one forward")
    ap.add_argument("--package", metavar="DIR",
                    help="with --layer: time the tensorrtx_tpu_torch under DIR")
    args = ap.parse_args(argv)
    if args.package:
        sys.path.insert(0, str(Path(args.package).resolve()))
    if not torch.cuda.is_available():
        print("qconv_probe: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.layer:
        probe_tier_layer(device)
        return 0
    libs = _builds(args.against, Path(__file__).resolve().parent / "tensorrtx_tpu_torch" / "_build")
    probe_epilogue(device)
    if args.tier:
        qe, _, _ = cs._calibrated("bf16", device, cs.SIZE, "entropy", conf_thresh=0.25)
        cs.phase_qconv_tier(device, cs.fq_main_path_calls(qe, cs.SIZE))
    elif args.against:
        probe_paths(device, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
