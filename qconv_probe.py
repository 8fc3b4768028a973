"""Where the int8 convs' time goes, on one NVIDIA card.

    python3 qconv_probe.py [--against NAME=path/to/qconv.cu ...]

Builds `tensorrtx_tpu_torch/csrc/qconv.cu` as `chip_smoke.py` does and
prints one JSON line per measurement:

  epilogue   qconv1x1 at three shapes of the int8 paths with each
             activation (none, SiLU) and exit (int8, bf16, float32), and the
             GEMM-exact form (float32, scale 1, no bias); beside them
             `torch._int_mm` on the same operands and the shape's byte bound
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
random, as in `chip_smoke.py`; the tier is calibrated with absmax (its conv
shapes do not depend on the method). Exits non-zero without a CUDA device.
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
    types them."""
    fns = {}
    for k, n_int in ((3, 9), (1, 8)):
        fn = getattr(lib, f"qconv{k}x{k}_launch")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * n_int + [ctypes.c_void_p]
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


def probe_paths(device, libs):
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    ce = cs._chained("bf16", device, cs.SIZE, conf_thresh=0.25)
    cal, _ = cs.frames_of(cs.synthetic_frames(4, [(cs.SIZE, cs.SIZE)] * cs.CAL_FRAMES),
                          (cs.SIZE, cs.SIZE))
    ce.calibrate([cal])
    qe, _, _ = cs._calibrated("bf16", device, cs.SIZE, "absmax", conf_thresh=0.25)
    paths = {"chain": cs.main_path_qconvs(ce, cs.SIZE),
             "tier": cs.fq_main_path_calls(qe, cs.SIZE)[0]}
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
                    help="another qconv.cu to time on the paths' 3×3 and 1×1 shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("qconv_probe: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = _builds(args.against, Path(__file__).resolve().parent / "tensorrtx_tpu_torch" / "_build")
    probe_epilogue(device)
    if args.against:
        probe_paths(device, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
