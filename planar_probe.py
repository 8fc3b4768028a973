"""The planar convs' launches timed in a fresh process, on one NVIDIA card.

    python3 planar_probe.py [--package DIR] [--iters N]

Times `conv3x3_planar` and `conv1x1_planar` at `chip_smoke.PLANAR_SHAPES`
(float32 and bf16, B = 1 and 32), as `chip_smoke.phase_planar` does but
alone in its process, and prints one JSON line per kernel, dtype and
batch: the device time of all the kernel's shapes together by
`torch.profiler` (`chip_smoke._device_profile`, over 5 and over --iters
calls), by CUDA events around --iters calls (which count the gaps
between launches too) and around --iters calls queued behind a GPU sleep
(`core/profiler.queued_ms`, as `phase_planar` times them; no gaps), each
shape alone by the profiler, and `F.conv2d`
(conv + bias on a contiguous NCHW copy, TF32 off) over the same shapes,
and the card's SM and memory clocks just before and just after those
timed windows (`nvidia-smi`).
--package DIR times the `tensorrtx_tpu_torch` under DIR (another checkout
that has `core/profiler.py`, such as the parent commit unpacked), so that
two trees can be timed on the same card in turns, each in its own
process. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

import chip_smoke as cs


def _event_ms(fn, iters):
    """Mean ms per call of fn by CUDA events around `iters` calls, after one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", metavar="DIR",
                    help="time the tensorrtx_tpu_torch under DIR instead of this checkout's")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if args.package:
        sys.path.insert(0, str(Path(args.package).resolve()))
    if not torch.cuda.is_available():
        print("planar_probe: no CUDA device", file=sys.stderr)
        return 1
    from tensorrtx_tpu_torch.core.profiler import queued_ms
    from tensorrtx_tpu_torch.ops.cuda import conv_planar as cp

    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    package = str(Path(cp.__file__).resolve().parents[3])
    fns = {3: cp.conv3x3_planar, 1: cp.conv1x1_planar}
    gen = torch.Generator(device=device).manual_seed(13)
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 32):
            for k in (3, 1):
                calls = [cs._planar_args(spec, b, dtype, gen, device)
                         for spec in cs.PLANAR_SHAPES if spec[0] == k]
                lib = [(x.permute(0, 2, 1, 3).contiguous(),
                        w.permute(3, 2, 0, 1).to(dtype).contiguous(), bb.to(dtype))
                       for x, w, bb, _, _ in calls]

                def run(cs_=calls, k_=k):
                    return [fns[k_](x, w, bb, residual=r, act=a) for x, w, bb, r, a in cs_]

                st = {"clocks_before": cs.gpu_clocks()}
                every = ("planar_kernel", len(calls))   # a window must record every launch
                st |= {f"ms_{n}": cs._device_profile(run, n, top=0, expect=every)[0]
                       for n in (5, args.iters)}
                st["events_ms"] = _event_ms(run, args.iters)
                st["queued_ms"] = queued_ms(run, args.iters)
                st["per_shape_ms"] = [cs._device_profile(lambda c=c: run([c]), args.iters, top=0,
                                                         expect=("planar_kernel", 1))[0]
                                      for c in calls]
                st["library_ms"] = cs._device_profile(
                    lambda: [F.conv2d(x, w, bb, padding=k // 2) for x, w, bb in lib],
                    args.iters, top=0)[0]
                st["clocks_after"] = cs.gpu_clocks()
                cs.log("planar_probe", kernel=f"conv{k}x{k}_planar", batch=b, dtype=str(dtype),
                       package=package, gpu=gpu, **st)
    return 0


if __name__ == "__main__":
    sys.exit(main())
