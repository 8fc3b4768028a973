"""GPU smoke run of the port (tensorrtx_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout and holds each
against its plain PyTorch version, then drives the port's two serving
paths at full width (YOLO11n, 640²) and shows that each went through its
kernels:

  env              card, toolchain, nvcc build of every kernel (ptxas report)
  kernel_vs_plain  nms_mask (B = 1, 32) and the int8 convs qconv3x3 /
                   qconv1x1 at every shape of the int8 path (B = 1, 32),
                   with residual, float-exit and 173×16×128 extras; device
                   time of kernel, plain version and library call, and the
                   bound
  int8_shadow      one chained int8 forward (B = 2) with every qconv launch
                   recomputed by its plain version on the same inputs
  int8_parity      the float32-island int8 chain on the card against the
                   port's CPU path, same scales: raw outputs and detections
  int8_serving     `ChainedInt8Engine` (bf16 islands) calibrated on 8
                   frames, serving b1 requests and b32 batches through
                   ``__call__`` + `present_detections` (this slice's path)
  f32_parity       the float32 float path on the card against the CPU path
  serving          bf16 `ServingPipeline.detect_images` b1/b32 (the float path)

Weights are random (`RandomWeightMap(seed=0)`); no file outside the
checkout is read. Exits non-zero, without the result line, if there is no
CUDA device or any phase fails. It imports neither JAX nor the JAX package.

Output: one JSON line per phase, then the card's name and power limit, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

SIZE = 640               # YOLO11n published input
N_CAND = 300             # the main path's max_det: NMS candidates per image
NMS_THRESH = 0.45
BUCKET = (640, 640)      # the serving frames' static source bucket
CAL_FRAMES = 8           # calibration frames of the int8 tier

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the peak
# rate for their type
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
NMS_FLOPS_PER_PAIR = 18          # one IoU test in nms_mask.cu: min/max, subs, products, a divide


def log(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def adversarial_candidates(seed, b, n=N_CAND, nc=3, n_invalid=40, thresh=NMS_THRESH):
    """NMS inputs that stress ordering: scores from 7 levels (many exact
    ties), exact duplicate boxes, shifted copies near the IoU threshold, a
    tail of invalid (score 0) slots, 3 classes; sorted by descending score.
    No pair's IoU lies within 1e-5 of the threshold, so both versions must
    agree exactly rather than within an ulp of the edge."""
    rng = np.random.default_rng(seed)
    cx, cy = rng.uniform(0, 100, (2, b, n))
    w, h = rng.uniform(5, 40, (2, b, n))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    m = boxes[:, 1::7].shape[1]
    boxes[:, 1::7] = boxes[:, 0:-1:7][:, :m]
    m = boxes[:, 2::5].shape[1]
    boxes[:, 2::5] = (boxes[:, 1:-1:5][:, :m]
                      + rng.uniform(0.05, 0.5, (b, m, 1)) * w[:, 2::5, None])
    boxes = boxes.astype(np.float32)
    for _ in range(100):
        # move the later box of each pair on the edge
        near = np.tril(np.abs(_iou64(boxes) - np.float32(thresh)) < 1e-5, -1)
        edge = near.any(-1)
        if not edge.any():
            break
        boxes[edge] += np.float32(0.37)
    else:
        raise RuntimeError("could not move the candidates off the IoU edge")
    scores = rng.choice(np.linspace(0.3, 0.9, 7), (b, n)).astype(np.float32)
    classes = rng.integers(0, nc, (b, n)).astype(np.float32)
    o = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, o[..., None], 1)
    scores = np.take_along_axis(scores, o, 1)
    classes = np.take_along_axis(classes, o, 1)
    scores[:, n - n_invalid:] = 0.0
    return boxes, scores, classes


def _iou64(boxes):
    """(..., N, 4) → (..., N, N) IoU in float64, diagonal 0."""
    b = boxes.astype(np.float64)
    x1, y1, x2, y2 = (b[..., i] for i in range(4))
    iw = np.minimum(x2[..., :, None], x2[..., None, :]) - np.maximum(x1[..., :, None], x1[..., None, :])
    ih = np.minimum(y2[..., :, None], y2[..., None, :]) - np.maximum(y1[..., :, None], y1[..., None, :])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    iou = inter / np.maximum(area[..., :, None] + area[..., None, :] - inter, 1e-30)
    n = iou.shape[-1]
    iou[..., np.arange(n), np.arange(n)] = 0.0
    return iou


def synthetic_frames(seed, shapes):
    """uint8 images of the given (h, w): gradients, flat rectangles and
    noise, each in the top-left corner of a BUCKET frame."""
    rng = np.random.default_rng(seed)
    images = []
    for h, w in shapes:
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 127 // (h + w)],
                       -1).astype(np.float64)
        for _ in range(12):
            y0, x0 = rng.integers(0, h - 20), rng.integers(0, w - 20)
            hh, ww = rng.integers(10, h // 2), rng.integers(10, w // 2)
            img[y0:y0 + hh, x0:x0 + ww] = rng.integers(0, 256, 3)
        img += rng.normal(0, 8, img.shape)
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    return images


def frames_of(images, bucket=BUCKET):
    frames = np.zeros((len(images), *bucket, 3), np.uint8)
    src_hw = np.zeros((len(images), 2), np.int32)
    for i, im in enumerate(images):
        frames[i, :im.shape[0], :im.shape[1]] = im
        src_hw[i] = im.shape[:2]
    return frames, src_hw


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env():
    from tensorrtx_tpu_torch.ops.cuda import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = build.nvcc_path()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    report = build.build()
    build_s = time.perf_counter() - t0
    ptxas = {k: [ln.strip() for ln in v["log"].splitlines()
                 if "registers" in ln or "smem" in ln] for k, v in report.items()}
    log("env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc_ver, kernels_built=sorted(report), build_s=round(build_s, 3),
        ptxas=ptxas)
    return smi


def _device_profile(fn, iters=20, top=8):
    """Device time per call of fn — the sum of the CUDA kernels' and
    copies' own time that torch.profiler records over `iters` warm calls —
    and the `top` device items by time: [name, ms per call, launches per
    call]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in events)
    if us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    rows = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    return us / 1e3 / iters, [[e.key[:80], e.self_device_time_total / 1e3 / iters,
                                e.count / iters] for e in rows]


def _device_ms(fn, iters=20):
    return _device_profile(fn, iters, top=0)[0]


def _bound(n_bytes, n_ops, ops_per_s):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nms_iou_pairs(boxes, scores, classes, thresh):
    """IoU tests nms_mask makes on these inputs: each valid row walks the
    valid same-class candidates of higher priority in order and stops at
    the first whose IoU passes the threshold."""
    iou = _iou64(boxes)
    n = scores.shape[-1]
    idx = np.arange(n)
    total = 0
    for s, c, io in zip(scores, classes, iou):
        prio = (s[None, :] > s[:, None]) | ((s[None, :] == s[:, None]) & (idx[None, :] < idx[:, None]))
        cand = prio & (s[None, :] > 0) & (s[:, None] > 0) & (c[None, :] == c[:, None])
        kill = cand & (io > thresh)
        cum = np.cumsum(cand, axis=1)
        first = kill.argmax(1)
        total += int(np.where(kill.any(1), cum[idx, first], cum[:, -1]).sum())
    return total


def phase_kernel(device):
    """nms_mask against its plain version at the main path's shapes
    (B = 1 and 32 images, N = 300 candidates): bit-equal keep masks."""
    from tensorrtx_tpu_torch.ops.cuda import nms_mask as kern

    out = {}
    for b in (1, 32):
        host = adversarial_candidates(100 + b, b)
        args = [torch.from_numpy(a).to(device) for a in host]
        keep = kern.keep_mask(*args, NMS_THRESH)
        plain = kern.keep_mask_plain(*args, NMS_THRESH)
        plain_cpu = kern.keep_mask_plain(*[torch.from_numpy(a) for a in host], NMS_THRESH)
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = int((keep.cpu().int() - plain.cpu().int()).abs().max())
        if not (torch.equal(keep, plain) and torch.equal(keep.cpu(), plain_cpu)):
            raise AssertionError(f"nms_mask kernel disagrees with its plain version at B={b}: "
                                 f"{int((keep.cpu() != plain_cpu).sum())} slots differ")
        kept, valid = int(keep.sum()), int((args[1] > 0).sum())
        if not 0 < kept < valid:
            raise AssertionError(f"degenerate NMS input at B={b}: kept {kept} of {valid}")
        # bytes: boxes, scores, classes read once, the keep mask written once
        pairs = _nms_iou_pairs(*host, NMS_THRESH)
        bound_ms, bound_by = _bound(25 * b * N_CAND, NMS_FLOPS_PER_PAIR * pairs,
                                    F32_FLOPS_PER_S)
        t = {}
        if device.type == "cuda":
            t = {"ms": _device_ms(lambda: kern.keep_mask(*args, NMS_THRESH)),
                 "plain_ms": _device_ms(lambda: kern.keep_mask_plain(*args, NMS_THRESH))}
        out[b] = {"max_abs_err": float(err), "bound_ms": bound_ms, "bound_by": bound_by, **t}
        log("kernel_vs_plain", kernel="nms_mask", batch=b, n=N_CAND, kept=kept,
            valid=valid, bit_equal=True, iou_pairs=pairs, bound_ms=bound_ms,
            bound_by=bound_by, **t)
    return out


def _engine(precision, device, size, **over):
    from tensorrtx_tpu_torch.core.convert import params_from_jax
    from tensorrtx_tpu_torch.core.engine import Engine
    from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap
    from tensorrtx_tpu_torch.models.yolo11 import Yolo11Cfg, build_params

    cfg = Yolo11Cfg(scale="n", input_h=size, input_w=size, max_det=N_CAND, **over)
    params = params_from_jax(build_params(RandomWeightMap(seed=0), cfg))
    return Engine("yolo11", params, cfg, precision, device)


def _safe_conf_thresh(raws, nms_thresh, max_det):
    """A confidence threshold at which the detections cannot depend on
    float32 rounding: it sits in a gap of ≥ 1e-6 between distinct scores of
    every raw output given, fewer than max_det candidates pass it, and among
    the candidates no same-class pair that overlaps near or above the IoU
    threshold has scores within 1e-6 (exact ties aside) or an IoU within
    1e-4 of the threshold, in any of the outputs. Picks the one with the
    most candidates; the random-weight network's scores sit in narrow
    bands, so the count can be small."""
    confs = [r["conf"].cpu().numpy() for r in raws]
    values = np.unique(np.concatenate([c.ravel() for c in confs]))[::-1]
    best = None
    for hi, lo in zip(values[:-1], values[1:]):
        if hi - lo < 1e-6:
            continue
        t = float((np.float64(hi) + np.float64(lo)) / 2)
        counts = [int((c >= t).sum(-1).max()) for c in confs]
        if max(counts) >= max_det:
            break
        safe = all(np.array_equal(c >= t, confs[0] >= t) for c in confs)
        for r, c in zip(raws, confs):
            for bi in range(c.shape[0]):
                sel = c[bi] >= t
                bx = r["boxes"][bi].cpu().numpy()[sel]
                sc = c[bi][sel].astype(np.float64)
                cl = r["cls"][bi].cpu().numpy()[sel]
                iou = _iou64(bx)
                same = cl[:, None] == cl[None, :]
                near = same & (iou > nms_thresh - 1e-4)
                d = np.abs(sc[:, None] - sc[None, :])
                if (near & (d > 0) & (d < 1e-6)).any() or \
                        (same & (np.abs(iou - nms_thresh) < 1e-4)).any():
                    safe = False
        if safe and (best is None or max(counts) > best[1]):
            best = (t, max(counts))
    if best is None:
        raise AssertionError("no rounding-safe confidence threshold in the raw outputs")
    return best


def _match(a, b):
    """IoU-match detections a to b (same class, greedy by IoU); returns the
    smallest matched IoU (1.0 when both are empty)."""
    if len(a["boxes"]) != len(b["boxes"]):
        return 0.0
    if len(a["boxes"]) == 0:
        return 1.0
    iou = _iou64(np.concatenate([a["boxes"], b["boxes"]]))[:len(a["boxes"]), len(a["boxes"]):]
    iou = np.where(a["classes"][:, None] == b["classes"][None, :], iou, -1.0)
    worst, used = 1.0, set()
    for i in np.argsort(-iou.max(1)):
        j = max((j for j in range(iou.shape[1]) if j not in used),
                key=lambda j: iou[i, j])
        used.add(j)
        worst = min(worst, float(iou[i, j]))
    return worst


def phase_f32_parity(device, size=SIZE, bucket=BUCKET):
    """float32 YOLO11n on the card against the port's CPU path, TF32 off:
    letterbox, raw head outputs, NMS on identical candidates (bit-equal),
    and end-to-end detections (counts equal, boxes IoU-matched ≥ 0.99)."""
    from tensorrtx_tpu_torch.core.runner import ServingPipeline
    from tensorrtx_tpu_torch.ops.nms import select_and_nms
    from tensorrtx_tpu_torch.ops.preprocess import letterbox_batch

    cpu = torch.device("cpu")
    shapes = [(bucket[0] * 3 // 4, bucket[1]), (bucket[0], bucket[1] * 2 // 3)]
    images = synthetic_frames(1, shapes)
    frames, src_hw = frames_of(images, bucket)

    lb = [letterbox_batch(torch.from_numpy(frames).to(d), torch.from_numpy(src_hw).to(d),
                          size, size).cpu() for d in (device, cpu)]
    lb_err = float((lb[0] - lb[1]).abs().max())
    if lb_err > 1e-5:
        raise AssertionError(f"letterbox on {device} vs cpu: max abs err {lb_err}")

    raws = [ServingPipeline(_engine("fp32", d, size, postprocess="raw"), *bucket)(frames, src_hw)
            for d in (device, cpu)]
    g, c = raws
    conf_err = float((g["conf"].cpu() - c["conf"]).abs().max())
    box_err = float((g["boxes"].cpu() - c["boxes"]).abs().max())
    cls_agree = float((g["cls"].cpu() == c["cls"]).float().mean())
    if not (g["conf"].shape == c["conf"].shape and torch.isfinite(g["boxes"]).all()):
        raise AssertionError("raw outputs: bad shape or non-finite boxes")
    if conf_err > 1e-4 or box_err > 1e-2 or cls_agree < 0.999:
        raise AssertionError(f"raw f32 outputs differ: conf {conf_err}, boxes {box_err} px, "
                             f"class agreement {cls_agree}")

    # NMS stage on identical candidates: kernel path vs the CPU plain path
    args = (g["boxes"], g["conf"], g["cls"], 0.25, NMS_THRESH, N_CAND)
    on_dev = select_and_nms(*args).as_dict()
    on_cpu = select_and_nms(*(a.cpu() if torch.is_tensor(a) else a for a in args)).as_dict()
    for k in on_cpu:
        if not torch.equal(on_dev[k].cpu(), on_cpu[k]):
            raise AssertionError(f"select_and_nms on {device} vs cpu: field {k} differs")

    # end to end, compared in letterboxed coordinates: mapped back to an
    # image, a box in the letterbox border clips to zero area
    thr, n_cand = _safe_conf_thresh(raws, NMS_THRESH, N_CAND)
    outs = [{k: v.cpu().numpy() for k, v in
             ServingPipeline(_engine("fp32", d, size, conf_thresh=thr), *bucket)(
                 frames, src_hw).items()} for d in (device, cpu)]
    counts = [o["count"].tolist() for o in outs]
    worst = 1.0
    for i, n in enumerate(counts[1]):
        a, b = ({"boxes": o["boxes"][i][:n], "classes": o["classes"][i][:n]} for o in outs)
        worst = min(worst, _match(a, b))
    if counts[0] != counts[1] or worst < 0.99:
        raise AssertionError(f"f32 detections differ: counts {counts}, worst IoU {worst}")
    log("f32_parity", size=size, frames=[list(s) for s in shapes],
        letterbox_max_abs_err=lb_err, conf_max_abs_err=conf_err,
        box_max_abs_err_px=box_err, class_agreement=cls_agree,
        nms_on_same_candidates="bit-equal", nms_count_at_0_25=on_cpu["count"].tolist(),
        conf_thresh=thr, candidates=n_cand, counts=counts[0], worst_iou=worst)


def phase_serving(device, n_b1=30, n_b32=5, size=SIZE, bucket=BUCKET):
    """bf16 YOLO11n serving through detect_images (the main path): b1
    requests and a b32 batch. Returns (launch counts, timings)."""
    from tensorrtx_tpu_torch.core.runner import ServingPipeline, cuda_event_ms
    from tensorrtx_tpu_torch.ops.cuda import nms_mask as kern

    pipe = ServingPipeline(_engine("bf16", device, size, conf_thresh=0.25), *bucket)
    shapes = [(bucket[0] * 3 // 4, bucket[1]), (bucket[0], bucket[1] * 2 // 3),
              (bucket[0] // 2, bucket[1] // 2)]
    images = synthetic_frames(2, shapes)
    batch32 = [images[i % len(images)] for i in range(32)]
    pipe.detect_images(images[:1])          # warm: cuDNN algorithm choice
    pipe.detect_images(batch32)
    if device.type == "cuda":
        torch.cuda.synchronize()

    _reset_launches()                        # the float path's run starts here
    results = []
    if device.type == "cuda":
        b1 = cuda_event_ms(lambda: results.append(pipe.detect_images(images[:1])),
                           iters=n_b1, warmup=0)
        b32 = cuda_event_ms(lambda: results.append(pipe.detect_images(batch32)),
                            iters=n_b32, warmup=0)
    else:
        results = [pipe.detect_images(images[:1]), pipe.detect_images(batch32)]
        b1 = b32 = [float("nan")]
    launches = {"nms_mask": kern.launches}
    for res in results:
        for r in res:
            n = len(r["boxes"])
            if not (r["boxes"].shape == (n, 4) and np.isfinite(r["boxes"]).all()
                    and np.isfinite(r["scores"]).all() and n <= N_CAND):
                raise AssertionError("serving returned malformed detections")
    timing = {"b1_ms_per_img": float(np.median(b1)),
              "b32_ms_per_img": float(np.median(b32)) / 32}
    if device.type == "cuda":
        # device busy time per request and its largest items, from a
        # separate profiled window
        dev1, top1 = _device_profile(lambda: pipe.detect_images(images[:1]), iters=10)
        dev32, top32 = _device_profile(lambda: pipe.detect_images(batch32), iters=3)
        timing |= {"b1_device_ms_per_img": dev1, "b32_device_ms_per_img": dev32 / 32,
                   "b1_device_idle_share": 1 - dev1 / timing["b1_ms_per_img"],
                   "b32_device_idle_share": 1 - dev32 / 32 / timing["b32_ms_per_img"],
                   "b1_top_device_items": top1, "b32_top_device_items": top32}
    log("serving", precision="bf16", size=size, requests_b1=n_b1, batches_b32=n_b32,
        **timing, launches=launches,
        counts_b1=[len(r["boxes"]) for r in results[0]])
    return launches, timing


# ---------------------------------------------------------------------------
# the chained int8 tier
# ---------------------------------------------------------------------------

def _chained(precision, device, size, dtype=torch.bfloat16, **over):
    from tensorrtx_tpu_torch.core.quant import ChainedInt8Engine

    return ChainedInt8Engine(_engine(precision, device, size, **over), dtype=dtype)


def _reset_launches():
    from tensorrtx_tpu_torch.ops.cuda import nms_mask, qconv

    nms_mask.launches = 0
    qconv.launches_3x3 = qconv.launches_1x1 = 0


def _launches():
    from tensorrtx_tpu_torch.ops.cuda import nms_mask, qconv

    return {"nms_mask": nms_mask.launches, "qconv3x3": qconv.launches_3x3,
            "qconv1x1": qconv.launches_1x1}


@contextlib.contextmanager
def _qconv_hook(hook):
    """While the block runs, every call of a qconv wrapper runs as usual and
    then hands (kernel name, args, kwargs, output) to hook."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    real = {"qconv3x3": qk.qconv3x3, "qconv1x1": qk.qconv1x1}

    def wrap(name):
        def fn(*args, **kw):
            out = real[name](*args, **kw)
            hook(name, args, kw, out)
            return out
        return fn

    qk.qconv3x3, qk.qconv1x1 = wrap("qconv3x3"), wrap("qconv1x1")
    try:
        yield
    finally:
        qk.qconv3x3, qk.qconv1x1 = real["qconv3x3"], real["qconv1x1"]


def _compare(got, ref):
    """(max error, share of elements that differ): LSB for int8 outputs,
    absolute for float exits."""
    d = (got.float() - ref.float()).abs()
    return float(d.max()), float((d > 0).float().mean())


def _check_int8(name, where, err, frac):
    if err > 1 or frac >= 1e-3:
        raise AssertionError(f"{name} disagrees with its plain version at {where}: "
                             f"max {err} LSB on {frac:.2e} of the elements")


def _check_float(name, where, got, ref):
    tol = 1e-5 * (1.0 + float(ref.float().abs().max()))
    if ref.dtype == torch.bfloat16:
        tol = 2 ** -7 * (1.0 + float(ref.float().abs().max()))
    err = float((got.float() - ref.float()).abs().max())
    if err > tol:
        raise AssertionError(f"{name} float exit disagrees with its plain version at "
                             f"{where}: max abs err {err} > {tol}")
    return err


def main_path_qconvs(ce, size=SIZE):
    """The int8 path's qconv launches, in order, from one B = 1 forward:
    (kernel, H, W, C, the weight/scale/bias/kwargs it was called with)."""
    calls = []

    def hook(name, args, kw, out):
        xq, wq, scale, bias, _ = args
        calls.append({"name": name, "hw": tuple(xq.shape[1:3]), "c": xq.shape[3], "wq": wq,
                      "scale": scale, "bias": bias,
                      "kw": {k: v for k, v in kw.items() if k not in ("residual", "res_scale")},
                      "residual": "residual" in kw})
    frames = np.zeros((1, size, size, 3), np.uint8)
    with _qconv_hook(hook):
        ce(frames)
    return calls


def _qconv_args(spec, batch, rng, device):
    """Inputs of one launch at `batch`: random int8 activations (and
    residual) at the spec's shape with its real weight, scale and bias;
    s_out set from the plain float output so the int8 result is not
    saturated."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    h, w = spec["hw"]
    xq = torch.from_numpy(rng.integers(-127, 128, (batch, h, w, spec["c"]), dtype=np.int8)).to(device)
    kw = dict(spec["kw"])
    k, stride = spec["wq"].shape[1], kw.get("stride", 1)
    if spec["residual"]:
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        kw["residual"] = torch.from_numpy(rng.integers(
            -127, 128, (batch, ho, wo, spec["wq"].shape[0]), dtype=np.int8)).to(device)
        kw["res_scale"] = torch.tensor(0.01, device=device)
    args = [xq, spec["wq"], spec["scale"], spec["bias"], None]
    if not kw.get("out_float"):
        o = qk.qconv_plain(*args, **{**kw, "out_float": True, "out_dtype": torch.float32})
        args[4] = torch.clamp(o.abs().amax() / 127.0, min=1e-8)
    return args, kw


def _extra_specs(device, rng):
    """Forms of the contract the YOLO11n path does not use: the residual
    (conv+add) epilogue, ReLU, and the 173×16×128 map that the TPU kernel's
    tiling cannot take."""
    def spec(name, k, hw, c, co, **kw):
        return {"name": name, "hw": hw, "c": c,
                "wq": torch.from_numpy(rng.integers(-127, 128, (co, k, k, c), dtype=np.int8)).to(device),
                "scale": torch.from_numpy(rng.uniform(1e-5, 3e-5, co).astype(np.float32)).to(device),
                "bias": torch.from_numpy(rng.normal(0, 0.3, co).astype(np.float32)).to(device),
                "residual": kw.pop("residual", False), "kw": kw}
    return [
        spec("qconv3x3", 3, (40, 40), 128, 128, act="relu", residual=True),
        spec("qconv3x3", 3, (173, 16), 128, 128, act="silu"),
        spec("qconv3x3", 3, (20, 20), 128, 64, act=None, out_float=True, out_dtype=torch.bfloat16),
        spec("qconv1x1", 1, (40, 40), 256, 128, act="silu", residual=True),
        spec("qconv1x1", 1, (20, 20), 80, 80, act=None, out_float=True, out_dtype=torch.float32),
    ]


def _qconv_work(spec, batch):
    """(bytes, int8 operations) of one launch: input, weight, scale, bias,
    residual read once, output written once; two operations per MAC."""
    co, k, _, c = spec["wq"].shape
    stride = spec["kw"].get("stride", 1)
    h, w = spec["hw"]
    m = batch * ((h - 1) // stride + 1) * ((w - 1) // stride + 1)
    out_bytes = 1 if not spec["kw"].get("out_float") else spec["kw"]["out_dtype"].itemsize
    n_bytes = batch * h * w * c + co * k * k * c + 8 * co + m * co * (out_bytes + spec["residual"])
    return n_bytes, 2 * m * co * k * k * c


def phase_qconv(device, specs, batches=(1, 32)):
    """qconv3x3 / qconv1x1 against their plain versions at every launch
    shape of the int8 path and at the extras; then, at each batch, the
    device time of all the path's launches of each kernel (one forward's
    worth), of their plain versions and of the library's int8 product
    (`torch._int_mm`, 1×1 only; a yardstick the port never calls), and the
    bound of the same work."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    rng = np.random.default_rng(7)
    fns = {"qconv3x3": qk.qconv3x3, "qconv1x1": qk.qconv1x1}
    out = {}
    for b in batches:
        stats = {name: {"max_abs_err": 0.0, "float_exit_max_abs_err": 0.0, "worst_frac": 0.0}
                 for name in fns}
        runs = {name: [] for name in fns}
        extras = _extra_specs(device, rng)
        for i, spec in enumerate(specs + extras):
            args, kw = _qconv_args(spec, b, rng, device)
            got = fns[spec["name"]](*args, **kw)
            ref = qk.qconv_plain(*args, **kw)
            where = f"B={b} {spec['name']} {spec['hw']} C={spec['c']} Co={spec['wq'].shape[0]}"
            st = stats[spec["name"]]
            if kw.get("out_float"):
                err = _check_float(spec["name"], where, got, ref)
                st["float_exit_max_abs_err"] = max(st["float_exit_max_abs_err"], err)
            else:
                err, frac = _compare(got, ref)
                _check_int8(spec["name"], where, err, frac)
                st["max_abs_err"] = max(st["max_abs_err"], err)
                st["worst_frac"] = max(st["worst_frac"], frac)
            if i < len(specs):
                runs[spec["name"]].append((args, kw, spec))
        for name, calls in runs.items():
            n_bytes = sum(_qconv_work(sp, b)[0] for _, _, sp in calls)
            n_ops = sum(_qconv_work(sp, b)[1] for _, _, sp in calls)
            bound_ms, bound_by = _bound(n_bytes, n_ops, INT8_OPS_PER_S)
            st = stats[name] | {"launches_per_forward": len(calls), "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": None}
            if device.type == "cuda":
                fn = fns[name]
                st["ms"] = _device_ms(lambda: [fn(*a, **k) for a, k, _ in calls], iters=10)
                st["plain_ms"] = _device_ms(
                    lambda: [qk.qconv_plain(*a, **k) for a, k, _ in calls], iters=3)
                if name == "qconv1x1":
                    mats = [(a[0].reshape(-1, a[0].shape[-1]), a[1].reshape(a[1].shape[0], -1).t())
                            for a, _, _ in calls]
                    st["library_ms"] = _device_ms(
                        lambda: [torch._int_mm(x, w) for x, w in mats], iters=10)
            stats[name] = st
            log("kernel_vs_plain", kernel=name, batch=b, shapes=len(calls),
                extras=sum(sp["name"] == name for sp in extras), **st)
        out[b] = stats
    return out


def phase_int8_shadow(ce, frames, src_hw):
    """One chained forward on the card with every qconv launch recomputed
    by its plain version on the same inputs: both kernels at all the path's
    real shapes on real activations. Returns each kernel's worst int8
    error in LSB."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    worst = {"lsb": (0.0, 0.0, None), "float": (0.0, None)}
    per_kernel = {"qconv3x3": 0.0, "qconv1x1": 0.0}
    rows = []

    def hook(name, args, kw, got):
        ref = qk.qconv_plain(*args, **kw)
        where = f"{name} x{tuple(args[0].shape)} w{tuple(args[1].shape)}"
        if kw.get("out_float"):
            err = _check_float(name, where, got, ref)
            if err >= worst["float"][0]:
                worst["float"] = (err, where)
        else:
            err, frac = _compare(got, ref)
            _check_int8(name, where, err, frac)
            per_kernel[name] = max(per_kernel[name], err)
            if (err, frac) >= worst["lsb"][:2]:
                worst["lsb"] = (err, frac, where)
        rows.append(where)

    _reset_launches()
    with _qconv_hook(hook):
        out = ce(frames, src_hw)
    if ce.device.type == "cuda":
        torch.cuda.synchronize()
    launches = _launches()
    if ce.device.type == "cuda" and ((launches["qconv3x3"], launches["qconv1x1"]) != (31, 37)
                                     or launches["nms_mask"] < 1):
        raise AssertionError(f"the int8 forward launched {launches}, not 31 + 37 qconvs and NMS")
    if not all(torch.isfinite(v.float()).all() for v in out.values()):
        raise AssertionError("int8 shadow forward: non-finite detections")
    log("int8_shadow", batch=frames.shape[0], convs=len(rows), launches=launches,
        worst_lsb=worst["lsb"][0], worst_lsb_share=worst["lsb"][1], worst_conv=worst["lsb"][2],
        worst_float_exit_abs_err=worst["float"][0], worst_float_exit=worst["float"][1])
    return per_kernel


def phase_int8_parity(device, size=SIZE, bucket=BUCKET):
    """The int8 chain with float32 islands (TF32 off) on the card against the
    port's CPU path, with the scales calibrated once on the card and carried
    to both: raw outputs within the CPU slice test's tolerances
    (tests/test_torch_qchain.py: conf 1e-4, boxes 0.05 px, classes ≥ 99 %),
    then detections IoU-matched at a rounding-safe threshold."""
    cpu = torch.device("cpu")
    shapes = [(bucket[0] * 3 // 4, bucket[1]), (bucket[0], bucket[1] * 2 // 3)]
    frames, src_hw = frames_of(synthetic_frames(1, shapes), bucket)
    raw = {d: _chained("fp32", d, size, torch.float32, postprocess="raw") for d in (device, cpu)}
    scales = raw[device].calibrate([frames])
    raw[cpu].set_scales(scales)
    raws = [raw[d](frames, src_hw) for d in (device, cpu)]
    g, c = raws
    conf_err = float((g["conf"].cpu() - c["conf"]).abs().max())
    box_err = float((g["boxes"].cpu() - c["boxes"]).abs().max())
    cls_agree = float((g["cls"].cpu() == c["cls"]).float().mean())
    if not (g["conf"].shape == c["conf"].shape and torch.isfinite(g["boxes"]).all()):
        raise AssertionError("int8 raw outputs: bad shape or non-finite boxes")
    if conf_err > 1e-4 or box_err > 0.05 or cls_agree < 0.99:
        raise AssertionError(f"int8 raw outputs differ: conf {conf_err}, boxes {box_err} px, "
                             f"class agreement {cls_agree}")
    thr, n_cand = _safe_conf_thresh(raws, NMS_THRESH, N_CAND)
    outs = []
    for d in (device, cpu):
        ce = _chained("fp32", d, size, torch.float32, conf_thresh=thr)
        ce.set_scales(scales)
        outs.append({k: v.cpu().numpy() for k, v in ce(frames, src_hw).items()})
    counts = [o["count"].tolist() for o in outs]
    worst = 1.0
    for i, n in enumerate(counts[1]):
        a, b = ({"boxes": o["boxes"][i][:n], "classes": o["classes"][i][:n]} for o in outs)
        worst = min(worst, _match(a, b))
    if counts[0] != counts[1] or worst < 0.99:
        raise AssertionError(f"int8 detections differ: counts {counts}, worst IoU {worst}")
    log("int8_parity", size=size, frames=[list(s) for s in shapes], scales=len(scales),
        conf_max_abs_err=conf_err, box_max_abs_err_px=box_err, class_agreement=cls_agree,
        conf_thresh=thr, candidates=n_cand, counts=counts[0], worst_iou=worst)


def phase_int8_serving(device, ce, n_b1=30, n_b32=5, bucket=BUCKET):
    """The chained int8 engine (bf16 islands) serving b1 requests and b32
    batches through ``__call__`` + `present_detections`. Returns (launches
    of the run, timings)."""
    from tensorrtx_tpu_torch.core.runner import cuda_event_ms, present_detections

    shapes = [(bucket[0] * 3 // 4, bucket[1]), (bucket[0], bucket[1] * 2 // 3),
              (bucket[0] // 2, bucket[1] // 2)]
    images = synthetic_frames(2, shapes)
    f1, hw1 = frames_of(images[:1], bucket)
    f32_, hw32 = frames_of([images[i % len(images)] for i in range(32)], bucket)

    def serve(frames, src_hw):
        return present_detections(ce(frames, src_hw), src_hw, ce.cfg)

    serve(f1, hw1)                           # warm: cuDNN algorithm choice
    serve(f32_, hw32)
    if device.type == "cuda":
        torch.cuda.synchronize()

    _reset_launches()                        # the int8 path's run starts here
    results = []
    if device.type == "cuda":
        b1 = cuda_event_ms(lambda: results.append(serve(f1, hw1)), iters=n_b1, warmup=0)
        b32 = cuda_event_ms(lambda: results.append(serve(f32_, hw32)), iters=n_b32, warmup=0)
    else:
        results = [serve(f1, hw1), serve(f32_, hw32)]
        b1 = b32 = [float("nan")]
        n_b1 = n_b32 = 1
    launches = _launches()
    n_fwd = n_b1 + n_b32
    if device.type == "cuda" and (
            (launches["qconv3x3"], launches["qconv1x1"]) != (31 * n_fwd, 37 * n_fwd)
            or launches["nms_mask"] < n_fwd):
        raise AssertionError(f"{n_fwd} int8 forwards launched {launches}, not 31 + 37 "
                             "qconvs and an NMS each")
    for res in results:
        for r in res:
            n = len(r["boxes"])
            if not (r["boxes"].shape == (n, 4) and np.isfinite(r["boxes"]).all()
                    and np.isfinite(r["scores"]).all() and n <= N_CAND):
                raise AssertionError("int8 serving returned malformed detections")
    timing = {"b1_ms_per_img": float(np.median(b1)),
              "b32_ms_per_img": float(np.median(b32)) / 32}
    if device.type == "cuda":
        # device busy time per request and its largest items, from a
        # separate profiled window
        dev1, top1 = _device_profile(lambda: serve(f1, hw1), iters=10)
        dev32, top32 = _device_profile(lambda: serve(f32_, hw32), iters=3)
        timing |= {"b1_device_ms_per_img": dev1, "b32_device_ms_per_img": dev32 / 32,
                   "b1_device_idle_share": 1 - dev1 / timing["b1_ms_per_img"],
                   "b32_device_idle_share": 1 - dev32 / 32 / timing["b32_ms_per_img"],
                   "b1_top_device_items": top1, "b32_top_device_items": top32}
    log("int8_serving", islands=str(ce.dtype), scales=ce.n_scales, requests_b1=n_b1,
        batches_b32=n_b32, **timing, launches=launches,
        launches_per_forward={k: v / n_fwd for k, v in launches.items()},
        counts_b1=[len(r["boxes"]) for r in results[0]])
    return launches, timing


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False       # f32 parity: no TF32 convs
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = phase_env()
    nms = phase_kernel(device)
    ce = _chained("bf16", device, SIZE, conf_thresh=0.25)
    cal, _ = frames_of(synthetic_frames(4, [(SIZE, SIZE)] * CAL_FRAMES), (SIZE, SIZE))
    ce.calibrate([cal])
    qc = phase_qconv(device, main_path_qconvs(ce))
    shadow = phase_int8_shadow(ce, *frames_of(synthetic_frames(5, [(480, 640), (640, 426)])))
    phase_int8_parity(device)
    int8_launches, _ = phase_int8_serving(device, ce)
    phase_f32_parity(device)
    launches, _ = phase_serving(device)
    missing = [k for k, v in int8_launches.items() if v == 0]
    missing += [f"{k} (float path)" for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"a main path launched no {missing} kernel")

    print(smi)
    kernels = [{
        "name": "nms_mask", "route": "cuda",
        "source": "tensorrtx_tpu_torch/csrc/nms_mask.cu",
        "replaces": "tensorrtx_tpu/ops/pallas/nms_pallas.py:60",
        "launches": launches["nms_mask"], "max_abs_err": nms[1]["max_abs_err"],
        "ms": nms[1]["ms"], "plain_ms": nms[1]["plain_ms"],
        "bound_ms": nms[1]["bound_ms"], "bound_by": nms[1]["bound_by"], "library_ms": None,
        "launches_int8_path": int8_launches["nms_mask"],
        "ms_b32": nms[32]["ms"], "plain_ms_b32": nms[32]["plain_ms"],
        "bound_ms_b32": nms[32]["bound_ms"],
    }]
    for name, line in (("qconv3x3", 103), ("qconv1x1", 205)):
        s1, s32 = qc[1][name], qc[32][name]
        kernels.append({
            "name": name, "route": "cuda", "source": "tensorrtx_tpu_torch/csrc/qconv.cu",
            "replaces": f"tensorrtx_tpu/ops/pallas/qconv.py:{line}",
            "launches": int8_launches[name],
            "max_abs_err": max(s1["max_abs_err"], s32["max_abs_err"], shadow[name]),
            "ms": s1["ms"], "plain_ms": s1["plain_ms"], "bound_ms": s1["bound_ms"],
            "bound_by": s1["bound_by"], "library_ms": s1["library_ms"],
            "per": "all launches of one B=1 forward",
            "launches_per_forward": s1["launches_per_forward"],
            "ms_b32": s32["ms"], "plain_ms_b32": s32["plain_ms"],
            "bound_ms_b32": s32["bound_ms"], "bound_by_b32": s32["bound_by"],
            "library_ms_b32": s32["library_ms"],
            "float_exit_max_abs_err": max(s1["float_exit_max_abs_err"],
                                          s32["float_exit_max_abs_err"]),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
