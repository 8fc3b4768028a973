"""GPU smoke run of the port (tensorrtx_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout, holds each against
its plain PyTorch version, checks the float32 YOLO11n-640 path on the card
against the port's own CPU path, then serves bf16 YOLO11n-640 through
`ServingPipeline.detect_images` (the main path) and shows that the path ran
through the kernels. Weights are random (`RandomWeightMap(seed=0)`); no
file outside the checkout is read. Exits non-zero, without the result
line, if there is no CUDA device or any phase fails. It imports neither JAX
nor the JAX package.

Output: one line per phase, then the card's name and power limit, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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


def _device_ms(fn, iters=20):
    """Device time per call of fn: the sum of the CUDA kernels' and copies'
    own time that torch.profiler records over `iters` warm calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return us / 1e3 / iters


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
        t = {}
        if device.type == "cuda":
            t = {"ms": _device_ms(lambda: kern.keep_mask(*args, NMS_THRESH)),
                 "plain_ms": _device_ms(lambda: kern.keep_mask_plain(*args, NMS_THRESH))}
        out[b] = {"max_abs_err": float(err), **t}
        log("kernel_vs_plain", kernel="nms_mask", batch=b, n=N_CAND, kept=kept,
            valid=valid, bit_equal=True, **t)
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

    kern.launches = 0                        # the main path's run starts here
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
        # device busy time per request, from a separate profiled window
        dev1 = _device_ms(lambda: pipe.detect_images(images[:1]), iters=10)
        dev32 = _device_ms(lambda: pipe.detect_images(batch32), iters=3)
        timing |= {"b1_device_ms_per_img": dev1, "b32_device_ms_per_img": dev32 / 32,
                   "b1_device_idle_share": 1 - dev1 / timing["b1_ms_per_img"],
                   "b32_device_idle_share": 1 - dev32 / 32 / timing["b32_ms_per_img"]}
    log("serving", precision="bf16", size=size, requests_b1=n_b1, batches_b32=n_b32,
        **timing, launches=launches,
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
    kstats = phase_kernel(device)
    phase_f32_parity(device)
    launches, timing = phase_serving(device)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing} kernel")

    print(smi)
    ks = kstats[1]
    print(json.dumps({"kernels": [{
        "name": "nms_mask", "route": "cuda",
        "source": "tensorrtx_tpu_torch/csrc/nms_mask.cu",
        "replaces": "tensorrtx_tpu/ops/pallas/nms_pallas.py:60",
        "launches": launches["nms_mask"], "max_abs_err": ks["max_abs_err"],
        "ms": ks["ms"], "plain_ms": ks["plain_ms"],
        "ms_b32": kstats[32]["ms"], "plain_ms_b32": kstats[32]["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
