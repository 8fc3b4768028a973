"""GPU smoke run of the port (tensorrtx_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout and holds each
against its plain PyTorch version, then drives the port's three det serving
paths at full width (YOLO11n, 640²), the four other yolo11 tasks (seg,
pose, obb, cls) at theirs, YOLOv8n det's three paths, and every other path
of YOLOv8, YOLOv10 and YOLO26 (`PATHS`), each by the eager route (one
launch per op, whose launch counts show the path went through its
kernels) and as the captured CUDA graphs a user's calls replay:

  env              card, toolchain, nvcc build of every kernel (ptxas report)
  kernel_vs_plain  nms_mask (B = 1, 32) and the int8 convs qconv3x3 /
                   qconv1x1 at every shape of the int8 path (B = 1, 32),
                   with residual, float-exit, 173×16×128, stem-like
                   (C = 3, 8; Co = 8) and tail extras, and both kernels'
                   GEMM-exact output bit-equal there; device time of
                   kernel, plain version and library call, the bound, and
                   qconv3x3's B = 32 time per distinct launch shape
  int8_shadow      one chained int8 forward (B = 2) with every qconv launch
                   recomputed by its plain version on the same inputs
  int8_parity      the float32-island int8 chain on the card against the
                   port's CPU path, same scales: raw outputs and detections
  int8_serving     `ChainedInt8Engine` (bf16 islands) calibrated on 8
                   frames, serving b1 requests and b32 batches by the eager
                   route (`raw_serve`) + `present_detections`
  graph_serving    (each path) its b1 and b32 CUDA graphs captured, every
                   replayed detection dict bit-equal to the eager forward
                   on the same frames (3 frame sets of different true sizes
                   at each batch), b1/b32 served through ``__call__`` /
                   `detect_images` and timed beside the eager route: wall,
                   device time from queued CUDA events, idle share, pinned
                   H2D, capture seconds, memory
  stream           (chain, float) `stream_fn(16)`: 16 batch-1 forwards in
                   one graph, bit-equal to 16 eager b1 forwards
  f32_parity       the float32 float path on the card against the CPU path
  serving          bf16 float path (`ServingPipeline.fused`) b1/b32, eager
  task_parity      (seg 640², pose 640², obb 1024², cls 224²; each after the
                   last) the float32 task engine on the card against the
                   CPU path: raw outputs and extras (mask coefficients,
                   proto, keypoints, angle), detections at a rounding-safe
                   threshold with seg's masks, pose's keypoints and obb's
                   angle on matched slots; cls's logits and top-5
  task_serving     the bf16 task path: nms_mask on the path's own
                   candidates against its plain version (seg, pose; B = 1,
                   32), b1/b32 by the eager route (1 nms_mask a forward on
                   seg and pose, none on obb and cls), then its
                   graph_serving and stream phases
  fq_calibrate     a bf16 `QuantizedEngine` (the float-resident int8 tier)
                   calibrated with entropy on 8 frames
  kernel_vs_plain  quantize_int8 (both standalone forms) at the tier's 80
                   conv inputs; the tier's quantize (`fused_quantize`:
                   identity convs on every finite bf16 value at the tier's
                   80 scales, 8 powers of two and one scale under 2^-100,
                   from contiguous maps and channel slices, bit-equal to
                   the division form); qconv3x3/qconv1x1 from the tier's
                   bf16 inputs where they lie (channel slices with their
                   pixel stride) at its 80 conv shapes, their GEMM-exact
                   output bit-equal from bf16, float32 and channel-slice
                   sources, with the time of the tier's route (the 1×1
                   quantizing in its kernel; quantize_int8 of the input
                   where it lies, then the int8 3×3) beside the unfused
                   route (copy, quantize_int8, int8-source conv) and both
                   kernels' time per shape in both routes,
                   quantize_int8_stochastic on 32×160×160×64,
                   conv3x3_planar/conv1x1_planar at five
                   shapes in float32 and bf16 (B = 1, 32), with times
  standalone_ops   the planar convs and both quantize kernels driven through
                   their public ops (no serving path calls the planar convs
                   or the stochastic quantize)
  fq_shadow        one tier forward (B = 2) with every qconv call
                   recomputed by its plain version (quantize, then conv)
  fq_parity        the tier with a float32 engine on the card against the
                   port's CPU path, same scales
  fq_serving       the bf16 tier serving b1 requests and b32 batches by the
                   eager route: 45 qconv1x1 launches from float sources the
                   kernel quantizes itself, 35 quantize_int8 launches (the
                   3×3 inputs, where they lie) and 35 int8-source qconv3x3,
                   and an NMS per forward; then a census of one request's
                   copy and quantize kernels (profiler stacks) on this path
                   and on the unfused route
  phase_v8_det     YOLOv8n det on its three paths, as YOLO11n's: the v8
                   chain's qconvs against their plain versions at its own
                   shapes, its shadow forward, float32 parity (held at
                   V8_CHAIN_BARS and each int8 conv card against CPU), the
                   eager route, the graphs, `stream_fn(16)`; the float path
                   (task_parity, task_serving of "v8_det"); the tier
                   (entropy; quantize_int8 and the qconvs at its own
                   inputs, fq_shadow, fq_parity at V8_FQ_BARS, fq_serving,
                   the graphs)
  task_parity,     v8 seg, pose, obb 1024², cls 224², P2, 5u; YOLOv10n det;
  task_serving     YOLO26n det, obb 1024², cls 224²: as the yolo11 tasks
                   (v10 and yolo26 by `select_topk`, no NMS)
  graph_replay_census  in a child process (``--replay-census DIR``, where
                   the profiler records every kernel): each path's b1 graph
                   replayed under `torch.profiler` (the three det paths of
                   YOLO11n and of YOLOv8n, and every path of PATHS), every
                   one of the seven
                   kernels launched the expected number of times per replay
                   and none from Python; these counts are the kernels'
                   ``launches_per_replay`` and decide that each captured
                   path runs its kernels (a replay adds nothing to the
                   wrappers' counters, whose ``launches`` come from the
                   eager forwards of the serving phases)

Weights are random (`RandomWeightMap(seed=0)`); no file outside the
checkout is read. Exits non-zero, without the result line, if there is no
CUDA device or any phase fails. It imports neither JAX nor the JAX package.
Device times of the serving phases come from CUDA events around calls
queued behind a GPU sleep (`core/profiler.device_p50_ms`); the profiler
gives only their largest items, from windows whose launches it recorded
in full.

Output: one JSON line per phase (each with "t_s", the seconds since the
start), the total, then the card's name and power limit, a
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


_T0 = time.perf_counter()


def log(phase, **kv):
    """One JSON line: the phase, its fields, and the seconds since the
    script started ("t_s")."""
    print(json.dumps({"phase": phase, **kv, "t_s": round(time.perf_counter() - _T0, 1)}),
          flush=True)


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


def _iou_or_coords64(boxes):
    """`_iou64`, except that a pair where either box has no area (yolo26's
    raw ltrb regression gives x2 < x1 with random weights) overlaps 1.0
    when their coordinates agree within 0.01 px, else 0."""
    b = boxes.astype(np.float64)
    flat = (b[:, 2] <= b[:, 0]) | (b[:, 3] <= b[:, 1])
    close = np.abs(b[:, None] - b[None, :]).max(-1) <= 1e-2
    return np.where(flat[:, None] | flat[None, :], close.astype(np.float64), _iou64(boxes))


def _probiou64(obb):
    """(N, 5) [cx, cy, w, h, angle] → (N, N) probabilistic IoU in float64 (the
    port's `ops/nms.probiou_matrix`, the same operations), diagonal 0."""
    cx, cy, w, h, r = (obb[:, i].astype(np.float64) for i in range(5))
    eps = 1e-7
    c, s = np.cos(r), np.sin(r)
    a, b = w * w / 12 * c * c + h * h / 12 * s * s, w * w / 12 * s * s + h * h / 12 * c * c
    cc = (w * w / 12 - h * h / 12) * s * c
    a12, b12, c12 = (v[:, None] + v[None, :] for v in (a, b, cc))
    dx, dy = cx[:, None] - cx[None, :], cy[:, None] - cy[None, :]
    det12 = a12 * b12 - c12 * c12
    t1 = (a12 * dy * dy + b12 * dx * dx) / (det12 + eps)
    t2 = (c12 * -dx * dy) / (det12 + eps)
    det1 = np.maximum(a * b - cc * cc, 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        t3 = np.log(det12 / (4 * np.sqrt(det1[:, None] * det1[None, :] + eps * eps) + eps) + eps)
    bd = np.clip(0.25 * t1 + 0.5 * t2 + 0.5 * t3, eps, 100.0)
    iou = 1.0 - np.sqrt(1.0 - np.exp(-bd) + eps)
    iou[np.arange(len(iou)), np.arange(len(iou))] = 0.0
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
                 if "registers" in ln or "smem" in ln or "entry function" in ln
                 or "spill stores" in ln and not ln.strip().startswith("0 bytes stack frame, 0")]
             for k, v in report.items()}
    log("env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc_ver, kernels_built=sorted(report), build_s=round(build_s, 3),
        ptxas=ptxas)
    return smi


def gpu_clocks():
    """The card's SM and memory clocks now, as `nvidia-smi` reads them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _device_profile(fn, iters=20, top=8, expect=None):
    """Device time per call of fn — the sum of the CUDA kernels' and
    copies' own time that torch.profiler records over `iters` warm calls —
    the `top` device items by time ([name, ms per call, launches per
    call]), and the time's source, "profiler".

    The profiler's CUDA activity tracing now and then records nothing in a
    window, and late in a long process it can drop some of a window's
    kernels. With `expect` = (a part of a kernel's name, its launches per
    call), a window counts only if it recorded every one of those
    launches (`core/profiler.kernel_table`). After three windows that do
    not count, the time is the median of CUDA-event times around each
    call instead, which count the gaps between launches too: the source
    is then "cuda_events", there are no items, and every number built on
    it carries that source into the log."""
    from tensorrtx_tpu_torch.core.profiler import kernel_table
    from tensorrtx_tpu_torch.core.runner import cuda_event_ms

    fn()
    torch.cuda.synchronize()
    rows = kernel_table(fn, iters, None if expect is None else {expect[0]: expect[1] * iters})
    if rows is None:
        return float(np.median(cuda_event_ms(fn, iters=iters, warmup=0))), [], "cuda_events"
    return (sum(ms for _, ms, _ in rows) / iters,
            [[key[:80], ms / iters, n / iters] for key, ms, n in rows[:top]], "profiler")


def _timings(**fns):
    """{key: device ms per call} for each key=(fn, iters), and "ms_source":
    "profiler" when the profiler timed them all, else which keys are
    CUDA-event times (`_device_profile`)."""
    out, events = {}, []
    for key, (fn, iters) in fns.items():
        out[key], _, source = _device_profile(fn, iters, top=0)
        if source != "profiler":
            events.append(key)
    return out | {"ms_source": "cuda_events: " + ", ".join(events) if events else "profiler"}


def _source(*sources):
    """One "ms_source" for numbers with these sources."""
    odd = sorted({s for s in sources if s != "profiler"})
    return "; ".join(odd) if odd else "profiler"


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
            t = _timings(ms=(lambda: kern.keep_mask(*args, NMS_THRESH), 20),
                         plain_ms=(lambda: kern.keep_mask_plain(*args, NMS_THRESH), 20))
        out[b] = {"max_abs_err": float(err), "bound_ms": bound_ms, "bound_by": bound_by, **t}
        log("kernel_vs_plain", kernel="nms_mask", batch=b, n=N_CAND, kept=kept,
            valid=valid, bit_equal=True, iou_pairs=pairs, bound_ms=bound_ms,
            bound_by=bound_by, **t)
    return out


def _engine(precision, device, size, model="yolo11", **over):
    """A model's engine at scale n and size², max_det N_CAND, its weights
    from `RandomWeightMap(seed=0)`."""
    import dataclasses

    from tensorrtx_tpu_torch.core.convert import params_from_jax
    from tensorrtx_tpu_torch.core.engine import Engine
    from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap
    from tensorrtx_tpu_torch.core.registry import get_model

    md = get_model(model)
    cfg = dataclasses.replace(md.default_cfg(), scale="n", input_h=size, input_w=size,
                              max_det=N_CAND, **over)
    params = params_from_jax(md.build_params(RandomWeightMap(seed=0), cfg))
    return Engine(model, params, cfg, precision, device)


# why NMS may decide apart in two raw outputs although each output on its
# own leaves no decision to rounding: the outputs disagree on a pair
_ACROSS_OUTPUTS = ("classes", "iou_side", "priority")


def _raw_iou(r, bi, sel):
    """IoU in float64 of the selected anchors of image bi of a raw output."""
    return _iou64(r["boxes"][bi].cpu().numpy()[sel])


def _raw_probiou(r, bi, sel):
    """obb's probabilistic IoU in float64 of the selected anchors (boxes and
    the angle, extras[..., 0])."""
    ob = torch.cat([r["boxes"][bi], r["extras"][bi, :, :1]], -1).cpu().numpy()
    return _probiou64(ob[sel])


def _nms_disagreement(raws, confs, t, nms_thresh, overlap=_raw_iou, within=True):
    """None when NMS over the candidates at or above t must decide alike in
    every raw output; else why it may not, as a dict. ``overlap(raw,
    image, selection)`` gives the candidates' IoU matrix in float64
    (`_raw_probiou` for rotated boxes; None for a tail without NMS, where
    only the candidates must agree). With ``within`` False the tests
    within each output are skipped: the outputs need only agree on every
    decision (for outputs that are each computed the same way by the raw
    and the served run). Within each output
    first: the same candidates pass in each ("candidates"), no same-class
    pair has an IoU within 1e-4 of the threshold ("iou_at_threshold"), and
    no same-class pair near or above it has scores under 1e-6 apart unless
    tied exactly ("score_gap"). Then across outputs (`_ACROSS_OUTPUTS`),
    with the pair (anchor indices, its scores, IoU and classes in each
    output): the candidates' classes agree, and every same-class pair near
    or above the threshold in any output lies on the same side of it
    ("iou_side") and has the same priority, higher score then lower index
    ("priority"), in every output."""
    if not all(np.array_equal(c >= t, confs[0] >= t) for c in confs):
        return {"why": "candidates"}
    if overlap is None:         # an NMS-free tail: the gate is the only decision
        return None
    images = []
    for bi in range(confs[0].shape[0]):
        sel = confs[0][bi] >= t
        images.append((bi, np.nonzero(sel)[0],
                       [r["cls"][bi].cpu().numpy()[sel] for r in raws],
                       [overlap(r, bi, sel) for r in raws],
                       [c[bi][sel].astype(np.float64) for c in confs]))
    for bi, _, cls, ious, scs in images if within else ():
        for cl, iou, sc in zip(cls, ious, scs):
            same = cl[:, None] == cl[None, :]
            d = np.abs(sc[:, None] - sc[None, :])
            if (same & (np.abs(iou - nms_thresh) < 1e-4)).any():
                return {"why": "iou_at_threshold", "image": bi}
            if (same & (iou > nms_thresh - 1e-4) & (d > 0) & (d < 1e-6)).any():
                return {"why": "score_gap", "image": bi}
    for bi, idx, cls, ious, scs in images:
        if not all(np.array_equal(c, cls[0]) for c in cls):
            i = int(np.nonzero(np.logical_or.reduce([c != cls[0] for c in cls]))[0][0])
            return {"why": "classes", "image": bi, "anchor": int(idx[i]),
                    "classes": [int(c[i]) for c in cls]}
        same = cls[0][:, None] == cls[0][None, :]
        near = same & np.logical_or.reduce([iou > nms_thresh - 1e-4 for iou in ious])
        over = [near & (iou > nms_thresh) for iou in ious]
        prio = [near & ((sc[:, None] > sc[None, :])
                        | ((sc[:, None] == sc[None, :]) & (idx[:, None] < idx[None, :])))
                for sc in scs]
        for why, m in (("iou_side", over), ("priority", prio)):
            diff = np.logical_or.reduce([x != m[0] for x in m])
            if diff.any():
                i, j = np.argwhere(diff)[0]
                return {"why": why, "image": bi, "anchors": [int(idx[i]), int(idx[j])],
                        "scores": [[float(s[i]), float(s[j])] for s in scs],
                        "iou": [float(u[i, j]) for u in ious],
                        "classes": [int(cls[0][i]), int(cls[0][j])]}
    return None


def _safe_conf_thresh(raws, nms_thresh, max_det, overlap=_raw_iou, within=True):
    """A confidence threshold at which the detections cannot depend on
    float32 rounding: it sits in a gap of ≥ 1e-6 between distinct scores of
    every raw output given, fewer than max_det candidates pass it, and NMS
    over the candidates must decide alike in every output
    (`_nms_disagreement`). Picks the one with the most candidates; the
    random-weight network's scores sit in narrow bands, so the count can
    be small. Raises when there is none.

    Returns (threshold, candidates, witness). The witness is the threshold
    that the tests within each output alone would pick, when it has more
    candidates and the outputs disagree there on a pair, with that pair:
    a second look at what rounding does to NMS on these outputs
    (`_check_detections` logs it). None when there is no such threshold.
    ``overlap`` and ``within`` as in `_nms_disagreement`."""
    confs = [r["conf"].cpu().numpy() for r in raws]
    values = np.unique(np.concatenate([c.ravel() for c in confs]))[::-1]
    best, witness = None, None
    for hi, lo in zip(values[:-1], values[1:]):
        if hi - lo < 1e-6:
            continue
        t = float((np.float64(hi) + np.float64(lo)) / 2)
        n = max(int((c >= t).sum(-1).max()) for c in confs)
        if n >= max_det:
            break
        if best is not None and n <= best[1]:
            continue
        why = _nms_disagreement(raws, confs, t, nms_thresh, overlap, within)
        if why is None:
            best = (t, n)
        elif why["why"] in _ACROSS_OUTPUTS and (witness is None or n > witness["candidates"]):
            witness = {"conf_thresh": t, "candidates": n, **why}
    if best is None:
        raise AssertionError("no rounding-safe confidence threshold in the raw outputs")
    if witness is not None and witness["candidates"] <= best[1]:
        witness = None
    return best[0], best[1], witness


def _match(a, b, overlap=_iou64):
    """IoU-match detections a to b (same class, greedy by IoU; ``overlap``
    maps stacked boxes to their IoU matrix, `_probiou64` for obb's boxes
    with their angle); returns (the smallest matched IoU, the matched
    (i, j) pairs): (1.0, []) when both are empty, (0.0, []) when their
    counts differ."""
    if len(a["boxes"]) != len(b["boxes"]):
        return 0.0, []
    if len(a["boxes"]) == 0:
        return 1.0, []
    iou = overlap(np.concatenate([a["boxes"], b["boxes"]]))[:len(a["boxes"]), len(a["boxes"]):]
    iou = np.where(a["classes"][:, None] == b["classes"][None, :], iou, -1.0)
    worst, used, pairs = 1.0, set(), []
    for i in np.argsort(-iou.max(1)):
        j = max((j for j in range(iou.shape[1]) if j not in used),
                key=lambda j: iou[i, j])
        used.add(j)
        pairs.append((int(i), j))
        worst = min(worst, float(iou[i, j]))
    return worst, pairs


def _check_raw(what, raws, box_px, cls_min, moved_max=1.0, control=False, conf_max=1e-4):
    """Raw per-anchor outputs on the card (raws[0]) against the CPU's
    (raws[1]): same shapes, finite boxes, conf within conf_max, boxes within
    box_px, classes equal on at least cls_min of the anchors, and under
    moved_max of the box coordinates off by more than 0.01 px. Returns
    the measured differences; a `control` (a deliberately faulty path)
    raises only on a bad shape and adds whether it is within the bars."""
    g, c = ({k: v.cpu() for k, v in r.items()} for r in raws)
    if not (g["conf"].shape == c["conf"].shape and torch.isfinite(g["boxes"]).all()):
        raise AssertionError(f"{what} raw outputs: bad shape or non-finite boxes")
    d = (g["boxes"] - c["boxes"]).abs()
    st = {"conf_max_abs_err": float((g["conf"] - c["conf"]).abs().max()),
          "box_max_abs_err_px": float(d.max()),
          "box_coords_over_0_01_px": float((d > 0.01).float().mean()),
          "class_agreement": float((g["cls"] == c["cls"]).float().mean())}
    within = not (st["conf_max_abs_err"] > conf_max or st["box_max_abs_err_px"] > box_px
                  or st["box_coords_over_0_01_px"] >= moved_max
                  or st["class_agreement"] < cls_min)
    if control:
        return st | {"within_bars": within}
    if not within:
        raise AssertionError(f"{what} raw outputs differ: {st}")
    return st


def _check_detections(what, raws, serve_at, cascade=False):
    """The detection stage on the card against the CPU: `select_and_nms`
    at conf 0.25 on the card's own raw outputs, on the card and on the CPU
    (bit-equal); then the end-to-end detections of both devices
    (``serve_at(thr)`` returns the two detection dicts) at a threshold where
    NMS must decide alike on both (`_safe_conf_thresh`): counts equal,
    boxes IoU-matched ≥ 0.99, compared in letterboxed coordinates (mapped
    back to an image, a box in the letterbox border clips to zero area).
    Where `_safe_conf_thresh` gives a witness, NMS runs at its threshold on
    each device's raw outputs (on the CPU, so only the inputs differ) and
    the kept counts are logged beside the pair the outputs disagree on.

    With ``cascade`` (an int8 path whose rounding flips cascade, so that its
    confidences differ across the devices by more than their spacing) a
    threshold may not exist at which the same candidates pass on both
    devices; then each device's served detections at conf 0.25 are held
    bit-equal to `select_and_nms` of its own raw outputs instead."""
    from tensorrtx_tpu_torch.ops.nms import select_and_nms

    g = raws[0]
    args = (g["boxes"], g["conf"], g["cls"], 0.25, NMS_THRESH, N_CAND)
    on_dev = select_and_nms(*args).as_dict()
    on_cpu = select_and_nms(*(a.cpu() if torch.is_tensor(a) else a for a in args)).as_dict()
    for k in on_cpu:
        if not torch.equal(on_dev[k].cpu(), on_cpu[k]):
            raise AssertionError(f"{what}: select_and_nms on the card vs the CPU: "
                                 f"field {k} differs")
    st = {"nms_on_same_candidates": "bit-equal",
          "nms_count_at_0_25": on_cpu["count"].tolist()}
    try:
        thr, n_cand, witness = _safe_conf_thresh(raws, NMS_THRESH, N_CAND)
    except AssertionError:
        if not cascade:
            raise
        outs = serve_at(0.25)
        for o, r in zip(outs, raws):
            ref = select_and_nms(r["boxes"], r["conf"], r["cls"], 0.25, NMS_THRESH, N_CAND)
            for k, v in ref.as_dict().items():
                if not torch.equal(o[k], v):
                    raise AssertionError(f"{what}: served detections on {v.device} differ from "
                                         f"select_and_nms of its raw outputs in {k}")
        return st | {"end_to_end": "no threshold at which the same candidates pass on both "
                                   "devices; each device's served detections at 0.25 bit-equal "
                                   "to select_and_nms of its own raw outputs",
                     "counts": [o["count"].tolist() for o in outs]}
    if witness is not None:
        witness["nms_counts"] = [select_and_nms(
            r["boxes"].cpu(), r["conf"].cpu(), r["cls"].cpu(), witness["conf_thresh"],
            NMS_THRESH, N_CAND).count.tolist() for r in raws]
        st["rounding_witness"] = witness
    outs = [{k: v.cpu().numpy() for k, v in o.items()} for o in serve_at(thr)]
    counts = [o["count"].tolist() for o in outs]
    worst = 1.0
    for i, n in enumerate(counts[1]):
        a, b = ({"boxes": o["boxes"][i][:n], "classes": o["classes"][i][:n]} for o in outs)
        worst = min(worst, _match(a, b)[0])
    if counts[0] != counts[1] or worst < 0.99:
        raise AssertionError(f"{what} detections differ: counts {counts}, worst IoU {worst}")
    return st | {"conf_thresh": thr, "candidates": n_cand, "counts": counts[0],
                 "worst_iou": worst}


def phase_f32_parity(device, size=SIZE, bucket=BUCKET):
    """float32 YOLO11n on the card against the port's CPU path, TF32 off:
    letterbox, raw head outputs and detections (`_check_detections`)."""
    from tensorrtx_tpu_torch.core.runner import ServingPipeline
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

    raws = [_eager(ServingPipeline(_engine("fp32", d, size, postprocess="raw"), *bucket).fused,
                   frames, src_hw, d) for d in (device, cpu)]
    raw = _check_raw("f32", raws, 1e-2, 0.999)
    dets = _check_detections("f32", raws, lambda thr: [
        _eager(ServingPipeline(_engine("fp32", d, size, conf_thresh=thr), *bucket).fused,
               frames, src_hw, d) for d in (device, cpu)])
    log("f32_parity", size=size, frames=[list(s) for s in shapes],
        letterbox_max_abs_err=lb_err, **raw, **dets)


def _serving_images(bucket=BUCKET):
    """One 640×480 request and a batch of 32 (480×640, 640×426, 320×320
    in turn) in the bucket."""
    shapes = [(bucket[0] * 3 // 4, bucket[1]), (bucket[0], bucket[1] * 2 // 3),
              (bucket[0] // 2, bucket[1] // 2)]
    images = synthetic_frames(2, shapes)
    return images[:1], [images[i % len(images)] for i in range(32)]


def _eager(fn, frames, src_hw, device):
    """fn (a pipeline's `fused`, a chained engine's `raw_serve`) on the
    frames copied to `device` from pageable host memory: the eager route,
    one launch per op, as every serving path ran before the CUDA graphs."""
    return fn(torch.from_numpy(frames).to(device),
              torch.from_numpy(np.asarray(src_hw, np.int32)).to(device))


def _eager_serve(fn, device, cfg, bucket=BUCKET):
    """serve(images) → per-image detections by the eager route."""
    from tensorrtx_tpu_torch.core.runner import present_detections

    def serve(images):
        frames, src_hw = frames_of(images, bucket)
        return present_detections(_eager(fn, frames, src_hw, device), src_hw, cfg)
    return serve


def _well_formed(r):
    """One image's served result: detections (boxes (n, 4), scores, n ≤
    max_det, all finite) or cls's logits (a finite vector)."""
    if isinstance(r, np.ndarray):
        return r.ndim == 1 and np.isfinite(r).all()
    n = len(r["boxes"])
    return (r["boxes"].shape == (n, 4) and np.isfinite(r["boxes"]).all()
            and np.isfinite(r["scores"]).all() and n <= N_CAND)


def _timed_serving(phase, device, fused, cfg, per_forward, bucket=BUCKET, n_b1=30, n_b32=5,
                   serve=None, profile=True, **info):
    """Serve b1 requests and b32 batches by the eager route (``serve``,
    images → per-image results, by default `_eager_serve` of the path's
    device function ``fused``): warm both, set the launch counts to 0,
    time n_b1 b1 and n_b32 b32 calls with CUDA events (wall), read the
    counts and check that each forward launched `per_forward` of each
    kernel and, unless `per_forward` counts nms_mask, an NMS, and that the
    results are well formed (`_well_formed`). Then
    the device time per call: the forward on device-resident frames from
    CUDA events queued behind a GPU sleep (`core/profiler.device_p50_ms`),
    plus the pageable H2D of the frames; and, with ``profile``, the largest
    device items of a served call from a profiled window whose NMS launches
    are all recorded. Returns (launches of the run, timings)."""
    from tensorrtx_tpu_torch.core.profiler import device_p50_ms
    from tensorrtx_tpu_torch.core.runner import cuda_event_ms

    serve = serve or _eager_serve(fused, device, cfg, bucket)
    one, batch32 = _serving_images(bucket)
    serve(one)                               # warm: cuDNN algorithm choice
    serve(batch32)
    if device.type == "cuda":
        torch.cuda.synchronize()

    _reset_launches()                        # the path's run starts here
    results = []
    if device.type == "cuda":
        b1 = cuda_event_ms(lambda: results.append(serve(one)), iters=n_b1, warmup=0)
        b32 = cuda_event_ms(lambda: results.append(serve(batch32)), iters=n_b32, warmup=0)
    else:
        results = [serve(one), serve(batch32)]
        b1 = b32 = [float("nan")]
        n_b1 = n_b32 = 1
    launches = _launches()
    n_fwd = n_b1 + n_b32
    want = {k: v * n_fwd for k, v in per_forward.items()}
    nms = "nms_mask" not in per_forward
    if device.type == "cuda" and (any(launches[k] != v for k, v in want.items())
                                  or nms and launches["nms_mask"] < n_fwd):
        raise AssertionError(f"{phase}: {n_fwd} forwards launched {launches}, not "
                             f"{per_forward}" + (" and an NMS each" if nms else ""))
    if not all(_well_formed(r) for res in results for r in res):
        raise AssertionError(f"{phase} returned malformed results")
    timing = {"b1_ms_per_img": float(np.median(b1)),
              "b32_ms_per_img": float(np.median(b32)) / 32}
    if device.type == "cuda":
        dev = {}
        for b, images, iters in ((1, one, 10), (32, batch32, 3)):
            frames, src_hw = frames_of(images, bucket)
            args = (torch.from_numpy(frames).to(device), torch.from_numpy(src_hw).to(device))
            fwd = device_p50_ms(fused, [args], iters)
            h2d = float(np.median(cuda_event_ms(lambda: torch.from_numpy(frames).to(device),
                                                iters=10 if b == 1 else 5, warmup=1)))
            dev[b] = (fwd, h2d)
        timing |= {f"b{b}_{k}": v for b, (fwd, h2d) in dev.items()
                   for k, v in (("forward_ms", fwd), ("h2d_pageable_ms", h2d))}
        timing |= {"b1_device_ms_per_img": sum(dev[1]),
                   "b32_device_ms_per_img": sum(dev[32]) / 32,
                   "device_ms_source": "queued_events (forward) + cuda_events (pageable H2D)"}
        timing |= {f"b{b}_device_idle_share": 1 - timing[f"b{b}_device_ms_per_img"]
                   / timing[f"b{b}_ms_per_img"] for b in (1, 32)}
        expect = ("nms_mask_kernel", 1) if per_forward.get("nms_mask", 1) else None
        timing |= {f"b{b}_top_device_items": _device_profile(lambda: serve(images), iters,
                                                             expect=expect)[1] or None
                   for b, images, iters in ((1, one, 10), (32, batch32, 3)) if profile}
    counts = {"counts_b1": [len(r["boxes"]) for r in results[0]],
              "counts_b32": [len(r["boxes"]) for r in results[-1]]} \
        if isinstance(results[0][0], dict) else {}
    log(phase, **info, route="eager", requests_b1=n_b1, batches_b32=n_b32, **timing,
        launches=launches, launches_per_forward={k: v / n_fwd for k, v in launches.items()},
        **counts)
    return launches, timing


def phase_serving(device, pipe, bucket=BUCKET):
    """bf16 YOLO11n serving (the float path) by the eager route: b1
    requests and b32 batches."""
    return _timed_serving("serving", device, pipe.fused, pipe.engine.cfg, {}, bucket,
                          precision="bf16", size=pipe.engine.cfg.input_h)


def _graph_frame_sets(b, bucket=BUCKET):
    """Three frame sets of b images each: at b = 1 one image each of
    640×480, 426×640 and 320×320; at b = 32 images of random true sizes
    from 160² up to the bucket."""
    sets = []
    for j in range(3):
        if b == 1:
            shapes = [[(bucket[0] * 3 // 4, bucket[1]), (bucket[0], bucket[1] * 2 // 3),
                       (bucket[0] // 2, bucket[1] // 2)][j]]
        else:
            rng = np.random.default_rng(30 + j)
            shapes = [(int(rng.integers(bucket[0] // 4, bucket[0] + 1)),
                       int(rng.integers(bucket[1] // 4, bucket[1] + 1))) for _ in range(b)]
        sets.append(frames_of(synthetic_frames(20 + 10 * j + b, shapes), bucket))
    return sets


def _as_dict(out):
    """A path's result as a dict of tensors: cls's logits as "logits"."""
    return {"logits": out} if torch.is_tensor(out) else out


def _check_bit_equal(what, got, ref):
    got, ref = _as_dict(got), _as_dict(ref)
    diff = [k for k in ref if not torch.equal(got[k], ref[k])]
    if set(got) != set(ref) or diff:
        raise AssertionError(f"{what}: the replay differs from the eager forward in "
                             f"{diff or sorted(set(got) ^ set(ref))}")


def phase_graph_serving(path, device, call, fused, graphs, serve, eager, bucket=BUCKET,
                        n_b1=30, n_b32=5):
    """One path served by its captured CUDA graphs (`core/runner.GraphRunner`):
    capture b1 and b32 (warm-up and capture seconds); hold the replayed
    detection dict bit-equal to the eager forward (``fused`` on the same
    frames, copied to the card) on three frame sets of different true sizes
    at each batch; then time n_b1 b1 requests and n_b32 b32 batches through
    ``serve`` (`detect_images`, or ``__call__`` and `present_detections`)
    as `_timed_serving` times the eager route (``eager``, its timings in
    this run), the device time of one replayed call (pinned H2D + replay +
    the copies of its outputs) from queued CUDA events, the pinned H2D
    alone, and the memory the graphs hold and the peak."""
    from tensorrtx_tpu_torch.core.profiler import device_p50_ms, queued_ms
    from tensorrtx_tpu_torch.core.runner import cuda_event_ms

    cuda = device.type == "cuda"
    capture_s, st = {}, {}
    if cuda:
        torch.cuda.synchronize()
        held0 = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        for b in (1, 32):
            st[b] = graphs.staged((b, *bucket, 3))
            capture_s[f"b{b}"] = st[b].capture_s
        held = torch.cuda.memory_allocated(device) - held0
    sizes = {}
    for b in (1, 32):
        sets = _graph_frame_sets(b, bucket)
        for j, (frames, src_hw) in enumerate(sets):
            _check_bit_equal(f"graph_serving ({path}) b{b} frame set {j}", call(frames, src_hw),
                             _eager(fused, frames, src_hw, device))
        sizes[f"b{b}"] = [len({tuple(hw) for hw in src_hw.tolist()}) for _, src_hw in sets]
    timing = {}
    if cuda:
        one, batch32 = _serving_images(bucket)
        b1 = cuda_event_ms(lambda: serve(one), iters=n_b1, warmup=1)
        b32 = cuda_event_ms(lambda: serve(batch32), iters=n_b32, warmup=1)
        dev1 = device_p50_ms(st[1].launch, [()], 20)
        dev32 = device_p50_ms(st[32].launch, [()], 5)
        timing = {"b1_ms_per_img": float(np.median(b1)), "b32_ms_per_img": float(np.median(b32)) / 32,
                  "b1_device_ms_per_img": dev1, "b32_device_ms_per_img": dev32 / 32,
                  "device_ms_source": "queued_events",
                  "b1_h2d_pinned_ms": queued_ms(lambda: st[1].frames.copy_(
                      st[1].host_frames, non_blocking=True), 20),
                  "b32_h2d_pinned_ms": queued_ms(lambda: st[32].frames.copy_(
                      st[32].host_frames, non_blocking=True), 5)}
        timing |= {f"b{b}_device_idle_share": 1 - timing[f"b{b}_device_ms_per_img"]
                   / timing[f"b{b}_ms_per_img"] for b in (1, 32)}
        timing |= {"capture_s": capture_s, "graphs_hold_gb": held / 1e9,
                   "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
                   "b1_wall_graph_over_eager": timing["b1_ms_per_img"] / eager["b1_ms_per_img"],
                   "b32_wall_graph_over_eager": timing["b32_ms_per_img"] / eager["b32_ms_per_img"]}
    keys = ("b1_ms_per_img", "b32_ms_per_img", "b1_device_ms_per_img", "b32_device_ms_per_img",
            "b1_device_idle_share", "b32_device_idle_share", "b32_h2d_pageable_ms")
    log("graph_serving", path=path, route="cuda_graph", requests_b1=n_b1, batches_b32=n_b32,
        bit_equal_frame_sets={k: len(v) for k, v in sizes.items()},
        distinct_true_sizes_per_set=sizes, **timing,
        eager={k: eager[k] for k in keys if k in eager})
    return timing


def phase_stream(path, device, owner, fused, eager, k=16, bucket=BUCKET):
    """`stream_fn(k)` of a path: k batch-1 forwards in one CUDA graph, held
    bit-equal to k eager b1 forwards on the same frames (16 true sizes);
    the device time per image of one replayed call from queued CUDA events,
    beside the eager route's b1 device time in this run."""
    from tensorrtx_tpu_torch.core.profiler import device_p50_ms

    rng = np.random.default_rng(40)
    shapes = [(int(rng.integers(bucket[0] // 4, bucket[0] + 1)),
               int(rng.integers(bucket[1] // 4, bucket[1] + 1))) for _ in range(k)]
    frames, src_hw = frames_of(synthetic_frames(41, shapes), bucket)
    run = owner.stream_fn(k)
    t0 = time.perf_counter()
    got = _as_dict(run(frames, src_hw))
    if device.type == "cuda":
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for i in range(k):
        _check_bit_equal(f"stream ({path}) frame {i}", {key: v[i] for key, v in got.items()},
                         _eager(fused, frames[i:i + 1], src_hw[i:i + 1], device))
    st = {}
    if device.type == "cuda":
        per_call = device_p50_ms(run.staged(frames.shape).launch, [()], 5)
        st = {"device_ms_per_img": per_call / k, "device_ms_source": "queued_events",
              "eager_b1_device_ms_per_img": eager["b1_device_ms_per_img"],
              "eager_b1_forward_ms": eager["b1_forward_ms"]}
    log("stream", path=path, k=k, bit_equal_frames=k, leaf_shapes={key: list(v.shape)
                                                                    for key, v in got.items()},
        capture_and_first_call_s=first_s, **st)
    return st


# ---------------------------------------------------------------------------
# the float paths beyond yolo11 det: yolo11's other tasks, yolov8 (its
# tasks, P2 and 5u), yolov10 and yolo26
# ---------------------------------------------------------------------------

# each path at its published input size and class count (the JAX package's
# cfgs: pose 1 class and 17 keypoints, obb 15 classes at 1024², cls 1000
# classes at 224²), scale n, max_det N_CAND: name → (model, task, size,
# classes, other cfg fields)
PATHS = {
    "seg": ("yolo11", "seg", 640, 80, {}), "pose": ("yolo11", "pose", 640, 1, {}),
    "obb": ("yolo11", "obb", 1024, 15, {}), "cls": ("yolo11", "cls", 224, 1000, {}),
    "v8_det": ("yolov8", "det", 640, 80, {}), "v8_seg": ("yolov8", "seg", 640, 80, {}),
    "v8_pose": ("yolov8", "pose", 640, 1, {}), "v8_obb": ("yolov8", "obb", 1024, 15, {}),
    "v8_cls": ("yolov8", "cls", 224, 1000, {}),
    "v8_p2": ("yolov8", "det", 640, 80, {"variant": "p2"}),
    "v8_5u": ("yolov8", "det", 640, 80, {"variant": "5u"}),
    "v10_det": ("yolov10", "det", 640, 80, {}),
    "y26_det": ("yolo26", "det", 640, 80, {}), "y26_obb": ("yolo26", "obb", 1024, 15, {}),
    "y26_cls": ("yolo26", "cls", 224, 1000, {}),
}
TASKS = [p for p, v in PATHS.items() if v[0] == "yolo11"]      # yolo11's four task paths
# the NMS-free models: select_topk, no NMS
TOPK_MODELS = ("yolov10", "yolo26")
# the paths whose forward runs the nms_mask kernel (obb's rotated keep mask
# is probiou in torch ops, as in the JAX package; cls and the NMS-free
# heads have no NMS)
TASK_NMS = {p: int(m not in TOPK_MODELS and t in ("det", "seg", "pose"))
            for p, (m, t, *_) in PATHS.items()}
# the paths served by `stream_fn(16)` too (every yolo11 task; v8 det)
STREAM_PATHS = (*TASKS, "v8_det")
# card against CPU, both float32 with TF32 off: max |Δ| bars of the task
# outputs beyond `_check_raw`'s (boxes 0.01 px, conf 1e-4, classes 99.9 %)
TASK_BARS = {"seg_coeffs": 1e-4, "proto_rel": 1e-4, "masks": 1e-4, "kpt_px": 1e-2,
             "kpt_conf": 1e-4, "angle": 1e-5, "logits_rel": 1e-4}
# a pose keypoint whose confidence lies within KPT_EPS[0] of its threshold,
# or whose (x, y) lies within KPT_EPS[1] px of an edge of its box, may be
# gated on one device and not on the other
KPT_EPS = (1e-5, 1e-2)


def _task_engine(path, precision, device, **over):
    model, task, size, nc, extra = PATHS[path]
    kw = dict(num_classes=nc, **extra, **over)
    if model != "yolov10":          # Yolov10Cfg has no task field: det only
        kw["task"] = task
    return _engine(precision, device, size, model, **kw)


def _keypoints(got, ref, boxes_g, boxes_r, kpt_thresh=0.5):
    """Decoded keypoints (..., 3K) on the card (got) against the CPU (ref):
    the max |Δ| of x, y and conf where neither is gated (−1), and the
    keypoints gated on one device only, each of which must lie within
    KPT_EPS of a threshold on the other (raises otherwise)."""
    g = got.reshape(*got.shape[:-1], -1, 3).astype(np.float64)
    r = ref.reshape(*ref.shape[:-1], -1, 3).astype(np.float64)
    gg, gr = g[..., 2] == -1, r[..., 2] == -1
    both = ~gg & ~gr
    st = {"kpt_xy_max_abs_err_px": float(np.abs(g[both][:, :2] - r[both][:, :2]).max(initial=0)),
          "kpt_conf_max_abs_err": float(np.abs(g[both][:, 2] - r[both][:, 2]).max(initial=0)),
          "kpts_ungated": int(both.sum()), "kpts_gated_apart": 0}
    for side, apart, bx in ((g, gr & ~gg, boxes_g), (r, gg & ~gr, boxes_r)):
        for i in np.argwhere(apart):
            x, y, c = side[tuple(i)]
            b = bx[tuple(i[:-1])].astype(np.float64)
            edge = min(x - b[0], b[2] - x, y - b[1], b[3] - y)
            if not (c - kpt_thresh < KPT_EPS[0] or edge < KPT_EPS[1]):
                raise AssertionError(f"keypoint {i.tolist()} gated on one device only, "
                                     f"conf {c}, {edge} px inside its box")
            st["kpts_gated_apart"] += 1
    if st["kpt_xy_max_abs_err_px"] > TASK_BARS["kpt_px"] \
            or st["kpt_conf_max_abs_err"] > TASK_BARS["kpt_conf"]:
        raise AssertionError(f"pose keypoints differ: {st}")
    return st


def _check_extras(task, raws):
    """The raw task outputs beyond boxes, conf and classes, card (raws[0])
    against CPU (raws[1]): seg's mask coefficients and proto, pose's
    keypoints (`_keypoints`), obb's angle, within TASK_BARS."""
    g, c = ({k: v.float().cpu().numpy() for k, v in r.items()} for r in raws)
    if task == "pose":
        return _keypoints(g["extras"], c["extras"], g["boxes"], c["boxes"])
    err = float(np.abs(g["extras"] - c["extras"]).max())
    st = {"extras_max_abs_err": err}
    bad = err > TASK_BARS["angle" if task == "obb" else "seg_coeffs"]
    if task == "seg":
        st["proto_max_abs_err"] = float(np.abs(g["proto"] - c["proto"]).max())
        st["proto_max_abs"] = float(np.abs(c["proto"]).max())
        bad |= st["proto_max_abs_err"] > TASK_BARS["proto_rel"] * (1 + st["proto_max_abs"])
    if bad:
        raise AssertionError(f"{task} raw extras differ: {st}")
    return st


def _geometry(task, d, i, n):
    """The first n detections of image i as `_match` takes them: obb's boxes
    carry their angle (extras[..., 0]) as a fifth column."""
    bx = d["boxes"][i][:n]
    if task == "obb":
        bx = np.concatenate([bx, d["extras"][i][:n, :1]], -1)
    return {"boxes": bx, "classes": d["classes"][i][:n]}


def _probiou_near_threshold(raw, conf_thresh=0.25):
    """The first same-class pair among an obb raw output's NMS slots (the
    top N_CAND candidates at conf_thresh) whose probiou in float64 lies
    within 1e-4 of NMS_THRESH, as a dict; None when there is none."""
    conf = raw["conf"].cpu().numpy()
    for bi in range(conf.shape[0]):
        top = np.argsort(-conf[bi], kind="stable")[:N_CAND]
        top = top[conf[bi][top] >= conf_thresh]
        iou = _raw_probiou(raw, bi, top)
        cls = raw["cls"][bi].cpu().numpy()[top]
        near = (cls[:, None] == cls[None, :]) & (np.abs(iou - NMS_THRESH) < 1e-4)
        if near.any():
            i, j = np.argwhere(near)[0]
            return {"why": "iou_at_threshold", "image": bi, "anchors": [int(top[i]), int(top[j])],
                    "probiou": float(iou[i, j])}
    return None


def _check_task_detections(task, raws, serve_at):
    """A task's detections on the card against the CPU, as
    `_check_detections` holds det's: `select_and_nms` (with the extras;
    obb's rotated mask) at conf 0.25 on the card's own raw outputs, on
    the card and on the CPU, bit-equal (obb: where no candidate pair lies
    within 1e-4 of the threshold, since probiou's log, sqrt and exp may
    round apart on the two devices); then the end-to-end detections
    (`_compare_served`) at the thresholds `_safe_conf_thresh` finds
    (probiou for obb): one safe within each output and across them, where
    there is one, and one safe across them only."""
    from tensorrtx_tpu_torch.ops.nms import select_and_nms

    g = raws[0]
    overlap = _raw_probiou if task == "obb" else _raw_iou
    args = (g["boxes"], g["conf"], g["cls"], 0.25, NMS_THRESH, N_CAND)
    kw = {"extras": g["extras"], "obb": task == "obb"}
    on_dev = select_and_nms(*args, **kw).as_dict()
    on_cpu = select_and_nms(*(a.cpu() if torch.is_tensor(a) else a for a in args),
                            extras=g["extras"].cpu(), obb=kw["obb"]).as_dict()
    why = _probiou_near_threshold(g) if task == "obb" else None
    if why is None:
        for k in on_cpu:
            if not torch.equal(on_dev[k].cpu(), on_cpu[k]):
                raise AssertionError(f"{task}: select_and_nms on the card vs the CPU: "
                                     f"field {k} differs")
    st = {"nms_on_same_candidates": "bit-equal" if why is None else {"not compared": why},
          "nms_count_at_0_25": on_cpu["count"].tolist()}
    # two thresholds: one safe within each output and across them (none
    # where same-class overlapping scores lie under 1e-6 apart at every
    # threshold, each device's order of them resting on its last bits, as
    # on obb with random weights), and one at which the two outputs need
    # only decide every pair alike, which admits more candidates
    found = {}
    try:
        found["within_and_across"] = _safe_conf_thresh(raws, NMS_THRESH, N_CAND, overlap)
    except AssertionError:
        st["within_and_across"] = "no such threshold"
    found["across_only"] = _safe_conf_thresh(raws, NMS_THRESH, N_CAND, overlap, within=False)
    done = {}
    for rule, (thr, n_cand, witness) in found.items():
        if thr not in done:
            done[thr] = _compare_served(task, serve_at(thr))
        st[rule] = {"conf_thresh": thr, "candidates": n_cand, **done[thr]}
        if witness is not None:
            st[rule]["rounding_witness"] = witness
    return st


def _check_topk_detections(task, raws, serve_at):
    """The NMS-free tail (yolov10, yolo26) on the card against the CPU:
    `select_topk` at conf 0.25 on the card's own raw outputs, on the card
    and on the CPU, bit-equal; then the end-to-end detections
    (`_compare_served`) at a threshold that the same candidates pass on
    both devices (`_safe_conf_thresh` with no NMS to agree on)."""
    from tensorrtx_tpu_torch.ops.nms import select_topk

    g = raws[0]
    kw = {"extras": g["extras"]} if "extras" in g else {}
    args = (g["boxes"], g["conf"], g["cls"], 0.25, N_CAND)
    on_dev = select_topk(*args, **kw).as_dict()
    on_cpu = select_topk(*(a.cpu() if torch.is_tensor(a) else a for a in args),
                         **{k: v.cpu() for k, v in kw.items()}).as_dict()
    for k in on_cpu:
        if not torch.equal(on_dev[k].cpu(), on_cpu[k]):
            raise AssertionError(f"{task}: select_topk on the card vs the CPU: field {k} differs")
    thr, n_cand, _ = _safe_conf_thresh(raws, NMS_THRESH, N_CAND, overlap=None)
    return {"topk_on_same_candidates": "bit-equal", "topk_count_at_0_25": on_cpu["count"].tolist(),
            "conf_thresh": thr, "candidates": n_cand, **_compare_served(task, serve_at(thr))}


def _compare_served(task, served):
    """The end-to-end detections of the card and the CPU (``served``, two
    detection dicts): counts equal, matched boxes' IoU ≥ 0.99 (obb:
    probiou; det: `_iou_or_coords64`), and on the matched slots seg's
    masks, pose's keypoints and obb's angle within TASK_BARS."""
    outs = [{k: v.float().cpu().numpy() for k, v in o.items()} for o in served]
    counts = [o["count"].astype(int).tolist() for o in outs]
    if counts[0] != counts[1]:
        raise AssertionError(f"{task} detections differ: counts {counts}")
    worst, err = 1.0, {}
    for i, n in enumerate(counts[1]):
        w, pairs = _match(_geometry(task, outs[0], i, n), _geometry(task, outs[1], i, n),
                          {"obb": _probiou64, "det": _iou_or_coords64}.get(task, _iou64))
        worst = min(worst, w)
        if not pairs:
            continue
        a, b = (np.array([p[k] for p in pairs]) for k in (0, 1))
        if task == "seg":
            e = float(np.abs(outs[0]["masks"][i][a] - outs[1]["masks"][i][b]).max())
            err["masks_max_abs_err"] = max(err.get("masks_max_abs_err", 0.0), e)
        elif task == "obb":
            e = float(np.abs(outs[0]["extras"][i][a] - outs[1]["extras"][i][b]).max())
            err["angle_max_abs_err"] = max(err.get("angle_max_abs_err", 0.0), e)
        elif task == "pose":
            kp = _keypoints(outs[0]["extras"][i][a], outs[1]["extras"][i][b],
                            outs[0]["boxes"][i][a], outs[1]["boxes"][i][b])
            for k, v in kp.items():
                err[f"dets_{k}"] = max(err.get(f"dets_{k}", 0), v) if "err" in k \
                    else err.get(f"dets_{k}", 0) + v
    if worst < 0.99 or err.get("masks_max_abs_err", 0) > TASK_BARS["masks"] \
            or err.get("angle_max_abs_err", 0) > TASK_BARS["angle"]:
        raise AssertionError(f"{task} detections differ: worst IoU {worst}, {err}")
    return {"counts": counts[0], "worst_iou": worst, **err}


def phase_task_parity(path, device, bucket=BUCKET):
    """A float32 path of PATHS at full width on the card against the port's
    CPU path (TF32 off), on two frames of different true sizes: the raw
    outputs (`_check_raw` with det's bars, `_check_extras`) and the
    detections (`_check_detections` for det with NMS,
    `_check_topk_detections` for the NMS-free heads, else
    `_check_task_detections`); cls's logits within
    TASK_BARS["logits_rel"]·(1 + max |logit|), and its top-5 classes equal
    where each of the six largest logits is more than twice the measured
    error from the next."""
    from tensorrtx_tpu_torch.core.runner import ServingPipeline

    model, task, size, nc, _ = PATHS[path]
    cpu = torch.device("cpu")
    shapes = [(bucket[0] * 3 // 4, bucket[1]), (bucket[0], bucket[1] * 2 // 3)]
    frames, src_hw = frames_of(synthetic_frames(1, shapes), bucket)

    def run(d, **over):
        pipe = ServingPipeline(_task_engine(path, "fp32", d, **over), *bucket)
        return _eager(pipe.fused, frames, src_hw, d)

    if task == "cls":
        g, c = (run(d).float().cpu().numpy() for d in (device, cpu))
        err = float(np.abs(g - c).max())
        if not (g.shape == (2, nc) and np.isfinite(g).all()) \
                or err > TASK_BARS["logits_rel"] * (1 + np.abs(c).max()):
            raise AssertionError(f"{path} logits on {device} vs cpu: shape {g.shape}, "
                                 f"max abs err {err}")
        top = np.sort(c, -1)[:, ::-1][:, :6]
        clear = (top[:, :5] - top[:, 1:6] > 2 * err).all(-1)
        same = [bool(np.array_equal(np.argsort(-g[i])[:5], np.argsort(-c[i])[:5]))
                for i in range(2)]
        if not all(s for s, ok in zip(same, clear) if ok):
            raise AssertionError(f"{path} top-5 differs where its margins are clear: {same}")
        log("task_parity", path=path, model=model, size=size, logits_max_abs_err=err,
            logits_max_abs=float(np.abs(c).max()), top5_compared=clear.tolist(),
            top5_equal=same)
        return
    raws = [run(d, postprocess="raw") for d in (device, cpu)]
    st = _check_raw(path, raws, 1e-2, 0.999)
    if task != "det":
        st |= _check_extras(task, raws)

    def serve_at(thr):
        return [run(d, conf_thresh=thr) for d in (device, cpu)]

    if model in TOPK_MODELS:
        st |= _check_topk_detections(task, raws, serve_at)
    elif task == "det":
        st |= _check_detections(path, raws, serve_at)
    else:
        st |= _check_task_detections(task, raws, serve_at)
    log("task_parity", path=path, model=model, size=size, frames=[list(x) for x in shapes], **st)


def _nms_on_path(fused, device, bucket=BUCKET):
    """nms_mask at the shapes a path gives it: the kernel's inputs caught in
    one eager forward of the b1 request and one of the b32 batch
    (`_serving_images`), then the kernel on them against its plain version,
    on the card and on the CPU: bit-equal keep masks."""
    from tensorrtx_tpu_torch.ops.cuda import nms_mask as kern

    out = {}
    orig = kern.keep_mask
    for images in _serving_images(bucket):
        seen = []
        kern.keep_mask = lambda *a: seen.append(a) or orig(*a)
        try:
            _eager(fused, *frames_of(images, bucket), device)
        finally:
            kern.keep_mask = orig
        (args,) = seen
        boxes, scores, classes, thresh = args
        keep = kern.keep_mask(*args)
        plain = kern.keep_mask_plain(*args)
        plain_cpu = kern.keep_mask_plain(boxes.cpu(), scores.cpu(), classes.cpu(), thresh)
        if not (torch.equal(keep, plain) and torch.equal(keep.cpu(), plain_cpu)):
            raise AssertionError(f"nms_mask disagrees with its plain version on the path's "
                                 f"B={len(images)} candidates")
        out[f"b{len(images)}"] = {"n": int(scores.shape[-1]), "valid": int((scores > 0).sum()),
                                  "kept": int(keep.sum()), "bit_equal": True}
    return out


def phase_task_serving(path, device, bucket=BUCKET, n_b1=30, n_b32=5, profile=True):
    """One path of PATHS as a user serves it: a bf16 engine at full width
    (scale n, `RandomWeightMap(seed=0)`, conf 0.25, max_det N_CAND) in a
    `ServingPipeline`. nms_mask on the path's candidates (`_nms_on_path`,
    where the path runs it); the eager route timed over n_b1 b1 requests and
    n_b32 b32 batches with its launches checked (`_timed_serving`:
    TASK_NMS[path] nms_mask a forward; its profiled top items with
    ``profile``); the CUDA graphs
    (`phase_graph_serving`: b1/b32 replays bit-equal to eager, timed through
    `detect_images`, cls through ``__call__``); `stream_fn(16)`
    (`phase_stream`) on STREAM_PATHS. Returns the eager run's launches, the
    nms_mask check, and the graphs' timings."""
    from tensorrtx_tpu_torch.core.runner import ServingPipeline

    model, task, size, _, _ = PATHS[path]
    pipe = ServingPipeline(_task_engine(path, "bf16", device, conf_thresh=0.25), *bucket)
    nms = _nms_on_path(pipe.fused, device, bucket) if TASK_NMS[path] else None
    info = {"path": path, "model": model, "precision": "bf16", "size": size}
    if task == "cls":
        def serve(images):
            return list(pipe.fused(*(torch.from_numpy(a).to(device)
                                     for a in frames_of(images, bucket))).float().cpu().numpy())

        def serve_graph(images):
            return list(pipe(*frames_of(images, bucket)).float().cpu().numpy())
    else:
        serve, serve_graph = None, pipe.detect_images
    launches, eager = _timed_serving("task_serving", device, pipe.fused, pipe.engine.cfg,
                                     {"nms_mask": TASK_NMS[path]}, bucket, n_b1, n_b32,
                                     serve=serve, profile=profile, **info)
    graph = phase_graph_serving(path, device, pipe, pipe.fused, pipe.graphs, serve_graph, eager,
                                bucket, n_b1, n_b32)
    if path in STREAM_PATHS:
        phase_stream(path, device, pipe, pipe.fused, eager, bucket=bucket)
    return launches, nms, graph


# ---------------------------------------------------------------------------
# the chained int8 tier
# ---------------------------------------------------------------------------

def _chained(precision, device, size, dtype=torch.bfloat16, model="yolo11", **over):
    from tensorrtx_tpu_torch.core.quant import ChainedInt8Engine

    return ChainedInt8Engine(_engine(precision, device, size, model, **over), dtype=dtype)


def _reset_launches():
    from tensorrtx_tpu_torch.ops.cuda import conv_planar, nms_mask, qconv, quantize

    nms_mask.launches = 0
    qconv.launches_3x3 = qconv.launches_1x1 = qconv.launches_1x1_fq = 0
    quantize.launches = quantize.launches_stochastic = 0
    conv_planar.launches_3x3 = conv_planar.launches_1x1 = 0


def _launches():
    """Launches of each kernel since `_reset_launches`; "qconv1x1_fq" counts
    the 1×1's launches from a float source (the quantize fused into its
    staging), "qconv3x3" and "qconv1x1" the launches from an int8 source."""
    from tensorrtx_tpu_torch.ops.cuda import conv_planar, nms_mask, qconv, quantize

    return {"nms_mask": nms_mask.launches, "qconv3x3": qconv.launches_3x3,
            "qconv1x1": qconv.launches_1x1, "qconv1x1_fq": qconv.launches_1x1_fq,
            "quantize_int8": quantize.launches,
            "quantize_int8_stochastic": quantize.launches_stochastic,
            "conv3x3_planar": conv_planar.launches_3x3,
            "conv1x1_planar": conv_planar.launches_1x1}


@contextlib.contextmanager
def _qconv_hook(hook):
    """While the block runs, every call of a qconv wrapper runs as usual
    and then hands (kernel name, args, kwargs, output) to hook."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    real = {"qconv3x3": qk.qconv3x3, "qconv1x1": qk.qconv1x1}

    def wrap(name):
        def fn(*args, **kw):
            out = real[name](*args, **kw)
            hook(name, args, kw, out)
            return out
        return fn

    for name in real:
        setattr(qk, name, wrap(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(qk, name, fn)


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
        _eager(ce.raw_serve, frames, [[size, size]], ce.device)
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
    (conv+add) epilogue, ReLU, the 173×16×128 map that the TPU kernel's
    tiling cannot take; for the 3×3 tensor-core GEMM the stem's C = 3 at
    stride 2 on an odd map (byte by byte), C = 8 (8-byte copies) and Co = 8
    (one n8 fragment); and the tails of the 1×1 GEMM: K (C = 48), N (Co =
    32, 10), M (5·7, 9·11 pixels) and the byte-wise path (C = 6)."""
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
        spec("qconv3x3", 3, (161, 97), 3, 16, act=None, out_float=True, out_dtype=torch.bfloat16,
             stride=2),
        spec("qconv3x3", 3, (40, 40), 8, 16, act="silu"),
        spec("qconv3x3", 3, (41, 39), 16, 8, act="silu", stride=2),
        spec("qconv1x1", 1, (40, 40), 256, 128, act="silu", residual=True),
        spec("qconv1x1", 1, (20, 20), 80, 80, act=None, out_float=True, out_dtype=torch.float32),
        spec("qconv1x1", 1, (5, 7), 48, 32, act="silu"),
        spec("qconv1x1", 1, (13, 7), 6, 10, act="relu", residual=True),
        spec("qconv1x1", 1, (9, 11), 512, 256, act="silu", residual=True),
        spec("qconv1x1", 1, (5, 7), 48, 32, act=None, out_float=True, out_dtype=torch.float32),
    ]


def _qconv_work(spec, batch, in_bytes=1):
    """(bytes, int8 operations) of one launch: input (`in_bytes` an
    element), weight, scale, bias, residual read once, output written once;
    two operations per MAC."""
    co, k, _, c = spec["wq"].shape
    stride = spec["kw"].get("stride", 1)
    h, w = spec["hw"]
    m = batch * ((h - 1) // stride + 1) * ((w - 1) // stride + 1)
    out_bytes = 1 if not spec["kw"].get("out_float") else spec["kw"]["out_dtype"].itemsize
    n_bytes = (batch * h * w * c * in_bytes + co * k * k * c + 8 * co
               + m * co * (out_bytes + spec["residual"]))
    return n_bytes, 2 * m * co * k * k * c


def _check_gemm_exact(where, args, kw):
    """qconv3x3 / qconv1x1 with a float32 exit, scale 1, no bias and no
    activation return their int32 sums as floats: bit-equal to the plain
    version's exact sums, or the GEMM is wrong."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    xq, wq = args[0], args[1]
    exact = (xq, wq, torch.ones(wq.shape[0], dtype=torch.float32, device=xq.device), None, None)
    ekw = {"act": None, "out_float": True, "out_dtype": torch.float32}
    name, fn = "qconv1x1", qk.qconv1x1
    if wq.shape[1] == 3:
        name, fn, ekw["stride"] = "qconv3x3", qk.qconv3x3, kw.get("stride", 1)
    got, ref = fn(*exact, **ekw), qk.qconv_plain(*exact, **ekw)
    if not torch.equal(got, ref):
        n = int((got != ref).sum())
        raise AssertionError(f"{name} GEMM is not exact at {where}: {n} of {ref.numel()} "
                             f"sums differ, max {float((got - ref).abs().max())}")


def _im2col(xq, stride):
    """(B·Ho·Wo, 9·C) int8: the (tap, c)-ordered A operand of qconv3x3's
    implicit GEMM, zero in the padding."""
    b, h, w, c = xq.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    xp = torch.nn.functional.pad(xq, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, ky:ky + stride * (ho - 1) + 1:stride, kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps, 3).reshape(b * ho * wo, 9 * c)


def _qconv3x3_per_shape(path, calls, batch):
    """qconv3x3's device time per distinct launch shape of a path (all of
    its launches at that shape in one forward), largest first: which shapes
    lead."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    groups = {}
    for a, k, sp in calls:
        kw = sp["kw"]
        shape = {"h": sp["hw"][0], "w": sp["hw"][1], "c": sp["c"], "co": sp["wq"].shape[0],
                 "stride": kw.get("stride", 1), "act": kw.get("act"),
                 "exit": str(kw["out_dtype"]).removeprefix("torch.") if kw.get("out_float")
                 else "int8"}
        groups.setdefault(tuple(shape.items()), []).append((a, k, sp))
    rows, sources = [], []
    for shape, grp in groups.items():
        t = _timings(ms=(lambda: [qk.qconv3x3(*a, **k) for a, k, _ in grp], 10))
        sources.append(t["ms_source"])
        n_bytes = sum(_qconv_work(sp, batch)[0] for _, _, sp in grp)
        rows.append(dict(shape) | {"launches": len(grp), "ms": t["ms"],
                                   "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3})
    rows.sort(key=lambda r: -r["ms"])
    log("qconv3x3_shapes", path=path, batch=batch, ms_source=_source(*sources), shapes=rows)


def phase_qconv(device, specs, batches=(1, 32), path="chain", extras=True):
    """qconv3x3 / qconv1x1 against their plain versions at every launch
    shape of the int8 path and at the extras, and their GEMM-exact output
    (`_check_gemm_exact`) bit-equal there; then, at each batch, the device
    time of all the path's launches of each kernel (one forward's worth), of
    their plain versions and of the library's int8 product (`torch._int_mm`,
    a yardstick the port never calls: for the 1×1 the same function up to
    the epilogue; for the 3×3 only the GEMM, on im2col operands built
    beforehand, for the launches whose K = 9·C is a multiple of 8), the
    bound of the same work, and at B = 32 qconv3x3's time per shape. The
    extras (`_extra_specs`) run with ``extras``; they do not depend on the
    model."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    rng = np.random.default_rng(7)
    fns = {"qconv3x3": qk.qconv3x3, "qconv1x1": qk.qconv1x1}
    out = {}
    for b in batches:
        stats = {name: {"max_abs_err": 0.0, "float_exit_max_abs_err": 0.0, "worst_frac": 0.0,
                        "gemm_exact_bit_equal": 0} for name in fns}
        runs = {name: [] for name in fns}
        extras = _extra_specs(device, rng) if extras else []
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
            _check_gemm_exact(where, args, kw)
            st["gemm_exact_bit_equal"] += 1
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
                lib = {}
                if name == "qconv1x1":
                    mats = [(a[0].reshape(-1, a[0].shape[-1]), a[1].reshape(a[1].shape[0], -1).t())
                            for a, _, _ in calls]
                    lib = {"library_ms": (lambda: [torch._int_mm(x, w) for x, w in mats], 10)}
                else:
                    mats = [(_im2col(a[0], k.get("stride", 1)), a[1].reshape(a[1].shape[0], -1).t())
                            for a, k, _ in calls if a[1].shape[3] % 8 == 0]
                    st["int_mm_im2col_launches"] = len(mats)
                    lib = {"int_mm_im2col_ms": (lambda: [torch._int_mm(x, w) for x, w in mats], 10)}
                st |= _timings(ms=(lambda: [fn(*a, **k) for a, k, _ in calls], 10),
                               plain_ms=(lambda: [qk.qconv_plain(*a, **k) for a, k, _ in calls], 3),
                               **lib)
                del mats
                if name == "qconv3x3" and b == 32:
                    _qconv3x3_per_shape(path, calls, b)
            stats[name] = st
            log("kernel_vs_plain", kernel=name, path=path, batch=b, shapes=len(calls),
                extras=sum(sp["name"] == name for sp in extras), **st)
        out[b] = stats
    return out


def phase_int8_shadow(ce, frames, src_hw, expect=(31, 37), path="chain"):
    """One chained forward on the card with every qconv launch recomputed
    by its plain version on the same inputs: both kernels at all the path's
    real shapes on real activations; ``expect``: its (qconv3x3, qconv1x1)
    launches. Returns each kernel's worst int8 error in LSB."""
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
        out = _eager(ce.raw_serve, frames, src_hw, ce.device)
    if ce.device.type == "cuda":
        torch.cuda.synchronize()
    launches = _launches()
    if ce.device.type == "cuda" and ((launches["qconv3x3"], launches["qconv1x1"]) != expect
                                     or launches["nms_mask"] < 1):
        raise AssertionError(f"the {path} forward launched {launches}, not {expect} qconvs "
                             f"and NMS")
    if not all(torch.isfinite(v.float()).all() for v in out.values()):
        raise AssertionError("int8 shadow forward: non-finite detections")
    log("int8_shadow", path=path, batch=frames.shape[0], convs=len(rows), launches=launches,
        worst_lsb=worst["lsb"][0], worst_lsb_share=worst["lsb"][1], worst_conv=worst["lsb"][2],
        worst_float_exit_abs_err=worst["float"][0], worst_float_exit=worst["float"][1])
    return per_kernel


# the ChainCtx ops that fill a scale slot, each with an int8 payload out
_CHAIN_SLOT_OPS = ("quant_in", "conv", "conv_add", "concat", "add", "dwconv", "add_n")
# YOLOv8n's chain on the card against the CPU (float32 islands): int8
# rounding flips start at the chain's entry (one element of the float
# stem's output a last bit apart) and cascade through its 57 int8 convs
# further than through YOLO11n's (measured on an H100 80GB HBM3 at 700 W: the head's last
# slot differs on 42 % of its elements, by up to 5 steps, against 13 % and
# 2 on YOLO11n), so its raw outputs are held at twice what that run
# measured (conf 4.1e-4, boxes 0.060 px, 2.9 % of the coordinates over
# 0.01 px) and each of its int8 convs on its own by `_qconv_vs_cpu`
V8_CHAIN_BARS = {"box_px": 0.12, "cls_min": 0.99, "moved_max": 0.06, "conf_max": 1e-3}


def _chain_run(ce, frames, src_hw):
    """One eager chained forward: its raw outputs and the int8 payload of
    every scale slot in order."""
    from tensorrtx_tpu_torch.ops import qchain

    payloads = []
    real = {n: getattr(qchain.ChainCtx, n) for n in _CHAIN_SLOT_OPS}

    def wrap(fn):
        def run(self, *args, **kw):
            out = fn(self, *args, **kw)
            if self.mode == "run":
                payloads.append(out.q)
            return out
        return run

    for n, fn in real.items():
        setattr(qchain.ChainCtx, n, wrap(fn))
    try:
        raw = _eager(ce.raw_serve, frames, src_hw, ce.device)
    finally:
        for n, fn in real.items():
            setattr(qchain.ChainCtx, n, fn)
    return raw, payloads


def _cascade(got, ref):
    """The int8 payloads of two chained forwards slot by slot: the first
    slot that differs, the worst slot's share of differing elements and
    the largest difference in steps."""
    share = [float((g != r.to(g.device)).float().mean()) for g, r in zip(got, ref)]
    worst = int(np.argmax(share))
    return {"slots": len(share), "first_slot_with_flips": next(
                (i for i, x in enumerate(share) if x > 0), None),
            "worst_slot": worst, "worst_slot_flip_share": share[worst],
            "max_step_diff": max(int((g.int() - r.to(g.device).int()).abs().max())
                                 for g, r in zip(got, ref))}


def _qconv_vs_cpu(ce, frames, src_hw):
    """One chained forward on the card with every qconv launch recomputed
    by its plain version on the CPU from the same inputs (copied there):
    each int8 conv held on its own, card against CPU, with no cascade.
    int8 outputs within 1 step on under 0.1 % of the elements, float exits
    within `_check_float`. Returns the worst readings."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    worst = {"lsb": 0.0, "lsb_share": 0.0, "float_exit_abs_err": 0.0, "convs": 0}

    def cpu(v):
        return v.cpu() if torch.is_tensor(v) else v

    def hook(name, args, kw, got):
        ref = qk.qconv_plain(*(cpu(a) for a in args), **{k: cpu(v) for k, v in kw.items()})
        where = f"{name} x{tuple(args[0].shape)} w{tuple(args[1].shape)} on the CPU"
        if kw.get("out_float"):
            worst["float_exit_abs_err"] = max(worst["float_exit_abs_err"],
                                              _check_float(name, where, got.cpu(), ref))
        else:
            err, frac = _compare(got.cpu(), ref)
            _check_int8(name, where, err, frac)
            worst["lsb"], worst["lsb_share"] = max(worst["lsb"], err), max(worst["lsb_share"], frac)
        worst["convs"] += 1

    with _qconv_hook(hook):
        _eager(ce.raw_serve, frames, src_hw, ce.device)
    return worst


def phase_int8_parity(device, size=SIZE, bucket=BUCKET, model="yolo11", path="chain",
                      bars=None):
    """The int8 chain with float32 islands (TF32 off) on the card against the
    port's CPU path, with the scales calibrated once on the card and carried
    to both: raw outputs within the CPU slice test's tolerances
    (tests/test_torch_qchain.py: conf 1e-4, boxes 0.05 px, classes ≥ 99 %)
    or ``bars`` (`V8_CHAIN_BARS`, which also holds each int8 conv card
    against CPU by `_qconv_vs_cpu`), then detections IoU-matched at a
    rounding-safe threshold; the slots' int8 payloads card against CPU
    (`_cascade`) are logged."""
    cpu = torch.device("cpu")
    shapes = [(bucket[0] * 3 // 4, bucket[1]), (bucket[0], bucket[1] * 2 // 3)]
    frames, src_hw = frames_of(synthetic_frames(1, shapes), bucket)
    raw = {d: _chained("fp32", d, size, torch.float32, model, postprocess="raw")
           for d in (device, cpu)}
    scales = raw[device].calibrate([frames])
    raw[cpu].set_scales(scales)
    (raws, payloads) = zip(*(_chain_run(raw[d], frames, src_hw) for d in (device, cpu)))
    per_op = {"qconv_vs_cpu": _qconv_vs_cpu(raw[device], frames, src_hw)} if bars else {}

    def serve_at(thr):
        outs = []
        for d in (device, cpu):
            ce = _chained("fp32", d, size, torch.float32, model, conf_thresh=thr)
            ce.set_scales(scales)
            outs.append(_eager(ce.raw_serve, frames, src_hw, d))
        return outs

    bars = bars or {"box_px": 0.05, "cls_min": 0.99}
    log("int8_parity", path=path, size=size, frames=[list(s) for s in shapes],
        scales=len(scales), bars=bars, **_check_raw(path, list(raws), **bars),
        **_check_detections(path, list(raws), serve_at, cascade=bool(per_op)),
        cascade=_cascade(*payloads), **per_op)


def phase_int8_serving(device, ce, bucket=BUCKET, per_forward=None, path="chain"):
    """The chained int8 engine (bf16 islands) serving b1 requests and b32
    batches by the eager route (`raw_serve`) + `present_detections`:
    ``per_forward`` qconv launches (YOLO11n: 31 qconv3x3, 37 qconv1x1) and
    an NMS per forward."""
    return _timed_serving("int8_serving", device, ce.raw_serve, ce.cfg,
                          per_forward or {"qconv3x3": 31, "qconv1x1": 37}, bucket, path=path,
                          model=ce.name, islands=str(ce.dtype), scales=ce.n_scales)


def _chain_serve(ce, bucket=BUCKET):
    """serve(images) → per-image detections through the chained engine's
    ``__call__`` (its captured graphs on the card)."""
    from tensorrtx_tpu_torch.core.runner import present_detections

    def serve(images):
        frames, src_hw = frames_of(images, bucket)
        return present_detections(ce(frames, src_hw), src_hw, ce.cfg)
    return serve


# ---------------------------------------------------------------------------
# the float-resident int8 tier (QuantizedEngine) and the standalone kernels
# ---------------------------------------------------------------------------

# per YOLO11n forward: 87 conv slots, 7 of them depthwise (float); of the 80
# int8 convs 45 are 1×1, each quantizing its own float input as it stages it,
# and 35 are 3×3 (28 at stride 1, 7 at stride 2), each a quantize_int8 of its
# float input where it lies, then the int8-source 3×3
FQ_LAUNCHES = {"quantize_int8": 35, "qconv3x3": 35, "qconv1x1": 0, "qconv1x1_fq": 45}
# per YOLOv8n det forward: the tier's 63 conv slots, none depthwise: 24 1×1
# and 39 3×3 (32 at stride 1, 7 at stride 2); the chain's 35 int8 3×3 and
# 22 int8 1×1 (6 of them the head's float exits)
V8_FQ_LAUNCHES = {"quantize_int8": 39, "qconv3x3": 39, "qconv1x1": 0, "qconv1x1_fq": 24}
V8_CHAIN = {"qconv3x3": 35, "qconv1x1": 22}


def _calib_batch(device, size=SIZE, n=CAL_FRAMES):
    """n synthetic frames letterboxed to size² float32: one calibration
    batch (preprocessed, as `calibrate` takes them)."""
    from tensorrtx_tpu_torch.ops.preprocess import letterbox_batch

    frames, src_hw = frames_of(synthetic_frames(4, [(size, size)] * n), (size, size))
    return letterbox_batch(torch.from_numpy(frames).to(device),
                           torch.from_numpy(src_hw).to(device), size, size)


def _quantized(precision, device, size, scales, model="yolo11", **over):
    from tensorrtx_tpu_torch.core.quant import QuantizedEngine

    return QuantizedEngine(_engine(precision, device, size, model, **over), scales)


def _calibrated(precision, device, size, method, model="yolo11", **over):
    """A QuantizedEngine calibrated with `method` on one batch of
    CAL_FRAMES frames; returns (engine, scales, calibration seconds)."""
    from tensorrtx_tpu_torch.core.quant import QuantizedEngine, calibrate

    eng = _engine(precision, device, size, model, **over)
    batch = _calib_batch(device, size)
    t0 = time.perf_counter()
    scales = calibrate(eng, [batch], method)
    return QuantizedEngine(eng, scales), scales, time.perf_counter() - t0


def fq_main_path_calls(qe, size=SIZE):
    """The tier's qconv launches, in order, from one B = 1 forward: specs as
    `main_path_qconvs` gives them, the kwargs with the input scale ``sx``,
    and the input's dtype and pixel stride ("pixel"; above C where the
    input is a channel slice of a wider map, read where it lies)."""
    calls = []

    def hook(name, args, kw, out):
        x, wq, scale, bias, _ = args
        calls.append({"name": name, "hw": tuple(x.shape[1:3]), "c": x.shape[3], "wq": wq,
                      "scale": scale, "bias": bias, "kw": dict(kw), "residual": False,
                      "dtype": x.dtype, "pixel": x.stride(2)})
    with _qconv_hook(hook):
        qe(np.zeros((1, size, size, 3), np.float32))
    return calls


def _quant_input(shape, dtype, gen, device, exact):
    """A random activation of `shape` and its scale: a power of two when
    `exact` (x / s is then exact, and the bf16 grid puts many values on
    exact half-integer ties), else |x|max / 127."""
    x = (torch.randn(shape, generator=gen, device=device) * 3).to(dtype)
    s = x.float().abs().amax() / 127.0
    if exact:
        s = torch.exp2(torch.round(torch.log2(s)))
    return x, s


def phase_quantize(device, shapes, batches=(1, 32), path="tier"):
    """quantize_int8 in both forms against its plain version at every
    input shape of the tier (bit-equal), then, at each batch, the device
    time of one forward's worth of the tier's (division-form) launches, of
    their plain versions, and the bound of the same work. No single torch
    call computes it (none clamps to ±127), so there is no library time."""
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    gen = torch.Generator(device=device).manual_seed(11)
    out = {}
    for b in batches:
        args, ties = [], 0
        for i, (shape, dtype) in enumerate(shapes):
            x, s = _quant_input((b, *shape[1:]), dtype, gen, device, exact=i % 2 == 0)
            for divide in (False, True):
                got = qz.quantize_int8(x, s, divide=divide)
                ref = qz.quantize_int8_plain(x, s, divide=divide)
                if not torch.equal(got, ref):
                    raise AssertionError(
                        f"quantize_int8 (divide={divide}) disagrees with its plain version "
                        f"at {tuple(x.shape)} {dtype}: {int((got != ref).sum())} elements")
            v = x.float() / s
            ties += int((v - torch.floor(v) == 0.5).sum())
            args.append((x, s))
        n = sum(x.numel() for x, _ in args)
        bound_ms, bound_by = _bound(sum(x.numel() * (x.element_size() + 1) for x, _ in args),
                                    0, F32_FLOPS_PER_S)
        st = {"max_abs_err": 0.0, "launches_per_forward": len(args), "elements": n,
              "exact_ties": ties, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        if device.type == "cuda":
            st |= _timings(
                ms=(lambda: [qz.quantize_int8(x, s, divide=True) for x, s in args], 10),
                plain_ms=(lambda: [qz.quantize_int8_plain(x, s, divide=True) for x, s in args], 3))
        out[b] = st
        log("kernel_vs_plain", kernel="quantize_int8", path=path, batch=b, shapes=len(args),
            dtype=str(shapes[0][1]), forms="recip and divide, bit-equal", **st)
    return out


def _finite_bf16():
    """Every finite bfloat16 value once (65,280)."""
    b = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return b[torch.isfinite(b.float())]


def phase_fused_quantize(device, sxs):
    """The tier's quantize, held to the division form for every finite bf16
    value: an identity conv (scale 1, no bias, float32 exit) returns the
    int8 values the GEMM read. Five routes: a 1×1 at C = Co = 16 (quantized
    in the kernel, 16-byte pieces through the float slots) from a contiguous
    map and from a channel slice of a map 2C wide; a 3×3 with a center-tap
    identity at C = 16 (quantize_int8 of the map where it lies, then the
    int8 3×3) from the same two layouts; and a 3×3 at C = 3 (the stem's
    map). The input holds the 65,280 values once, zero-padded. At each scale
    of `sxs` (the tier's 80 int8 convs), 8 powers of two and 1e-33 (under
    2^-100: every value by the exact path, scaled): bit-equal to
    ``quantize_int8_plain(x, s, divide=True)``."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    x = torch.zeros(64 * 342 * 3, dtype=torch.bfloat16, device=device)
    x[:65280] = _finite_bf16().to(device)
    routes = []
    for k, shape, ps in ((1, (1, 64, 64, 16), 1), (1, (1, 64, 64, 16), 2),
                         (3, (1, 64, 64, 16), 1), (3, (1, 64, 64, 16), 2),
                         (3, (1, 64, 342, 3), 1)):
        c = shape[3]
        wq = torch.zeros((c, k, k, c), dtype=torch.int8)
        wq[torch.arange(c), k // 2, k // 2, torch.arange(c)] = 1
        xd = torch.zeros((*shape[:3], ps * c), dtype=x.dtype, device=device)[..., (ps - 1) * c:]
        xd.copy_(x[:int(np.prod(shape))].reshape(shape))
        routes.append((qk.qconv3x3 if k == 3 else qk.qconv1x1, xd, wq.to(device),
                       torch.ones(c, device=device), f"{k}x{k} C={c} pixel stride {ps * c}"))
    scales = [float(v) for v in sxs] + [2.0 ** e for e in (-12, -9, -7, -5, -3, -1, 0, 3)] + [1e-33]
    slow = []
    for i, sv in enumerate(scales):
        s = torch.tensor(sv, dtype=torch.float32, device=device)
        want = qz.quantize_int8_plain(x, s, divide=True).float()
        if i < len(sxs):    # the share of values the guard sends to the exact path (quant_math.cuh)
            v = torch.clamp(x[:65280].float() * (torch.ones_like(s) / s), -127, 127)
            slow.append(float(((v - torch.round(v)).abs() >= 0.5 - 2.0 ** -13).float().mean()))
        for fn, xd, wq, ones, what in routes:
            got = fn(xd, wq, ones, None, None, act=None, out_float=True, out_dtype=torch.float32,
                     sx=s).reshape(-1)
            if not torch.equal(got, want[:got.numel()]):
                n = int((got != want[:got.numel()]).sum())
                raise AssertionError(f"the tier's quantize ({what}) differs from the division "
                                     f"form at s = {sv!r}: {n} of {got.numel()} values")
    log("kernel_vs_plain", kernel="quantize_int8", route="the tier's: in the 1x1 kernel; "
        "quantize_int8 before the 3x3", check="identity convs, every finite bf16 value",
        values=65280, scales=len(scales), tier_scales=len(sxs), routes=[r[4] for r in routes],
        bit_equal=True, guard_share_tier_scales=[min(slow), float(np.mean(slow)), max(slow)])
    return len(scales)


def _fq_input(spec, batch, gen, device, dtype=None, pixel=None):
    """A float input of one tier launch at `batch`, laid out as the
    forward's was (the last C channels of a map `pixel` wide when that is
    above C, else contiguous), with |x / sx| up to about 200: some
    saturate."""
    h, w = spec["hw"]
    c, p = spec["c"], spec["pixel"] if pixel is None else pixel
    sx = spec["kw"]["sx"]
    wide = (torch.randn((batch, h, w, p), generator=gen, device=device) * (50 * sx)).to(
        dtype or spec["dtype"])
    return wide[..., p - c:]


def _nonzero_int8(rng, shape, device):
    """Random int8 weights with no zero: every flipped input moves a sum."""
    w = rng.integers(1, 128, shape) * rng.choice([-1, 1], shape)
    return torch.from_numpy(w.astype(np.int8)).to(device)


def _check_fused_exact(where, x, sx, wq, stride, rng):
    """A qconv from the float source x (the tier's route) with weights that
    have no zero, a float32 exit, scale 1 and no bias returns the int32 sums
    of the int8 values it read: bit-equal to the exact sums of conv(
    quantize_int8_plain(x, sx, divide=True), w)."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    wr = _nonzero_int8(rng, tuple(wq.shape), x.device)
    ones = torch.ones(wq.shape[0], dtype=torch.float32, device=x.device)
    kw = {"act": None, "out_float": True, "out_dtype": torch.float32}
    fn = qk.qconv1x1
    if wq.shape[1] == 3:
        fn, kw["stride"] = qk.qconv3x3, stride
    got = fn(x, wr, ones, None, None, sx=sx, **kw)
    ref = qk.qconv_plain(qz.quantize_int8_plain(x, sx, divide=True), wr, ones, None, None, **kw)
    if not torch.equal(got, ref):
        raise AssertionError(f"the tier's qconv GEMM is not exact at {where} ({x.dtype}, pixel "
                             f"stride {x.stride(2)}): {int((got != ref).sum())} of "
                             f"{ref.numel()} sums differ")


def _unfused(x, sx, args, kw):
    """One tier conv by the unfused route (the form before the tier read
    its input where it lies), on this build's kernels: the NHWC copy of a
    channel slice, quantize_int8 (division form), the int8-source conv."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    xq = qz.quantize_int8(x.contiguous(), sx, divide=True)
    return (qk.qconv3x3 if args[0].shape[1] == 3 else qk.qconv1x1)(xq, *args, **kw)


def phase_qconv_tier(device, specs, batches=(1, 32), path="tier"):
    """The tier's qconv3x3 / qconv1x1 calls from a bf16 source (the 1×1
    quantizing it in its kernel; for the 3×3 quantize_int8 of it where it
    lies, then the int8 3×3) at its 80 shapes, against their plain versions
    (quantize_int8_plain, then qconv_plain), from inputs laid out as the
    forward lays them out (channel slices read where they lie); their
    GEMM-exact output (`_check_fused_exact`) bit-equal from that source, a
    contiguous float32 one and a channel slice of a map 2C wide. Then, at
    each batch and per kernel, the device time of one forward's calls by
    this route ("ms"); of the unfused route on this build's kernels (the
    NHWC copy of a slice, quantize_int8, the int8-source conv:
    "unfused_ms", with its int8-source conv alone, "int8_source_ms"); of
    the plain versions; the bound of the work (the float input read once,
    int8 weights, bf16 output written once); `torch._int_mm` as in
    `phase_qconv`; and at B = 32 each kernel's time per shape in both
    routes."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    rng = np.random.default_rng(8)
    gen = torch.Generator(device=device).manual_seed(15)
    fns = {"qconv3x3": qk.qconv3x3, "qconv1x1": qk.qconv1x1}
    out = {}
    for b in batches:
        stats = {name: {"float_exit_max_abs_err": 0.0, "gemm_exact_bit_equal": 0} for name in fns}
        runs = {name: [] for name in fns}
        for spec in specs:
            x = _fq_input(spec, b, gen, device)
            kw = dict(spec["kw"])
            sx = kw.pop("sx")
            args = (spec["wq"], spec["scale"], spec["bias"], None)
            stride = kw.get("stride", 1)
            name = spec["name"]
            where = f"B={b} {name} {spec['hw']} C={spec['c']} Co={spec['wq'].shape[0]}"
            got = fns[name](x, *args, sx=sx, **kw)
            ref = qk.qconv_plain(qz.quantize_int8_plain(x, sx, divide=True), *args, **kw)
            st = stats[name]
            st["float_exit_max_abs_err"] = max(st["float_exit_max_abs_err"],
                                               _check_float(name, where, got, ref))
            for src in (x, _fq_input(spec, b, gen, device, torch.float32, spec["c"]),
                        _fq_input(spec, b, gen, device, pixel=2 * spec["c"])):
                _check_fused_exact(where, src, sx, spec["wq"], stride, rng)
                st["gemm_exact_bit_equal"] += 1
            runs[name].append((x, sx, args, kw, spec))
        for name, calls in runs.items():
            fn = fns[name]
            work = [_qconv_work(sp, b, in_bytes=2) for *_, sp in calls]
            bound_ms, bound_by = _bound(sum(w[0] for w in work), sum(w[1] for w in work),
                                        INT8_OPS_PER_S)
            st = stats[name] | {"launches_per_forward": len(calls), "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": None,
                                "sliced_inputs": sum(sp["pixel"] != sp["c"] for *_, sp in calls)}
            if device.type == "cuda":
                pre = [(qz.quantize_int8(x.contiguous(), sx, divide=True), a, k)
                       for x, sx, a, k, _ in calls]
                lib = {}
                if name == "qconv1x1":
                    mats = [(q.reshape(-1, q.shape[-1]), a[0].reshape(a[0].shape[0], -1).t())
                            for q, a, _ in pre]
                    lib = {"library_ms": (lambda: [torch._int_mm(m, w) for m, w in mats], 10)}
                else:
                    mats = [(_im2col(q, k.get("stride", 1)), a[0].reshape(a[0].shape[0], -1).t())
                            for q, a, k in pre if a[0].shape[3] % 8 == 0]
                    st["int_mm_im2col_launches"] = len(mats)
                    lib = {"int_mm_im2col_ms": (lambda: [torch._int_mm(m, w) for m, w in mats], 10)}
                st |= _timings(
                    ms=(lambda: [fn(x, *a, sx=sx, **k) for x, sx, a, k, _ in calls], 10),
                    unfused_ms=(lambda: [_unfused(x, sx, a, k) for x, sx, a, k, _ in calls], 10),
                    int8_source_ms=(lambda: [fn(q, *a, **k) for q, a, k in pre], 10),
                    plain_ms=(lambda: [qk.qconv_plain(qz.quantize_int8_plain(x, sx, divide=True),
                                                      *a, **k) for x, sx, a, k, _ in calls], 3),
                    **lib)
                del mats, pre
                if b == 32:
                    _tier_shapes(name, calls, b, path)
            stats[name] = st
            log("kernel_vs_plain", kernel=name, path=path,
                source="bf16, quantized in the 1x1 kernel; by quantize_int8 before the 3x3",
                batch=b, shapes=len(calls), **st)
        out[b] = stats
    return out


def _tier_shapes(name, calls, batch, path="tier"):
    """The tier's time per distinct launch shape of one kernel (all of its
    calls at that shape in one forward) by the tier's route, beside the
    unfused route's (copy, quantize_int8, int8-source conv), largest first."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    fn = qk.qconv3x3 if name == "qconv3x3" else qk.qconv1x1
    groups = {}
    for x, sx, a, k, sp in calls:
        shape = {"h": sp["hw"][0], "w": sp["hw"][1], "c": sp["c"], "co": sp["wq"].shape[0],
                 "stride": k.get("stride", 1), "pixel": sp["pixel"]}
        groups.setdefault(tuple(shape.items()), []).append((x, sx, a, k, sp))
    rows, sources = [], []
    for shape, grp in groups.items():
        t = _timings(ms=(lambda: [fn(x, *a, sx=sx, **k) for x, sx, a, k, _ in grp], 10),
                     unfused_ms=(lambda: [_unfused(x, sx, a, k) for x, sx, a, k, _ in grp], 10))
        sources.append(t["ms_source"])
        n_bytes = sum(_qconv_work(sp, batch, in_bytes=2)[0] for *_, sp in grp)
        rows.append(dict(shape) | {"launches": len(grp), "ms": t["ms"],
                                   "unfused_ms": t["unfused_ms"],
                                   "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3})
    rows.sort(key=lambda r: -r["ms"])
    log(f"{name}_shapes", path=path, batch=batch, route="tier vs unfused",
        ms_source=_source(*sources), shapes=rows)


def phase_stochastic(device, shape=(32, 160, 160, 64)):
    """quantize_int8_stochastic on a float32 tensor with two seeds:
    bit-equal to its plain version (the same Philox bits), within ±127,
    |q − v| < 1, reproducible for a seed and different across seeds."""
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    gen = torch.Generator(device=device).manual_seed(12)
    x = torch.randn(shape, generator=gen, device=device) * 3
    s = x.abs().amax() / 127.0
    outs = {}
    for seed in (1, 2 ** 40 + 7):
        got = qz.quantize_int8_stochastic(x, s, seed)
        ref = qz.quantize_int8_stochastic_plain(x, s, seed)
        if not torch.equal(got, ref):
            raise AssertionError(f"quantize_int8_stochastic disagrees with its plain version "
                                 f"(seed {seed}): {int((got != ref).sum())} elements")
        if not torch.equal(got, qz.quantize_int8_stochastic(x, s, seed)):
            raise AssertionError("quantize_int8_stochastic is not reproducible for a seed")
        v = torch.clamp(x / s, -127, 127)
        dev_ = float((got.float() - v).abs().max())
        if int(got.abs().max()) > 127 or dev_ >= 1:
            raise AssertionError(f"stochastic rounding out of contract: max |q - v| = {dev_}")
        outs[seed] = got
    a, b = outs.values()
    if torch.equal(a, b):
        raise AssertionError("two seeds gave the same stochastic rounding")
    bias = float((a.float() - torch.clamp(x / s, -127, 127)).mean())
    bound_ms, bound_by = _bound(x.numel() * 5, 0, F32_FLOPS_PER_S)
    st = {"max_abs_err": 0.0, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    if device.type == "cuda":
        st |= _timings(ms=(lambda: qz.quantize_int8_stochastic(x, s, 1), 10),
                       plain_ms=(lambda: qz.quantize_int8_stochastic_plain(x, s, 1), 3))
    log("kernel_vs_plain", kernel="quantize_int8_stochastic", shape=list(shape),
        dtype="float32", seeds=len(outs), bit_equal=True, mean_rounding_bias=bias,
        seeds_differ_on=float((a != b).float().mean()), **st)
    return st


# (k, H, C, W, Co, act, residual) of the planar convs held on the card
PLANAR_SHAPES = [
    (3, 640, 3, 640, 16, "silu", False),
    (3, 160, 16, 160, 8, "relu", False),
    (3, 160, 8, 160, 16, "silu", True),
    (1, 160, 32, 160, 32, "silu", False),
    (1, 160, 48, 160, 64, None, True),
]


def _planar_args(spec, b, dtype, gen, device):
    k, h, c, w, co, act, res = spec
    x = torch.randn((b, h, c, w), generator=gen, device=device).to(dtype)
    wt = torch.randn((k, k, c, co), generator=gen, device=device) / (k * k * c) ** 0.5
    bias = torch.randn((co,), generator=gen, device=device) * 0.1
    r = torch.randn((b, h, co, w), generator=gen, device=device).to(dtype) if res else None
    return x, wt, bias, r, act


def _planar_work(spec, b, itemsize):
    k, h, c, w, co, _, res = spec
    n_bytes = (b * h * w * c * itemsize + 4 * (k * k * c * co + co)
               + b * h * w * co * itemsize * (1 + res))
    return n_bytes, 2 * b * h * w * co * k * k * c


def phase_planar(device, batches=(1, 32), dtypes=(torch.float32, torch.bfloat16)):
    """conv3x3_planar / conv1x1_planar against their plain versions (a
    float32 cuDNN convolution; TF32 is off) at PLANAR_SHAPES, B = 1 and 32,
    float32 and bf16. Tolerance: |kernel − plain| ≤ 1e-4·(1 + max|plain|)
    in float32 (the two sum up to 432 products in different orders), one
    bf16 rounding step 2⁻⁷·(1 + max|plain|) in bf16. Then, per kernel,
    batch and dtype, the device time (`core/profiler.queued_ms`) of its shapes' launches
    together and of each shape alone, of their plain versions, of
    `F.conv2d` (conv + bias only, on a contiguous NCHW copy of the same
    values; a yardstick the port never calls), and the bound (bytes over
    3.35 TB/s or float32 flops over 67 TFLOP/s), with the card's clocks
    just before and just after those timed windows."""
    import torch.nn.functional as F

    from tensorrtx_tpu_torch.core.profiler import queued_ms
    from tensorrtx_tpu_torch.ops.cuda import conv_planar as cp

    fns = {3: cp.conv3x3_planar, 1: cp.conv1x1_planar}
    gen = torch.Generator(device=device).manual_seed(13)
    out = {}
    for dtype in dtypes:
        for b in batches:
            runs = {3: [], 1: []}
            for spec in PLANAR_SHAPES:
                k = spec[0]
                x, wt, bias, r, act = _planar_args(spec, b, dtype, gen, device)
                got = fns[k](x, wt, bias, residual=r, act=act)
                ref = cp.conv_planar_plain(x, wt, bias, r, act, k)
                scale = 1.0 + float(ref.float().abs().max())
                tol = (1e-4 if dtype == torch.float32 else 2 ** -7) * scale
                err = float((got.float() - ref.float()).abs().max())
                if not (got.shape == ref.shape and got.dtype == dtype) or err > tol:
                    raise AssertionError(f"conv{k}x{k}_planar disagrees with its plain version "
                                         f"at B={b} {spec} {dtype}: {err} > {tol}")
                runs[k].append((x, wt, bias, r, act, spec, err))
            for k, calls in runs.items():
                name = f"conv{k}x{k}_planar"
                n_bytes = sum(_planar_work(c[5], b, dtype.itemsize)[0] for c in calls)
                n_ops = sum(_planar_work(c[5], b, dtype.itemsize)[1] for c in calls)
                bound_ms, bound_by = _bound(n_bytes, n_ops, F32_FLOPS_PER_S)
                st = {"max_abs_err": max(c[6] for c in calls), "shapes": len(calls),
                      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
                if device.type == "cuda":
                    lib = [(x.permute(0, 2, 1, 3).contiguous(),
                            w.permute(3, 2, 0, 1).to(dtype).contiguous(), bb.to(dtype))
                           for x, w, bb, _, _, _, _ in calls]
                    st["clocks_before"] = gpu_clocks()
                    st["ms"] = queued_ms(lambda: [fns[k](x, w, bb, residual=r, act=a)
                                                   for x, w, bb, r, a, _, _ in calls])
                    st["plain_ms"] = queued_ms(lambda: [cp.conv_planar_plain(x, w, bb, r, a, k)
                                                         for x, w, bb, r, a, _, _ in calls], 3)
                    st["library_ms"] = queued_ms(lambda: [F.conv2d(x, w, bb, padding=k // 2)
                                                           for x, w, bb in lib])
                    st["per_shape_ms"] = [
                        queued_ms(lambda c=c: fns[k](c[0], c[1], c[2], residual=c[3], act=c[4]))
                        for c in calls]
                    st["clocks_after"] = gpu_clocks()
                    st["ms_source"] = "queued_events"
                out[(name, b, dtype)] = st
                log("kernel_vs_plain", kernel=name, batch=b, dtype=str(dtype),
                    hcw_co=[list(c[5][1:5]) for c in calls], **st)
    return out


def phase_standalone_ops(device):
    """The standalone ops driven as a user would call them, with the launch
    counts set to 0 just before and read just after: NHWC activations →
    to_planar → conv3x3_planar → conv3x3_planar with a residual →
    conv1x1_planar → from_planar → quantize_int8 and
    quantize_int8_stochastic of the result; the same chain in the plain
    versions agrees. No serving path calls the planar convs or the
    stochastic quantize (nor does any path of the JAX package), so this run
    is where their counts come from."""
    from tensorrtx_tpu_torch.ops.cuda import conv_planar as cp
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    gen = torch.Generator(device=device).manual_seed(14)
    x = torch.randn((2, 160, 160, 16), generator=gen, device=device)
    w1 = torch.randn((3, 3, 16, 8), generator=gen, device=device) / 12
    w2 = torch.randn((3, 3, 8, 16), generator=gen, device=device) / 8.5
    w3 = torch.randn((1, 1, 16, 32), generator=gen, device=device) / 4
    b1, b2, b3 = (torch.randn((c,), generator=gen, device=device) * 0.1 for c in (8, 16, 32))

    def chain(c3, c1, q, qs):
        xp = cp.to_planar(x)
        y = c3(c3(xp, w1, b1), w2, b2, residual=xp)
        y = cp.from_planar(c1(y, w3, b3, act="relu"))
        s = y.abs().amax() / 127.0
        return y, q(y, s), qs(y, s, 5)

    _reset_launches()
    y, q, qs = chain(cp.conv3x3_planar, cp.conv1x1_planar, qz.quantize_int8,
                     qz.quantize_int8_stochastic)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = _launches()
    plain = chain(lambda *a, **kw: cp.conv_planar_plain(*a, k=3, **kw),
                  lambda *a, **kw: cp.conv_planar_plain(*a, k=1, **kw),
                  qz.quantize_int8_plain, qz.quantize_int8_stochastic_plain)
    err = float((y - plain[0]).abs().max())
    if err > 1e-4 * (1 + float(plain[0].abs().max())) or not torch.isfinite(y).all():
        raise AssertionError(f"standalone planar chain differs from its plain version: {err}")
    q_lsb = int((q.int() - plain[1].int()).abs().max())
    qs_lsb = int((qs.int() - plain[2].int()).abs().max())
    if q_lsb > 1 or qs_lsb > 1:
        raise AssertionError(f"standalone quantize differs: {q_lsb} / {qs_lsb} LSB")
    want = {"conv3x3_planar": 2, "conv1x1_planar": 1, "quantize_int8": 1,
            "quantize_int8_stochastic": 1}
    if device.type == "cuda" and any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"the standalone ops launched {launches}, not {want}")
    log("standalone_ops", shape=list(x.shape), launches=launches, max_abs_err=err,
        quantize_lsb=q_lsb, stochastic_lsb=qs_lsb)
    return launches


def _fq_plain(args, kw):
    """The plain version of a tier launch: the division-form quantize of its
    float input, then qconv_plain."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    kw = dict(kw)
    sx = kw.pop("sx")
    return qk.qconv_plain(qz.quantize_int8_plain(args[0], sx, divide=True), *args[1:], **kw)


def phase_fq_shadow(qe, frames, src_hw, launches=None, path="tier"):
    """One forward of the tier through ServingPipeline with every qconv
    call (each from its float input) recomputed by its plain version on the
    same inputs: float exits within `_check_float`; ``launches``: the
    kernels' launches per forward (FQ_LAUNCHES, YOLO11n's). Returns each
    kernel's worst error."""
    from tensorrtx_tpu_torch.core.runner import ServingPipeline

    worst = {"qconv3x3": 0.0, "qconv1x1": 0.0}
    n = {"qconv3x3": 0, "qconv1x1": 0}
    sliced = [0]

    def hook(name, args, kw, got):
        where = f"{name} x{tuple(args[0].shape)} pixel stride {args[0].stride(2)}"
        n[name] += 1
        sliced[0] += args[0].stride(2) != args[0].shape[3]
        if kw.get("sx") is None:
            raise AssertionError(f"{where}: the tier launched a qconv from an int8 source")
        worst[name] = max(worst[name], _check_float(name, where, got, _fq_plain(args, kw)))

    pipe = ServingPipeline(qe, *BUCKET)
    _reset_launches()
    with _qconv_hook(hook):
        out = _eager(pipe.fused, frames, src_hw, qe.device)
    if qe.device.type == "cuda":
        torch.cuda.synchronize()
    want = launches or FQ_LAUNCHES
    launches = _launches()
    calls = {"qconv3x3": want["qconv3x3"], "qconv1x1": want["qconv1x1_fq"]}
    if n != calls or (qe.device.type == "cuda" and (
            any(launches[k] != v for k, v in want.items()) or launches["nms_mask"] < 1)):
        raise AssertionError(f"the {path} forward made {n} calls and {launches} launches, "
                             f"not {calls} and {want} and an NMS")
    if not all(torch.isfinite(v.float()).all() for v in out.values()):
        raise AssertionError("tier shadow forward: non-finite detections")
    log("fq_shadow", path=path, batch=frames.shape[0], dtype=str(qe.dtype), calls=n,
        launches=launches,
        sliced_inputs=sliced[0], worst_float_exit_abs_err=worst)
    return worst


# the tier's raw-output bars on the card against the CPU (box px, class
# agreement, share of box coordinates off by more than 0.01 px), and the
# bar on the share of a conv's int8 input that differs; see phase_fq_parity
FQ_BARS = (0.1, 0.99, 0.03)
FQ_FLIP_MAX = 0.3
# YOLOv8n's tier: FQ_BARS and FQ_FLIP_MAX hold but for conf, which a single
# flip moves further on v8 (measured on an H100 80GB HBM3 at 700 W: conf 3.2e-4, boxes
# 0.046 px, 0.45 % of the coordinates over 0.01 px, classes all equal,
# worst slot 6.6 % of its int8 input flipped against YOLO11n's 13.5 %):
# conf at twice that reading
V8_FQ_BARS = {"box_px": FQ_BARS[0], "cls_min": FQ_BARS[1], "moved_max": FQ_BARS[2],
              "conf_max": 7e-4, "flip_max": FQ_FLIP_MAX}


def _int8_inputs(qe, frames, src_hw, bucket=BUCKET, skip=None):
    """One tier forward through ServingPipeline: its raw outputs and
    {slot index: that conv's int8 input}, the division-form quantize of the
    float input at the sx the conv was given (what the conv staged:
    `fused_quantize` and `fq_shadow` hold the kernels to it); the slot
    `skip`, run in float, has none."""
    from tensorrtx_tpu_torch.core.runner import ServingPipeline
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    outs = []

    def hook(name, args, kw, out):
        outs.append(qz.quantize_int8_plain(args[0], kw["sx"], divide=True))
    with _qconv_hook(hook):
        raw = _eager(ServingPipeline(qe, *bucket).fused, frames, src_hw, qe.device)
    order = [sl.index for sl in qe.slots() if not sl.depthwise and sl.index != skip]
    if len(outs) != len(order):
        raise AssertionError(f"{len(outs)} qconv calls for {len(order)} int8 convs")
    return raw, dict(zip(order, outs))


def _flips(got, ref):
    """The worst slot's share of int8 input elements that differ from ref,
    that slot, and the first slot with any difference."""
    share = {i: float((got[i] != ref[i]).float().mean()) for i in got}
    worst = max(share, key=share.get)
    return {"int8_input_flip_share": share[worst], "worst_slot": worst,
            "first_slot_with_flips": min((i for i, s in share.items() if s > 0), default=None)}


def _fault_controls(qe, frames, src_hw, ref, ref_q, bucket=BUCKET):
    """The tier's bars against deliberately faulty paths on the card: each
    int8 conv in turn with its activation scale doubled ("scale_x2"), or
    with its quantize skipped so that it runs in float ("float_conv"),
    restored after its forward. Each faulty forward is held against the
    CPU's raw outputs (ref) as `_check_raw` holds the tier's, and its int8
    conv inputs against the CPU's (ref_q) as `_flips` does. Per kind: how
    many faults each bar catches, and the range of each reading over the
    faults. The flip bar must catch every doubled scale. (A skipped
    quantize of a head branch's last conv leaves no later int8 input to
    differ; the launch counts of `fq_shadow` and `fq_serving` catch it.)"""
    slots = [sl for sl in qe.slots() if not sl.depthwise]
    out = {}
    for kind in ("scale_x2", "float_conv"):
        rows = []
        for sl in slots:
            run = (sl.wq, sl.scale, sl.sx, sl.bias)
            sl.set_run(*((sl.wq, sl.scale * 2, sl.sx * 2, sl.bias) if kind == "scale_x2"
                         else (None,) * 4))
            try:
                raw, q = _int8_inputs(qe, frames, src_hw, bucket,
                                      skip=sl.index if kind == "float_conv" else None)
            finally:
                sl.set_run(*run)
            rows.append(_check_raw("control", [raw, ref], *FQ_BARS, control=True)
                        | _flips(q, ref_q))
        out[kind] = {"faults": len(rows),
                     "caught_by_raw_bars": sum(not r["within_bars"] for r in rows),
                     "caught_by_flip_bar": sum(r["int8_input_flip_share"] > FQ_FLIP_MAX
                                               for r in rows),
                     **{k: [min(r[k] for r in rows), max(r[k] for r in rows)]
                        for k in ("conf_max_abs_err", "box_max_abs_err_px",
                                  "box_coords_over_0_01_px", "int8_input_flip_share")}}
    if out["scale_x2"]["caught_by_flip_bar"] != len(slots):
        raise AssertionError(f"the flip bar misses a doubled scale: {out['scale_x2']}")
    return out


def _fq_vs_cpu(qe, frames, src_hw, bucket=BUCKET):
    """One tier forward on the card with every qconv call recomputed by its
    plain version (the division-form quantize, then qconv_plain) on the CPU
    from the same float input, copied there: each int8 conv held on its
    own, card against CPU, float exits within `_check_float`. Returns the
    worst error and the number of convs."""
    from tensorrtx_tpu_torch.core.runner import ServingPipeline

    worst = {"float_exit_abs_err": 0.0, "convs": 0}

    def cpu(v):
        return v.cpu() if torch.is_tensor(v) else v

    def hook(name, args, kw, got):
        ref = _fq_plain([cpu(a) for a in args], {k: cpu(v) for k, v in kw.items()})
        where = f"{name} x{tuple(args[0].shape)} on the CPU"
        worst["float_exit_abs_err"] = max(worst["float_exit_abs_err"],
                                          _check_float(name, where, got.cpu(), ref))
        worst["convs"] += 1

    with _qconv_hook(hook):
        _eager(ServingPipeline(qe, *bucket).fused, frames, src_hw, qe.device)
    return worst


def phase_fq_parity(device, size=SIZE, bucket=BUCKET, model="yolo11", path="tier",
                    controls=True, bars=None):
    """The tier with a float32 engine on the card against the port's CPU
    path at the same scales (percentile-calibrated on the card, carried to
    both): raw outputs, then detections (`_check_detections`). Bars
    (FQ_BARS): conf 1e-4 and classes ≥ 99 % (the CPU tests'); boxes 0.1 px
    at most, and under 3 % of the coordinates off by more than 0.01 px. The
    CPU tests' 0.05 px does not hold at 640²: the float layers (attention,
    depthwise convs, SiLU) round differently on the card, a conv input that
    lands on the other side of a quantization step moves by one step of its
    scale, and such flips cascade through the 80 int8 convs (three runs
    measured 0.051 px, 1.35 % of the coordinates over 0.01 px; the float
    path on the card is within 6e-5 px of the CPU): the bars are twice
    that.

    The raw outputs of this random-weight network hardly depend on its
    features, so they cannot see a single faulty conv
    (`_fault_controls`). Each conv is held by its int8 input: the share of
    its elements that differ from the CPU's stays under FQ_FLIP_MAX, about
    twice the worst reading (13.5 % at the head's slot 80, with the first
    flips at slot 5: rounding flips cascade through the convs); a doubled
    scale changes most of its conv's elements. The fault controls, one
    forward per int8 conv and fault, run with ``controls`` (on YOLO11n).
    ``bars`` (YOLOv8n's `V8_FQ_BARS`) replaces FQ_BARS and FQ_FLIP_MAX for
    a model whose flips cascade further, and adds `_fq_vs_cpu`, each conv
    card against CPU on its own."""
    from tensorrtx_tpu_torch.core.runner import ServingPipeline

    cpu = torch.device("cpu")
    shapes = [(bucket[0] * 3 // 4, bucket[1]), (bucket[0], bucket[1] * 2 // 3)]
    frames, src_hw = frames_of(synthetic_frames(1, shapes), bucket)
    qe, scales, _ = _calibrated("fp32", device, size, "percentile", model, postprocess="raw")
    got, got_q = _int8_inputs(qe, frames, src_hw, bucket)
    ref, ref_q = _int8_inputs(_quantized("fp32", cpu, size, scales, model, postprocess="raw"),
                              frames, src_hw, bucket)
    ref_q = {i: v.to(device) for i, v in ref_q.items()}
    raw_bars = dict(zip(("box_px", "cls_min", "moved_max"), FQ_BARS))
    flip_max = FQ_FLIP_MAX
    if bars:
        raw_bars = {k: v for k, v in bars.items() if k != "flip_max"}
        flip_max = bars["flip_max"]
    raw = _check_raw(path, [got, ref], **raw_bars)
    flips = _flips(got_q, ref_q)
    if flips["int8_input_flip_share"] > flip_max:
        raise AssertionError(f"{path} int8 conv inputs differ from the CPU's: {flips}")
    per_op = {"qconv_vs_cpu": _fq_vs_cpu(qe, frames, src_hw, bucket)} if bars else {}
    dets = _check_detections(path, [got, ref], lambda thr: [
        _eager(ServingPipeline(_quantized("fp32", d, size, scales, model, conf_thresh=thr),
                               *bucket).fused, frames, src_hw, d) for d in (device, cpu)],
        cascade=bool(bars))
    controls = ({"fault_controls": _fault_controls(qe, frames, src_hw, ref, ref_q, bucket)}
                if controls else {})
    log("fq_parity", path=path, size=size, frames=[list(s) for s in shapes], scales=len(scales),
        bars=bars or {**raw_bars, "flip_max": flip_max}, **raw, **flips, **per_op, **dets,
        **controls)


def _unfused_conv2d(x, wq, scale, sx, bias, stride):
    """`ops/quant_ctx.quant_conv2d` by the unfused route (`_unfused`)."""
    kw = dict(act=None, out_float=True, out_dtype=x.dtype)
    if wq.shape[1] == 3:
        kw["stride"] = stride
    return _unfused(x.permute(0, 2, 3, 1), sx, (wq, scale, bias, None), kw).permute(0, 3, 1, 2)


def _copy_census(fn):
    """One call of fn under the profiler with Python stacks: the copy
    kernels (``direct_copy``) and quantize kernels it launched, and the
    ``aten::copy_`` calls made from `ops/quant_ctx.py`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], with_stack=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"copy_kernels": sum("direct_copy" in k for k in kernels),
            "quantize_kernels": sum("quantize_kernel" in k for k in kernels),
            "quant_ctx_copies": sum(e.name == "aten::copy_"
                                    and any("quant_ctx.py" in f for f in (e.stack or []))
                                    for e in events)}


def phase_fq_serving(device, pipe, bucket=BUCKET, launches=None, path="tier"):
    """The tier (a `ServingPipeline` over a bf16 `QuantizedEngine`) serving
    b1 requests and b32 batches by the eager route (`fused`): ``launches``
    (YOLO11n's FQ_LAUNCHES) and an NMS per forward; then one b1 request under the profiler with
    Python stacks, on this path and with `quant_conv2d` swapped for the
    unfused route (`_unfused_conv2d`): this path makes no copy in
    `ops/quant_ctx.py` and launches a quantize kernel for the 3×3 inputs
    only, and the census shows the copies and launches the tier's route
    took away."""
    from tensorrtx_tpu_torch.ops import quant_ctx

    qe = pipe.engine
    want = launches or FQ_LAUNCHES
    launches, timing = _timed_serving("fq_serving", device, pipe.fused, qe.cfg, want, bucket,
                                      path=path, model=qe.name, precision="bf16",
                                      scales=len(qe.act_scales))
    if device.type == "cuda":
        one, _ = _serving_images(bucket)
        serve = _eager_serve(pipe.fused, device, qe.cfg, bucket)
        fused = _copy_census(lambda: serve(one))
        real = quant_ctx.quant_conv2d
        quant_ctx.quant_conv2d = _unfused_conv2d
        try:
            unfused = _copy_census(lambda: serve(one))
        finally:
            quant_ctx.quant_conv2d = real
        log("fq_serving_copies", path=path, batch=1, fused=fused, unfused=unfused)
        if fused["quant_ctx_copies"] or fused["quantize_kernels"] != want["quantize_int8"]:
            raise AssertionError(f"the tier's forward copied, or quantized other than the 3x3 "
                                 f"inputs, outside its convs: {fused}")
    return launches, timing


# the seven kernels' names in the card's profile, by the wrappers' launch
# counter names (`_launches`), and the launches of each in one forward of
# each captured path
KERNEL_NAMES = {"nms_mask": "nms_mask_kernel", "qconv3x3": "qconv3x3_mma_kernel",
                "qconv1x1": "qconv1x1_mma_kernel", "quantize_int8": "quantize_kernel",
                "quantize_int8_stochastic": "quantize_sr_kernel",
                "conv3x3_planar": "conv3x3_planar_kernel",
                "conv1x1_planar": "conv1x1_planar_kernel"}
PER_REPLAY = {"float": {"nms_mask": 1},
              "chain": {"nms_mask": 1, "qconv3x3": 31, "qconv1x1": 37},
              "tier": {"nms_mask": 1, "qconv3x3": 35, "qconv1x1": 45, "quantize_int8": 35},
              "v8_chain": {"nms_mask": 1, **V8_CHAIN},
              "v8_tier": {"nms_mask": 1, "qconv3x3": 39, "qconv1x1": 24, "quantize_int8": 39},
              **{path: {"nms_mask": n} if n else {} for path, n in TASK_NMS.items()}}
CENSUS_REPLAYS = 5


def _census_paths(device, scales):
    """Every serving path at full size (bf16, conf 0.25), each as the call
    a user makes: name → a function that builds it and returns its
    ``__call__`` (the three det paths of YOLO11n and of YOLOv8n, and every
    path of PATHS). ``scales``: the int8 paths' scale tables by name."""
    from tensorrtx_tpu_torch.core.runner import ServingPipeline

    def chain(model, name):
        ce = _chained("bf16", device, SIZE, model=model, conf_thresh=0.25)
        ce.set_scales(scales[name])
        return ce

    return {
        "float": lambda: ServingPipeline(_engine("bf16", device, SIZE, conf_thresh=0.25), *BUCKET),
        "chain": lambda: chain("yolo11", "chain"),
        "tier": lambda: ServingPipeline(_quantized("bf16", device, SIZE, scales["tier"],
                                                   conf_thresh=0.25), *BUCKET),
        "v8_chain": lambda: chain("yolov8", "v8_chain"),
        "v8_tier": lambda: ServingPipeline(_quantized("bf16", device, SIZE, scales["v8_tier"],
                                                      "yolov8", conf_thresh=0.25), *BUCKET),
        **{p: (lambda p=p: ServingPipeline(_task_engine(p, "bf16", device, conf_thresh=0.25),
                                            *BUCKET)) for p in PATHS}}


def census_main(scales_dir):
    """The replay census, in a process of its own (``--replay-census DIR``):
    early in a process `torch.profiler` records every kernel. Each path
    captures its b1 graph, sets the launch counts to 0 and serves
    CENSUS_REPLAYS b1 requests under the profiler; a window counts only if
    it recorded device work and shows exactly PER_REPLAY launches of each
    of the seven kernels per replay (0 for a kernel the path does not run:
    no nms_mask on obb, cls and the NMS-free heads), up to three windows a
    path (`core/profiler.kernel_table`), and the wrappers' launch counters
    must stay at 0 (no launch from Python: every kernel came from a
    replay). Prints one JSON line with each path's launches per replay."""
    import os

    from tensorrtx_tpu_torch.core.profiler import kernel_table, launches

    device = torch.device("cuda", 0)
    scales = {f[:-4]: np.load(os.path.join(scales_dir, f)) for f in os.listdir(scales_dir)}
    frames, src_hw = frames_of(_serving_images()[0])
    out = {}
    for name, build in _census_paths(device, scales).items():
        call = build()
        call(frames, src_hw)                 # capture
        torch.cuda.synchronize()
        want = {part: PER_REPLAY[name].get(k, 0) * CENSUS_REPLAYS for k, part in KERNEL_NAMES.items()}
        _reset_launches()
        rows = kernel_table(lambda: call(frames, src_hw), CENSUS_REPLAYS, want)
        counted = {k: v for k, v in _launches().items() if v}
        if rows is None or counted:
            raise AssertionError(f"replay census ({name}): no window of {CENSUS_REPLAYS} replays "
                                 f"showed {want}, or Python launched {counted}")
        out[name] = {"replays": CENSUS_REPLAYS, "python_launches": 0,
                     "device_launches_per_replay": sum(n for _, _, n in rows) / CENSUS_REPLAYS,
                     "launches_per_replay": {k: launches(rows, part) // CENSUS_REPLAYS
                                             for k, part in KERNEL_NAMES.items()},
                     "kernel_ms_per_replay": {k: sum(ms for key, ms, _ in rows if part in key)
                                              / CENSUS_REPLAYS
                                              for k, part in KERNEL_NAMES.items()
                                              if PER_REPLAY[name].get(k)}}
        del call
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "graph_replay_census", **out}), flush=True)
    return 0


def phase_replay_census(scales):
    """Runs `census_main` in a child process (the int8 paths' scales,
    ``{name: table}``, handed over in a temporary directory) and returns, by
    path and by the counters' names, each kernel's launches per replay."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        for name, table in scales.items():
            np.save(f"{d}/{name}.npy", table)
        res = subprocess.run([sys.executable, __file__, "--replay-census", d],
                             capture_output=True, text=True, timeout=900)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith('{"phase": "graph_replay_census"')]
    if res.returncode != 0 or not lines:
        raise AssertionError(f"the replay census failed (rc {res.returncode}):\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    print(lines[-1], flush=True)
    census = json.loads(lines[-1])
    return {p: census[p]["launches_per_replay"] for p in PER_REPLAY}


def phase_v8_det(device, cal):
    """YOLOv8n det at 640², bf16, on its three serving paths, as YOLO11n's
    are driven: the chained int8 engine (absmax on the CAL_FRAMES frames
    ``cal``: its qconv launches against their plain versions at the v8
    chain's own shapes, a shadow forward, float32 card-vs-CPU parity, the
    eager route, the graphs, `stream_fn(16)`); the float path (parity, the
    eager route, the graphs, `stream_fn(16)`: `phase_task_parity` and
    `phase_task_serving` of "v8_det"); the float-resident tier (entropy on
    the same frames: quantize_int8 and the qconvs against their plain
    versions at the tier's own inputs and shapes, a shadow forward,
    float32 parity, the eager route, the graphs). Returns what the kernels
    line reads."""
    from tensorrtx_tpu_torch.core.runner import ServingPipeline

    # the two frames (480×640, 640×426 at 640²) of the shadow forwards
    two = frames_of(synthetic_frames(5, [(BUCKET[0] * 3 // 4, BUCKET[1]),
                                         (BUCKET[0], BUCKET[1] * 2 // 3)]))
    ce = _chained("bf16", device, SIZE, model="yolov8", conf_thresh=0.25)
    ce.calibrate([cal])
    out = {"chain_scales": ce.act_scales}
    out["qc"] = phase_qconv(device, main_path_qconvs(ce), path="v8_chain", extras=False)
    out["shadow"] = phase_int8_shadow(ce, *two, expect=(V8_CHAIN["qconv3x3"], V8_CHAIN["qconv1x1"]),
                                      path="v8_chain")
    phase_int8_parity(device, model="yolov8", path="v8_chain", bars=V8_CHAIN_BARS)
    out["chain"], timing = phase_int8_serving(device, ce, per_forward=V8_CHAIN, path="v8_chain")
    phase_graph_serving("v8_chain", device, ce, ce.raw_serve, ce.graphs, _chain_serve(ce), timing)
    phase_stream("v8_chain", device, ce, ce.raw_serve, timing)
    del ce
    torch.cuda.empty_cache()

    phase_task_parity("v8_det", device)
    out["float"] = phase_task_serving("v8_det", device)
    torch.cuda.empty_cache()

    qe, scales, cal_s = _calibrated("bf16", device, SIZE, "entropy", "yolov8", conf_thresh=0.25)
    log("fq_calibrate", path="v8_tier", method="entropy", frames=CAL_FRAMES, scales=len(scales),
        seconds=cal_s, scale_range=[float(scales.min()), float(scales.max())])
    out["tier_scales"] = scales
    calls = fq_main_path_calls(qe)
    out["qz"] = phase_quantize(device, [((1, *sp["hw"], sp["c"]), sp["dtype"]) for sp in calls],
                               path="v8_tier")
    out["qc_fq"] = phase_qconv_tier(device, calls, path="v8_tier")
    out["fq_shadow"] = phase_fq_shadow(qe, *two, launches=V8_FQ_LAUNCHES, path="v8_tier")
    phase_fq_parity(device, model="yolov8", path="v8_tier", controls=False, bars=V8_FQ_BARS)
    tier = ServingPipeline(qe, *BUCKET)
    out["tier"], timing = phase_fq_serving(device, tier, launches=V8_FQ_LAUNCHES, path="v8_tier")
    phase_graph_serving("v8_tier", device, tier, tier.fused, tier.graphs, tier.detect_images, timing)
    del tier, qe
    torch.cuda.empty_cache()
    return out


def _v8_int8_stats(name, v8):
    """The kernels line's "v8_chain" and "v8_tier" entries of qconv3x3 or
    qconv1x1: YOLOv8n's launches per forward and eager run, errors and times
    at its chain's and its tier's own shapes."""
    c1, c32 = v8["qc"][1][name], v8["qc"][32][name]
    t1, t32 = v8["qc_fq"][1][name], v8["qc_fq"][32][name]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "v8_chain": {"launches": v8["chain"][name], "launches_per_forward": c1["launches_per_forward"],
                     "max_abs_err": max(c1["max_abs_err"], c32["max_abs_err"], v8["shadow"][name]),
                     "float_exit_max_abs_err": max(c1["float_exit_max_abs_err"],
                                                   c32["float_exit_max_abs_err"]),
                     "gemm_exact_bit_equal": c1["gemm_exact_bit_equal"] + c32["gemm_exact_bit_equal"],
                     **{k: c1[k] for k in keys}, **{k + "_b32": c32[k] for k in keys},
                     "ms_source": _source(c1["ms_source"], c32["ms_source"])},
        "v8_tier": {"launches": v8["tier"]["qconv3x3" if name == "qconv3x3" else "qconv1x1_fq"],
                    "launches_per_forward": t1["launches_per_forward"],
                    "float_exit_max_abs_err": max(t1["float_exit_max_abs_err"],
                                                  t32["float_exit_max_abs_err"],
                                                  v8["fq_shadow"][name]),
                    "gemm_exact_bit_equal": t1["gemm_exact_bit_equal"] + t32["gemm_exact_bit_equal"],
                    **{k: t1[k] for k in keys + ("unfused_ms",)},
                    **{k + "_b32": t32[k] for k in keys + ("unfused_ms",)},
                    "ms_source": _source(t1["ms_source"], t32["ms_source"])},
    }


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from tensorrtx_tpu_torch.core.runner import ServingPipeline

    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False       # f32 parity: no TF32 convs
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    smi = phase_env()
    nms = phase_kernel(device)
    ce = _chained("bf16", device, SIZE, conf_thresh=0.25)
    cal, _ = frames_of(synthetic_frames(4, [(SIZE, SIZE)] * CAL_FRAMES), (SIZE, SIZE))
    ce.calibrate([cal])
    qc = phase_qconv(device, main_path_qconvs(ce))
    shadow = phase_int8_shadow(ce, *frames_of(synthetic_frames(5, [(480, 640), (640, 426)])))
    phase_int8_parity(device)
    int8_launches, int8_timing = phase_int8_serving(device, ce)
    phase_graph_serving("chain", device, ce, ce.raw_serve, ce.graphs, _chain_serve(ce),
                        int8_timing)
    phase_stream("chain", device, ce, ce.raw_serve, int8_timing)
    phase_f32_parity(device)
    pipe = ServingPipeline(_engine("bf16", device, SIZE, conf_thresh=0.25), *BUCKET)
    launches, float_timing = phase_serving(device, pipe)
    phase_graph_serving("float", device, pipe, pipe.fused, pipe.graphs, pipe.detect_images,
                        float_timing)
    phase_stream("float", device, pipe, pipe.fused, float_timing)
    del pipe

    # the yolo11 tasks, each path at full width
    tasks = {}
    for path in TASKS:
        phase_task_parity(path, device)
        # a smaller depth than the det paths' (30 b1, 5 b32, profiled top items),
        # to keep the script near 400 s with this slice's paths
        tasks[path] = phase_task_serving(path, device, n_b1=10, n_b32=3, profile=False)
        torch.cuda.empty_cache()

    # the float-resident int8 tier and the standalone kernels
    qe, scales, cal_s = _calibrated("bf16", device, SIZE, "entropy", conf_thresh=0.25)
    log("fq_calibrate", method="entropy", frames=CAL_FRAMES, scales=len(scales),
        seconds=cal_s, scale_range=[float(scales.min()), float(scales.max())])
    fq_qconvs = fq_main_path_calls(qe)
    qz_st = phase_quantize(device, [((1, *sp["hw"], sp["c"]), sp["dtype"]) for sp in fq_qconvs])
    fused_scales = phase_fused_quantize(device, [sp["kw"]["sx"] for sp in fq_qconvs])
    qc_fq = phase_qconv_tier(device, fq_qconvs)
    sr = phase_stochastic(device)
    planar = phase_planar(device)
    standalone = phase_standalone_ops(device)
    fq_shadow = phase_fq_shadow(qe, *frames_of(synthetic_frames(5, [(480, 640), (640, 426)])))
    phase_fq_parity(device)
    tier = ServingPipeline(qe, *BUCKET)
    fq_launches, fq_timing = phase_fq_serving(device, tier)
    phase_graph_serving("tier", device, tier, tier.fused, tier.graphs, tier.detect_images,
                        fq_timing)
    del tier
    torch.cuda.empty_cache()

    # this slice's models at full width: YOLOv8n det on its three paths,
    # then every other new path (parity, the eager route, the graphs)
    v8 = phase_v8_det(device, cal)
    tasks["v8_det"] = v8["float"]
    for path in PATHS:
        if path not in tasks:
            phase_task_parity(path, device)
            tasks[path] = phase_task_serving(path, device, n_b1=10, n_b32=3, profile=False)
            torch.cuda.empty_cache()
    per_replay = phase_replay_census({"chain": ce.act_scales, "tier": scales,
                                      "v8_chain": v8["chain_scales"],
                                      "v8_tier": v8["tier_scales"]})

    # a user's call is a replay: each path's graph must launch its kernels
    # (the census's profiled replays); the eager forwards, where the
    # wrappers count, must launch them too
    missing = [f"{k} ({path} graph)" for path, want in PER_REPLAY.items() for k in want
               if not per_replay[path][k]]
    eager = {"float": launches, "chain": int8_launches, "tier": fq_launches,
             "v8_chain": v8["chain"], "v8_tier": v8["tier"],
             **{t: run[0] for t, run in tasks.items()}}
    missing += [f"{k} ({path} eager)" for path, want in PER_REPLAY.items() for k in want
                if not eager[path]["qconv1x1_fq" if path.endswith("tier") and k == "qconv1x1"
                                   else k]]
    missing += [f"{k} (standalone ops)" for k in ("quantize_int8", "quantize_int8_stochastic",
                                                  "conv3x3_planar", "conv1x1_planar")
                if standalone[k] == 0]
    if missing:
        raise AssertionError(f"a main path launched no {missing} kernel")

    log("total", seconds=time.perf_counter() - t_start)     # the kernel build included
    print(smi)
    kernels = [{
        "name": "nms_mask", "route": "cuda",
        "source": "tensorrtx_tpu_torch/csrc/nms_mask.cu",
        "replaces": "tensorrtx_tpu/ops/pallas/nms_pallas.py:60",
        "design": "a warp per candidate row, 8 rows a block, the image's candidates and their "
                  "areas staged once per block in shared memory (opt-in above 48 KB at "
                  "N = 2048); lane l tests candidate 32t + l at step t, __any_sync, and the "
                  "warp stops at the first killer: at most ceil(N / 32) dependent steps; "
                  "the IoU in the Pallas kernel's operation order, each op rounded alone",
        "launches": launches["nms_mask"], "max_abs_err": nms[1]["max_abs_err"],
        "ms": nms[1]["ms"], "plain_ms": nms[1]["plain_ms"],
        "bound_ms": nms[1]["bound_ms"], "bound_by": nms[1]["bound_by"], "library_ms": None,
        "launches_int8_path": int8_launches["nms_mask"],
        "launches_int8_tier": fq_launches["nms_mask"],
        "ms_b32": nms[32]["ms"], "plain_ms_b32": nms[32]["plain_ms"],
        "bound_ms_b32": nms[32]["bound_ms"],
        "ms_source": _source(nms[1]["ms_source"], nms[32]["ms_source"]),
        "launches_task_paths": {t: run[0]["nms_mask"] for t, run in tasks.items()},
        "task_paths_bit_equal": {t: run[1] for t, run in tasks.items() if run[1]},
        "launches_v8_int8_path": v8["chain"]["nms_mask"],
        "launches_v8_int8_tier": v8["tier"]["nms_mask"],
    }]
    designs = {
        "qconv3x3": "implicit GEMM on the tensor cores (mma.sync m16n8k32 s8, ldmatrix fragments), "
                    "K = 9C ordered (tap, c) across taps, the OHWI weight as the B operand: "
                    "one wave of blocks over 128x64 output tiles (128x32 for Co <= 32, "
                    "256x16 for Co <= 16, 32x32 when fewer tiles than SMs), 64-byte K "
                    "slices in a 3-deep cp.async ring across tiles, each 16-byte chunk "
                    "gathered through L1 from its tap's pixel (one 16-byte copy for "
                    "C % 16 == 0, two 8-byte ones for C % 8 == 0; else a warp per row, a "
                    "lane per K byte), epilogue through shared memory spread over all "
                    "threads, activation and exit read at run time; rows a pixel stride "
                    "apart (a channel slice read where it lies); from a float source (the "
                    "int8 tier) the wrapper first runs quantize_int8 on the map where it "
                    "lies, then this kernel on its int8 map",
        "qconv1x1": "int8 GEMM on the tensor cores (mma.sync m16n8k32 s8, ldmatrix fragments): "
                    "one wave of blocks over 128x64 output tiles (32x32 when fewer tiles "
                    "than SMs), 64-byte K slices in a 3-deep cp.async ring across tiles, "
                    "epilogue through shared memory, 8 channels a thread; from a float "
                    "source (the int8 tier) it quantizes while staging: 16-byte pieces by "
                    "cp.async into 2 float slots, quantized into the int8 slice one slice "
                    "ahead of the mma steps by the thread that copied them",
    }
    for name, line in (("qconv3x3", 103), ("qconv1x1", 205)):
        s1, s32 = qc[1][name], qc[32][name]
        t1, t32 = qc_fq[1][name], qc_fq[32][name]
        exact = {"gemm_exact_bit_equal": sum(x["gemm_exact_bit_equal"] for x in (s1, s32, t1, t32))}
        if name == "qconv3x3":   # GEMM only, on im2col operands: no PyTorch call is an int8 conv
            exact["int_mm_im2col_yardstick"] = {
                "chain": {"launches": s1["int_mm_im2col_launches"], "ms": s1["int_mm_im2col_ms"],
                          "ms_b32": s32["int_mm_im2col_ms"]},
                "int8_tier": {"launches": t1["int_mm_im2col_launches"],
                              "ms": t1["int_mm_im2col_ms"], "ms_b32": t32["int_mm_im2col_ms"]}}
        kernels.append({
            "name": name, "route": "cuda", "source": "tensorrtx_tpu_torch/csrc/qconv.cu",
            "replaces": f"tensorrtx_tpu/ops/pallas/qconv.py:{line}", "design": designs[name],
            **exact,
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
                                          s32["float_exit_max_abs_err"], t1["float_exit_max_abs_err"],
                                          t32["float_exit_max_abs_err"], fq_shadow[name]),
            "launches_int8_tier": fq_launches["qconv3x3" if name == "qconv3x3" else "qconv1x1_fq"],
            "int8_tier": {"source": "bf16: by quantize_int8, then this kernel" if name == "qconv3x3"
                          else "bf16, quantized in the kernel",
                          "launches_per_forward": t1["launches_per_forward"],
                          "ms": t1["ms"], "plain_ms": t1["plain_ms"], "bound_ms": t1["bound_ms"],
                          "library_ms": t1["library_ms"], "ms_b32": t32["ms"],
                          "plain_ms_b32": t32["plain_ms"], "bound_ms_b32": t32["bound_ms"],
                          "library_ms_b32": t32["library_ms"],
                          "unfused_ms": t1["unfused_ms"], "unfused_ms_b32": t32["unfused_ms"],
                          "int8_source_ms": t1["int8_source_ms"],
                          "int8_source_ms_b32": t32["int8_source_ms"]},
            "ms_source": _source(*(x["ms_source"] for x in (s1, s32, t1, t32))),
            **_v8_int8_stats(name, v8),
        })
    q1, q32 = qz_st[1], qz_st[32]
    fused = {b: {k: qc_fq[b]["qconv3x3"][k] + qc_fq[b]["qconv1x1"][k]
                 for k in ("ms", "unfused_ms", "int8_source_ms", "bound_ms")} for b in (1, 32)}
    kernels.append({
        "name": "quantize_int8", "route": "cuda",
        "source": "tensorrtx_tpu_torch/csrc/quantize.cu",
        "replaces": "tensorrtx_tpu/ops/pallas/quantize.py:29",
        "design": "the division form with no division per element (quant_math.cuh: x * fl(1/s), "
                  "and the values within 2^-13 of a half-integer h decided by the exact FMA "
                  "residual x - h*s; x and s scaled by 2^+-64 at scales beyond 2^+-100), one "
                  "function for both routes: on the int8 tier inside the 1x1 kernel "
                  "(csrc/qconv.cu, while it stages each K slice) and, for the 3x3 inputs, "
                  "this standalone kernel reading the map where it lies (a channel slice by "
                  "its pixel stride); standalone in standalone_ops (both forms)",
        "launches": fq_launches["quantize_int8"] + fq_launches["qconv1x1_fq"],
        "launches_standalone_tier": fq_launches["quantize_int8"],
        "launches_in_qconv1x1_tier": fq_launches["qconv1x1_fq"],
        "launches_standalone_ops": standalone["quantize_int8"], "max_abs_err": 0.0,
        "fused_bit_equal_scales": fused_scales,
        "ms": q1["ms"], "plain_ms": q1["plain_ms"], "bound_ms": q1["bound_ms"],
        "bound_by": q1["bound_by"], "library_ms": None,
        "per": "standalone kernel (division form) on the 80 conv inputs of one B=1 forward",
        "launches_per_forward": q1["launches_per_forward"],
        "ms_b32": q32["ms"], "plain_ms_b32": q32["plain_ms"], "bound_ms_b32": q32["bound_ms"],
        "library_ms_b32": None,
        "tier": {"per": "the tier's 80 int8 convs of one forward by its route (35 quantize_int8 + "
                        "35 int8 3x3, 45 1x1 quantizing in the kernel), against the unfused "
                        "route (copies, standalone quantize, int8-source convs)",
                 "ms": fused[1]["ms"], "unfused_ms": fused[1]["unfused_ms"],
                 "int8_source_ms": fused[1]["int8_source_ms"], "bound_ms": fused[1]["bound_ms"],
                 "ms_b32": fused[32]["ms"], "unfused_ms_b32": fused[32]["unfused_ms"],
                 "int8_source_ms_b32": fused[32]["int8_source_ms"],
                 "bound_ms_b32": fused[32]["bound_ms"]},
        "ms_source": _source(q1["ms_source"], q32["ms_source"], qc_fq[1]["qconv3x3"]["ms_source"],
                             qc_fq[32]["qconv3x3"]["ms_source"], qc_fq[1]["qconv1x1"]["ms_source"],
                             qc_fq[32]["qconv1x1"]["ms_source"]),
        "v8_tier": {"launches_standalone": v8["tier"]["quantize_int8"],
                    "launches_in_qconv1x1": v8["tier"]["qconv1x1_fq"],
                    "per": "standalone kernel (division form) on the tier's conv inputs of one "
                           "YOLOv8n B=1 forward",
                    "launches_per_forward": v8["qz"][1]["launches_per_forward"],
                    **{k + sfx: v8["qz"][b][k] for b, sfx in ((1, ""), (32, "_b32"))
                       for k in ("ms", "plain_ms", "bound_ms")},
                    "ms_source": _source(v8["qz"][1]["ms_source"], v8["qz"][32]["ms_source"])},
    })
    kernels.append({
        "name": "quantize_int8_stochastic", "route": "cuda",
        "source": "tensorrtx_tpu_torch/csrc/quantize.cu",
        "replaces": "tensorrtx_tpu/ops/pallas/quantize.py:56",
        "launches": standalone["quantize_int8_stochastic"], "path": "standalone_ops",
        "max_abs_err": sr["max_abs_err"], "ms": sr["ms"], "plain_ms": sr["plain_ms"],
        "bound_ms": sr["bound_ms"], "bound_by": sr["bound_by"], "library_ms": None,
        "per": "one launch on 32x160x160x64 float32", "ms_source": sr["ms_source"],
    })
    f32_, bf16 = torch.float32, torch.bfloat16
    designs = {
        "conv3x3_planar": "a block per (run of rows of one image, output-channel tile, the "
                          "row's columns) in one wave; weights staged once; a ring of 4 input "
                          "rows with their halo columns, the next row and the residual "
                          "brought by 16-byte cp.async while a row is computed, one barrier a "
                          "row; float32 (and bf16 with 9C > 288) on the CUDA cores, 4 columns x "
                          "8 channels a thread from a 6-value window; bf16 on the tensor cores "
                          "(mma.sync m16n8k16, weights as bf16 hi + lo, float32 sums), a warp "
                          "per 32 columns x 16 channels, taps gathered from the ring, SiLU by "
                          "tanh.approx",
        "conv1x1_planar": "a block per (run of rows, <= 64 output channels, the row's columns) "
                          "in one wave; weights staged once, each row and its residual "
                          "double-buffered by 16-byte cp.async; 4 columns x 8 channels a "
                          "thread; bf16 two blocks an SM",
    }
    for name, line in (("conv3x3_planar", 91), ("conv1x1_planar", 178)):
        p1, p32 = planar[(name, 1, f32_)], planar[(name, 32, f32_)]
        h1, h32 = planar[(name, 1, bf16)], planar[(name, 32, bf16)]
        kernels.append({
            "name": name, "route": "cuda", "source": "tensorrtx_tpu_torch/csrc/conv_planar.cu",
            "replaces": f"tensorrtx_tpu/ops/pallas/conv_planar.py:{line}", "design": designs[name],
            "launches": standalone[name], "path": "standalone_ops",
            "max_abs_err": max(p1["max_abs_err"], p32["max_abs_err"]),
            "ms": p1["ms"], "plain_ms": p1["plain_ms"], "bound_ms": p1["bound_ms"],
            "bound_by": p1["bound_by"], "library_ms": p1["library_ms"],
            "per": f"its {p1['shapes']} shapes at B=1, float32",
            "ms_b32": p32["ms"], "plain_ms_b32": p32["plain_ms"],
            "bound_ms_b32": p32["bound_ms"], "library_ms_b32": p32["library_ms"],
            "bf16": {"max_abs_err": max(h1["max_abs_err"], h32["max_abs_err"]),
                     "ms": h1["ms"], "plain_ms": h1["plain_ms"], "bound_ms": h1["bound_ms"],
                     "library_ms": h1["library_ms"], "ms_b32": h32["ms"],
                     "plain_ms_b32": h32["plain_ms"], "bound_ms_b32": h32["bound_ms"],
                     "library_ms_b32": h32["library_ms"]},
            "ms_source": _source(*(x["ms_source"] for x in (p1, p32, h1, h32))),
        })
    eager_phase = {"nms_mask": "serving", "qconv3x3": "int8_serving", "qconv1x1": "int8_serving",
                   "quantize_int8": "fq_serving"}
    for k in kernels:
        # nms_mask: every path's count, the task paths' zeros too
        k["launches_per_replay"] = {p: n[k["name"]] for p, n in per_replay.items()
                                    if n[k["name"]] or (k["name"] == "nms_mask" and p in PATHS)}
        k["in_graphs"] = [p for p, n in k["launches_per_replay"].items() if n]
        phase = eager_phase.get(k["name"])
        k["launches_from"] = (f"the wrappers' counters over the eager forwards of {phase} (a "
                              "replay adds nothing to them)" if phase
                              else "the wrapper's counter over standalone_ops")
    kernels[0]["launches_from"] += ("; launches_task_paths: over the eager forwards of "
                                    "task_serving, per path; launches_v8_*: of the v8 "
                                    "int8_serving and fq_serving")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--replay-census"]:
        sys.exit(census_main(sys.argv[2]))
    sys.exit(main())
