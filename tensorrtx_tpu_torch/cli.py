"""Command-line interface — the analog of the reference's per-model binaries.

Reference CLI (yolo11/yolo11_det.cpp:115-160):
    ./yolo11_det -s yolo11n.wts yolo11n.engine n     # build
    ./yolo11_det -d yolo11n.engine ../images g       # run

The port's (the same commands as `python -m tensorrtx_tpu.cli`, for the
models this package serves):
    python -m tensorrtx_tpu_torch.cli build yolo11 -w y.wts -o y.engine \
        --precision bf16 --set scale=n [--device cuda]
    python -m tensorrtx_tpu_torch.cli build yolo11 -w y-seg.wts -o y-seg.engine \
        --set task=seg          (task=pose num_classes=1, task=obb num_classes=15
                                 input_h=1024 input_w=1024, task=cls
                                 num_classes=1000 input_h=224 input_w=224)
    python -m tensorrtx_tpu_torch.cli build yolov8 -w v8.wts -o v8-p2.engine \
        --set variant=p2        (variant=5u; task=seg|pose|obb|cls as for yolo11)
    python -m tensorrtx_tpu_torch.cli build yolov10 -w v10.wts -o v10.engine
    python -m tensorrtx_tpu_torch.cli build yolo26 -w y26.wts -o y26.engine \
        [--set task=obb num_classes=15 input_h=1024 input_w=1024]
    python -m tensorrtx_tpu_torch.cli build yolo11 -w y.wts -o y.int8 \
        --int8-calib-dir CALIB_DIR [--calib-method entropy] [--calib-images 64]
    python -m tensorrtx_tpu_torch.cli run y.engine IMAGE_DIR [--batch 8] [--device cuda]
        (det, seg, pose and obb engines print each image's boxes, scores and
        classes, as the JAX package's `run` does; a cls engine has none and
        raises; the int8 build takes the det engines of yolo11 and yolov8)
    python -m tensorrtx_tpu_torch.cli list
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_set(kvs):
    out = {}
    for kv in kvs or []:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def cmd_build(args):
    from tensorrtx_tpu_torch.core.engine import build_engine

    eng = build_engine(args.model, args.wts, precision=args.precision,
                       device=args.device, **_parse_set(args.set))
    if args.int8_calib_dir:
        # the float-resident int8 tier: letterbox each calibration image,
        # calibrate, save the engine with its scale table
        import torch

        from tensorrtx_tpu_torch.core.quant import (QuantizedEngine, calibrate,
                                                    check_int8_task)
        from tensorrtx_tpu_torch.core.runner import load_image, read_files_in_dir
        from tensorrtx_tpu_torch.ops.preprocess import letterbox

        check_int8_task(eng)
        h, w, _ = eng.model.input_shape(eng.cfg)
        files = read_files_in_dir(args.int8_calib_dir)[:args.calib_images]
        if not files:
            print(f"no images in {args.int8_calib_dir}", file=sys.stderr)
            return 1
        batches = []
        for f in files:
            im = torch.tensor(load_image(f), device=eng.device)
            batches.append(letterbox(im, im.shape[0], im.shape[1], h, w)[None])
        QuantizedEngine(eng, calibrate(eng, batches, args.calib_method)).save(args.output)
        print(f"int8 engine saved → {args.output} (calib table int8calib.json inside, "
              f"{args.calib_method} over {len(files)} images)")
        return 0
    eng.save(args.output)
    print(f"engine saved → {args.output}")
    return 0


def cmd_run(args):
    import os

    from tensorrtx_tpu_torch.core.engine import load_engine
    from tensorrtx_tpu_torch.core.runner import (ServingPipeline, load_image,
                                                 read_files_in_dir)

    eng = load_engine(args.engine, device=args.device)
    files = ([args.image_dir] if os.path.isfile(args.image_dir)
             else read_files_in_dir(args.image_dir))
    if not files:
        print(f"no images in {args.image_dir}", file=sys.stderr)
        return 1
    imgs = [load_image(f) for f in files]
    t0 = time.perf_counter()
    pipe = ServingPipeline(eng, src_h=max(i.shape[0] for i in imgs),
                           src_w=max(i.shape[1] for i in imgs))
    for i in range(0, len(imgs), args.batch):
        res = pipe.detect_images(imgs[i:i + args.batch])
        for f, r in zip(files[i:i + args.batch], res):
            dets = [{"box": [round(float(v), 1) for v in b],
                     "score": round(float(s), 3), "class": int(c)}
                    for b, s, c in zip(r["boxes"], r["scores"], r["classes"])]
            print(json.dumps({"image": f, "detections": dets}))
    dt = time.perf_counter() - t0
    print(f"# {len(imgs)} images in {dt * 1e3:.1f} ms on {eng.device}", file=sys.stderr)
    return 0


def cmd_list(args):
    from tensorrtx_tpu_torch.core.registry import get_model, list_models

    for name in list_models():
        print(f"{name:24s} {get_model(name).doc}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tensorrtx_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help=".wts → engine dir (reference -s)")
    b.add_argument("model")
    b.add_argument("-w", "--wts", required=True)
    b.add_argument("-o", "--output", required=True)
    b.add_argument("--precision", default="fp32", choices=["fp32", "bf16", "fp16"])
    b.add_argument("--set", nargs="*", help="cfg overrides key=value")
    b.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    b.add_argument("--int8-calib-dir", help="calibration images: build the int8 engine")
    b.add_argument("--calib-method", default="entropy",
                   choices=["entropy", "percentile", "absmax"])
    b.add_argument("--calib-images", type=int, default=64)
    b.set_defaults(fn=cmd_build)

    r = sub.add_parser("run", help="engine dir + images → detections (reference -d)")
    r.add_argument("engine")
    r.add_argument("image_dir")
    r.add_argument("--batch", type=int, default=1)
    r.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    r.set_defaults(fn=cmd_run)

    ls = sub.add_parser("list", help="registered models")
    ls.set_defaults(fn=cmd_list)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
