"""Int8 accuracy study: flip rates and GCD table deltas against float32.

    python -m geoestimation_tpu_torch.tools.quant_study \\
        --checkpoint DIR --image_dir IMAGES --meta META.csv \\
        [--ref_checkpoint REF] [--stats absmax,p999,p9999] [--headrooms 1.0] \\
        [--crops 1|5|10] [--pinned_scales] [--feature_tta \\
        [--feature_tta_levels 3]] [--budget 0.5] [--assert_budget] \\
        [--json OUT] [--cpu]

The port of the JAX package's `tools/quant_study.py`. Over a checkpoint and
an eval corpus it measures, for every calibration setting of a stat x
headroom grid (or the checkpoint's own pinned `int8_scales.json`, validated
as the serving engine validates it), the per-image prediction flip rate
against the float32 reference per partitioning key and for the f*
prediction, and the GCD threshold-accuracy table delta (percentage points)
at {1, 25, 200, 750, 2500} km, and verdicts each setting against the parity
budget. One float32 sampling-calibration pass (`quant.calibrate_samples`)
gives every (stat, headroom) on the host; the int8 network is built once
with call-time scales (`quant.build_int8_apply_dynamic`, every convolution
on `conv_s8`); every image is decoded once and all settings run on the
same device batch. `--ref_checkpoint` takes the float32 tables from another
checkpoint (the original of a distilled or fine-tuned one). The printed
lines and the JSON keys are the JAX tool's. Runs on CUDA unless --cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..eval.metrics import DEFAULT_THRESHOLDS_KM as THRESHOLDS_KM


def gcd_table(pred_lat, pred_lng, true_lat, true_lng):
    """{threshold km: share of images within it}, through
    `eval.metrics.great_circle_distance`."""
    from ..eval.metrics import great_circle_distance

    d = great_circle_distance(pred_lat, pred_lng, true_lat, true_lng).numpy()
    return {t: float((d <= t).mean()) for t in THRESHOLDS_KM}


def parse_grid(stats, headrooms):
    return [(s, h) for s in stats.split(",")
            for h in [float(x) for x in headrooms.split(",")]]


def corpus_stats(image_dir):
    """What geometry the verdicts were measured on: image sizes from the
    headers (PIL's lazy open), no second decode."""
    from collections import Counter

    from PIL import Image

    from ..data.image_folder import list_images

    sizes, hist = [], Counter()
    for path in list_images(image_dir):
        try:
            with Image.open(path) as im:
                w, h = im.size
        except OSError:
            continue
        sizes.append((w, h))
        hist[int(np.ceil(max(w, h) / 256.0)) * 256] += 1
    if not sizes:
        return {}
    ws = np.array([s[0] for s in sizes], np.float64)
    hs = np.array([s[1] for s in sizes], np.float64)
    long_side = np.maximum(ws, hs)
    return {
        "n_files": len(sizes),
        "long_side_hist_ceil256": {str(k): v for k, v in sorted(hist.items())},
        "long_side_min_med_max": [int(long_side.min()),
                                  int(np.median(long_side)),
                                  int(long_side.max())],
        "portrait_frac": float((hs > ws).mean()),
        "distinct_shapes": int(len(set(sizes))),
    }


def build_parser():
    p = argparse.ArgumentParser(
        description="int8 PTQ flip-rate / GCD-delta study vs fp32 "
                    "(PyTorch/CUDA port)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--hparams", default=None)
    p.add_argument("--ref_checkpoint", default=None,
                   help="checkpoint providing the fp32 exact reference "
                        "tables (default: --checkpoint itself); for "
                        "distilled or fine-tuned serving checkpoints")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--meta", required=True)
    p.add_argument("--calib_dir", default=None,
                   help="calibration images (default: --image_dir)")
    p.add_argument("--calib_images", type=int, default=64)
    p.add_argument("--stats", default="absmax,p999,p9999")
    p.add_argument("--headrooms", default="1.0")
    p.add_argument("--crops", type=int, default=10, choices=[1, 5, 10])
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--budget", type=float, default=0.5,
                   help="per-cell GCD delta budget in percentage points")
    p.add_argument("--json", dest="json_out", default=None)
    p.add_argument("--fast_decode", action="store_true",
                   help="scaled-DCT JPEG decode on the host for BOTH the "
                        "calibration and the eval batches")
    p.add_argument("--pinned_scales", action="store_true",
                   help="evaluate the checkpoint's own int8_scales.json "
                        "(e.g. QAT-trained scales), validated as the "
                        "serving engine validates it, instead of a "
                        "fresh-calibration grid")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of CUDA")
    p.add_argument("--assert_budget", action="store_true",
                   help="exit 1 unless at least one setting keeps every GCD "
                        "cell within --budget")
    p.add_argument("--feature_tta", action="store_true",
                   help="also measure the feature-space TTA variant of each "
                        "int8 setting (suffix '+ftta')")
    p.add_argument("--feature_tta_levels", default="3",
                   help="with --feature_tta: comma list of crop levels "
                        "(suffixes '+ftta' for level 3, '+ftta<L>' "
                        "otherwise)")
    return p


def _float32_model(config, state_dict, n_classes, device):
    from ..train.init import model_from_config

    with torch.device("meta"):
        model = model_from_config(config, n_classes, torch.float32)
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model.to(device, memory_format=torch.channels_last).eval()


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..data.image_folder import iter_image_folder, load_meta_csv
    from ..eval.engine import resolve_device
    from ..eval.infer import HierarchyArrays, mean_tta_logits, predict_all
    from ..geo import Hierarchy
    from ..ingest.pipeline import eval_pipeline, eval_pipeline_s8, shift_s8
    from ..models.quant import (
        autoselect_scales,
        build_int8_apply_dynamic,
        calibrate_samples,
        derive_scales,
        quantize_model,
        requant_rounding_mode,
        unpack_scales,
        weights_hash,
    )
    from ._load import load_with_partitionings

    device = resolve_device("cpu" if args.cpu else "cuda")
    config, sd, parts, n_classes = load_with_partitionings(args.checkpoint,
                                                           args.hparams)
    mp = config.model_params
    harrays = HierarchyArrays.from_hierarchy(Hierarchy.build(parts), device)
    ref_config, ref_sd = config, sd
    if args.ref_checkpoint:
        ref_config, ref_sd, _, _ = load_with_partitionings(
            args.ref_checkpoint)
        if tuple(ref_config.model_params.partitionings.files) != \
                tuple(mp.partitionings.files):
            raise SystemExit(
                "--ref_checkpoint must share the partitioning files with "
                "--checkpoint (its tables are the parity target)")
    ref_model = _float32_model(ref_config, ref_sd, n_classes, device)
    n_crops = args.crops

    # settings are (stat, headroom, mode); 'feature<L>' = feature-space
    # TTA cropping at layer L
    ft_levels = ([int(x) for x in args.feature_tta_levels.split(",")]
                 if args.feature_tta else [])
    qnet = quantize_model(sd, mp.arch)
    if args.pinned_scales:
        # the serving configuration: the checkpoint's own scales, validated
        # as the engine validates them (version, site map, weights hash)
        scales_path = os.path.join(args.checkpoint, "int8_scales.json")
        with open(scales_path) as f:
            doc = json.load(f)
        pinned, prov = unpack_scales(doc, mp.arch,
                                     expect_hash=weights_hash(qnet))
        if pinned is None:
            raise SystemExit(
                f"--pinned_scales: {scales_path} rejected: {prov}")
        label = (f"pinned:{prov.get('source', '?')}"
                 f"/{prov.get('stat', '?')}")
        n_calib = int(prov.get("n_images", 0))
        head = float(prov.get("headroom", 1.0))
        grid = [(label, head, "exact")]
        grid += [(label, head, f"feature{lvl}") for lvl in ft_levels]
        scale_sets = {g: dict(pinned) for g in grid}
        print(f"using pinned scales from {scales_path} ({label})",
              flush=True)
    else:
        # --- calibration: one sampling pass, scales per grid point ----
        calib_dir = args.calib_dir or args.image_dir
        batches, n_calib = [], 0
        for fb in iter_image_folder(calib_dir, batch_size=32,
                                    fast_decode=args.fast_decode):
            good = fb.images[np.asarray(fb.valid)]
            take = min(args.calib_images - n_calib, len(good))
            if take:
                batches.append(good[:take])
                n_calib += take
            if n_calib >= args.calib_images:
                break
        print(f"calibrating on {n_calib} images from {calib_dir} "
              f"(one sampling pass)", flush=True)
        samples = calibrate_samples(sd, batches, arch=mp.arch,
                                    n_crops=n_crops, crop=224, device=device)
        base_grid = parse_grid(args.stats, args.headrooms)
        grid = [(s, h, "exact") for s, h in base_grid]
        for lvl in ft_levels:
            grid += [(s, h, f"feature{lvl}") for s, h in base_grid]

        # 'auto' rows: the serving engine's selection picks a stat per
        # headroom, and the study verdicts its scales
        auto_picks = {}

        def scales_for(stat, h):
            if stat != "auto":
                return derive_scales(samples, stat, h)
            if h not in auto_picks:
                scales, picked, kls = autoselect_scales(
                    sd, batches, qnet, arch=mp.arch, n_classes=n_classes,
                    n_crops=n_crops, crop=224, headroom=h, samples=samples,
                    device=device)
                auto_picks[h] = {"picked": picked,
                                 "proxy_kl": {k: float(v)
                                              for k, v in kls.items()},
                                 "scales": scales}
                print(f"auto@{h:g}: picked {picked} (parity-proxy KL "
                      + ", ".join(f"{k}={v:.5f}" for k, v in kls.items())
                      + ")", flush=True)
            return auto_picks[h]["scales"]

        scale_sets = {g: scales_for(g[0], g[1]) for g in grid}

    # --- the float32 reference and ONE dynamic int8 network -------------
    def fold_predict(logits):
        logits = [mean_tta_logits(l, n_crops) for l in logits]
        preds = predict_all(logits, harrays)
        return torch.stack([
            torch.stack([preds[k][0].float(), preds[k][1].float(),
                         preds[k][2].float()]) for k in sorted(preds)
        ]).cpu().numpy()

    pred_keys = sorted(list(harrays.names) + ["hierarchy"])

    @torch.inference_mode()
    def fwd_fp32(images_u8):
        # the reference is --ref_checkpoint's (the ORIGINAL model's) when
        # given, so a distilled checkpoint's drift shows in the deltas
        return fold_predict(ref_model(eval_pipeline(
            images_u8, n_crops=n_crops, crop=224, dtype=torch.float32)))

    dyn = build_int8_apply_dynamic(qnet, n_classes=n_classes, device=device)

    def fwd_int8(images_u8, act_scales):
        return fold_predict(dyn(eval_pipeline_s8(images_u8, n_crops=n_crops,
                                                 crop=224), act_scales))

    def make_ft_fwd(lvl):
        dyn_ft = build_int8_apply_dynamic(
            qnet, n_classes=n_classes, device=device,
            feature_tta={"crop": 224, "n_crops": n_crops, "level": lvl})

        def fwd(images_u8, act_scales):
            return fold_predict(dyn_ft(shift_s8(images_u8), act_scales))

        return fwd

    forwards = {"exact": fwd_int8,
                **{f"feature{lvl}": make_ft_fwd(lvl) for lvl in ft_levels}}

    # --- one pass over the corpus, every setting per decoded batch ------
    meta = load_meta_csv(args.meta)
    gt = {str(r.IMG_ID): (float(r.LAT), float(r.LON))
          for r in meta.itertuples()}
    ref_rows = []        # (K, 3) per image
    cfg_rows = {g: [] for g in grid}
    true_ll = []
    n_images = 0
    for fb in iter_image_folder(args.image_dir, batch_size=args.batch_size,
                                fast_decode=args.fast_decode):
        images = torch.as_tensor(fb.images).to(device)
        ref = fwd_fp32(images)
        outs = {g: forwards[g[2]](images, scale_sets[g]) for g in grid}
        for i, img_id in enumerate(fb.ids):
            key = img_id if img_id in gt else os.path.splitext(img_id)[0]
            if not fb.valid[i] or key not in gt:
                continue
            ref_rows.append(ref[:, :, i])
            for g in grid:
                cfg_rows[g].append(outs[g][:, :, i])
            true_ll.append(gt[key])
            n_images += 1
        print(f"  {n_images} images evaluated", flush=True)

    ref_arr = np.stack(ref_rows, axis=-1)        # (K, 3, N)
    true_lat = np.array([t[0] for t in true_ll])
    true_lng = np.array([t[1] for t in true_ll])
    ref_tables = {k: gcd_table(ref_arr[i, 1], ref_arr[i, 2], true_lat,
                               true_lng)
                  for i, k in enumerate(pred_keys)}

    results = {"n_images": n_images, "n_calib": n_calib,
               "crops": n_crops, "budget_pt": args.budget,
               "fast_decode": bool(args.fast_decode),
               "requant_mode": requant_rounding_mode(),
               "corpus": corpus_stats(args.image_dir),
               "ref_tables": {k: {str(t): v for t, v in tb.items()}
                              for k, tb in ref_tables.items()},
               "configs": {}}
    print(f"\n== int8 PTQ study: {n_images} images, {n_crops}-crop TTA, "
          f"budget {args.budget} pt ==")
    print(f"{'config':<16}{'max |dGCD| pt':>14}  "
          + "".join(f"{k + ' flip%':>16}" for k in pred_keys))
    any_pass = False
    for g in grid:
        arr = np.stack(cfg_rows[g], axis=-1)
        flips, deltas, max_delta = {}, {}, 0.0
        for i, k in enumerate(pred_keys):
            flips[k] = float((arr[i, 0] != ref_arr[i, 0]).mean())
            tb = gcd_table(arr[i, 1], arr[i, 2], true_lat, true_lng)
            deltas[k] = {str(t): 100 * (tb[t] - ref_tables[k][t])
                         for t in THRESHOLDS_KM}
            max_delta = max(max_delta,
                            max(abs(v) for v in deltas[k].values()))
        # the worst degradation (accuracy lost against the reference) beside
        # the symmetric verdict: a cell can leave the budget by being better
        max_degradation = max(
            0.0, -min(min(d.values()) for d in deltas.values()))
        # inclusive budget: a cell moving by exactly the budget is within it
        ok = max_delta <= args.budget + 1e-9
        any_pass = any_pass or ok
        if g[2] == "exact":
            suffix = ""
        elif g[2] == "feature3":
            suffix = "+ftta"
        else:
            suffix = f"+ftta{g[2][len('feature'):]}"
        name = f"{g[0]}@{g[1]:g}" + suffix
        print(f"{name:<16}{max_delta:>14.3f}  "
              + "".join(f"{100 * flips[k]:>15.2f}%" for k in pred_keys)
              + ("   PASS" if ok else "   FAIL")
              + (f"  (worst degradation {max_degradation:.3f} pt)"
                 if not ok else ""))
        results["configs"][name] = {
            "stat": g[0], "headroom": g[1], "tta": g[2],
            "max_abs_gcd_delta_pt": max_delta,
            "max_degradation_pt": max_degradation,
            "within_budget": ok,
            "flip_rates": flips,
            "gcd_deltas_pt": deltas,
        }
        if g[0] == "auto":
            results["configs"][name]["picked_stat"] = \
                auto_picks[g[1]]["picked"]
            results["configs"][name]["proxy_kl"] = \
                auto_picks[g[1]]["proxy_kl"]
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
        print(f"wrote {args.json_out}")
    if args.assert_budget and not any_pass:
        print(f"FAIL: no calibration setting kept every GCD cell within "
              f"{args.budget} pt of fp32")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
