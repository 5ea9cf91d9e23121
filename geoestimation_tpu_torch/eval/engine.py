"""Batched inference engine: images -> per-partitioning + f* predictions.

The port of `geoestimation_tpu/eval/engine.py` (device TTA, host-exact
ten-crop and feature-space TTA). One forward takes the uint8 host batch to
the device, normalizes and crops it there (or only normalizes the host's
exact ten-crops, or for feature TTA the base image, whose crops are taken
from a feature map), runs the classifier -- the module path, the BN-folded
fast path with the fused CUDA bottleneck kernel, or the int8 path
(`models/quant.py`, every conv on the int8 CUDA kernel, calibrated on first
use) -- folds the crops, applies the f* rule, and returns predicted classes
and coordinates for every partitioning key plus 'hierarchy' in one small
transfer. An ISN checkpoint (scene-gated heads, `models/isn.py`) runs on
every path: each builds its heads from the checkpoint. With a `layout`
(`parallel/mesh.py`) the engine holds one replica per device of the layout
and splits each batch over them; with `process_slice` the folder-level
entry points take one process's share of a folder and merge the GCD counts
across processes (`parallel/multihost.py`).

Runs on CUDA unless `device="cpu"` is asked for; there is no fallback from
one to the other.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..geo import Hierarchy, load_partitionings
from ..ingest.pipeline import (
    eval_pipeline,
    eval_pipeline_s8,
    normalize,
    shift_s8,
)
from ..train.init import model_from_config
from ..utils.spans import count, span
from .infer import TTA_FOLDS, HierarchyArrays, mean_tta_logits, predict_all
from .metrics import DEFAULT_THRESHOLDS_KM, GcdAccumulator, gcd_threshold_counts


def resolve_partitioning_paths(files: Sequence[str],
                               search_dirs: Sequence[str]) -> list:
    """Resolve config-relative partitioning CSV paths against search dirs
    (cwd, checkpoint dir, repo root)."""
    out = []
    for f in files:
        if os.path.isabs(f) and os.path.exists(f):
            out.append(f)
            continue
        for d in ["", *search_dirs]:
            cand = os.path.join(d, f) if d else f
            if os.path.exists(cand):
                out.append(cand)
                break
        else:
            raise FileNotFoundError(
                f"partitioning file {f!r} not found in {list(search_dirs)}"
            )
    return out


def default_scales_path(checkpoint: str) -> str:
    """Conventional location of the cached int8 activation scales: next to
    the checkpoint (`<ckpt_dir>/int8_scales.json`)."""
    d = checkpoint if os.path.isdir(checkpoint) else os.path.dirname(
        os.path.abspath(checkpoint))
    return os.path.join(d, "int8_scales.json")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist. On CUDA,
    float32 convolutions and matmuls are set to run in float32, not TF32
    (--precision 32 means float32)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "(CLI: --cpu) to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


class InferenceEngine:
    def __init__(
        self,
        config,
        state_dict: dict,
        partitionings=None,
        n_crops: int = 10,
        crop: int = 224,
        dtype=torch.bfloat16,
        search_dirs: Sequence[str] = (),
        fast: bool = False,
        use_pallas: bool = False,
        use_pallas_s2: bool = False,
        layout=None,
        tta_mode: str = "device",
        tta_fold: str = "prob_mean",
        feature_tta_level: int = 3,
        int8: bool = False,
        int8_scales_path: Optional[str] = None,
        calib_dir: Optional[str] = None,
        calib_images: int = 64,
        calib_stat: str = "auto",
        calib_headroom: float = 1.0,
        int8_persist: bool = True,
        int8_recalibrate: bool = False,
        fast_decode: bool = False,
        device="cuda",
    ):
        """config: the hparams schema (`utils.config.Config`); state_dict:
        the classifier's (`convert.from_jax_variables` or a port
        checkpoint's `state_dict.pt`).

        fast=True folds BatchNorm into bf16 conv weights at load time
        (`models/fast_infer.py`); use_pallas additionally routes the
        stride-1 bottlenecks of layer1 and layer2 through the fused CUDA
        kernel (its plain version on the CPU); use_pallas_s2 with it routes
        the stride-2 stage entries whose input width is a multiple of 8
        through the stride-2 kernel (no CLI sets it, as in the JAX package;
        chip_smoke.py and the bench tools do). tta_mode: 'device' (crops
        from a 256 square on the device), 'host_exact' (torchvision-exact
        host ten-crop of the full resized rectangle, for parity on
        non-square images; forces n_crops=10) or 'feature' (approximate:
        the trunk runs once on the base image and its mirror, and the crops
        are taken at the layer{feature_tta_level} feature map,
        `models/fast_infer.py` `build_feature_tta_apply`; 5 or 10 crops; in
        bf16 it is the folded path, so it takes `use_pallas` and refuses
        float32). tta_fold: how per-crop
        logits combine (eval.infer.mean_tta_logits). fast_decode: scaled
        DCT JPEG decode on the host (calibration batches too). device:
        'cuda' (default) or 'cpu'. layout: a `parallel.mesh.MeshLayout`
        whose local devices replace `device`: one replica of the built
        forward (module, fast, feature or int8) on each, every batch split
        evenly over them, each part launched before any is waited for, the
        parts' predictions concatenated in order.

        int8: post-training int8 quantization (`models/quant.py`); `dtype`
        and `fast` are then unused. Calibration source, in priority order:
        `calib_dir` (the first `calib_images` images of the dir in sorted
        order; recalibrates unless the cache proves it was made from this
        set at these settings), else a valid scales cache at
        `int8_scales_path` (v2 format, `quant.pack_scales`: trusted only for
        the same weights hash, pixel pipeline and settings), else the first
        batch. The scales are written back to the cache unless
        `int8_persist` is False or the source had fewer than
        MIN_DISTINCT_FOR_PERSIST distinct images; a first-batch calibration
        does not replace a cache made from a `calib_dir` unless
        `int8_recalibrate`. calib_stat: 'auto' (default: the statistic whose
        int8 forward best matches the float32 one, `quant.
        autoselect_scales`) | 'absmax' | 'p999' | 'p9999'; calib_headroom:
        scale multiplier; int8_recalibrate: ignore any cache.
        """
        if tta_mode not in ("device", "host_exact", "feature"):
            raise ValueError(f"unknown tta_mode {tta_mode!r}")
        if tta_mode == "feature" and n_crops not in (5, 10):
            raise ValueError("feature TTA supports 5 or 10 crops")
        if tta_mode == "host_exact":
            n_crops = 10
        if tta_fold not in TTA_FOLDS:
            raise ValueError(
                f"unknown tta_fold {tta_fold!r}; have {TTA_FOLDS}")
        mp = config.model_params
        devices = layout.local_devices() if layout is not None else [device]
        self.devices = [resolve_device(d) for d in devices]
        self.device = self.devices[0]
        self.layout = layout
        self._calls = 0   # predict_batch calls: the request id of its spans
        if partitionings is None:
            paths = resolve_partitioning_paths(mp.partitionings.files,
                                               search_dirs)
            partitionings = load_partitionings(
                paths, names=list(mp.partitionings.shortnames))
        self.partitionings = partitionings
        self.hierarchy = Hierarchy.build(partitionings)
        self._harrays = [HierarchyArrays.from_hierarchy(self.hierarchy, d)
                         for d in self.devices]
        self.harrays = self._harrays[0]
        self.n_crops = n_crops
        self.crop = crop
        self.dtype = dtype
        self.tta_mode = tta_mode
        self.tta_fold = tta_fold
        self._feature_tta_level = feature_tta_level
        self._fast_decode = fast_decode
        n_classes = tuple(len(p) for p in partitionings)
        self.model = None
        self._fast_apply = None   # the fast path's, or feature TTA's, apply
        self._nets = []           # each device's forward, crops -> logits
        self._int8 = int8
        self._int8_apply = None   # built at the first batch, after calibration
        self._int8_nets = []
        if int8:
            from ..models.quant import quantize_model, weights_hash

            self.model_arch = mp.arch
            self._state_dict = state_dict
            self._qnet = quantize_model(state_dict, mp.arch)
            self._qhash = weights_hash(self._qnet)
            self._n_classes = n_classes
            self._int8_scales_path = int8_scales_path
            self._calib_dir = calib_dir
            self._calib_images = calib_images
            self._calib_stat = calib_stat
            self._calib_headroom = calib_headroom
            self._int8_persist = int8_persist
            self._int8_recalibrate = int8_recalibrate
            self.int8_calib_kls = None   # {stat: KL} of an 'auto' calibration
        elif tta_mode == "feature":
            # the folded network computes in bf16: refuse a float32 request
            if dtype != torch.bfloat16:
                raise ValueError(
                    "feature TTA runs the bf16 folded-BN network; "
                    "--precision 32 is not available in this mode "
                    "(use --precision 16, or drop --feature_tta)")
            from ..models.fast_infer import build_feature_tta_apply

            self._nets = [build_feature_tta_apply(
                state_dict, mp.arch, n_classes=n_classes,
                use_pallas=use_pallas, crop=crop, n_crops=n_crops,
                level=feature_tta_level, device=d) for d in self.devices]
            self._fast_apply = self._nets[0]
        elif fast:
            # The fold computes in bf16; refuse a float32 request instead of
            # returning bf16 results labeled fp32.
            if dtype != torch.bfloat16:
                raise ValueError(
                    "--fast folds BatchNorm into bf16 conv weights; "
                    "--precision 32 is not available in this mode "
                    "(use --precision 16, or drop --fast)")
            from ..models.fast_infer import build_fast_apply

            self._nets = [build_fast_apply(
                state_dict, mp.arch, n_classes=n_classes,
                use_pallas=use_pallas, use_pallas_s2=use_pallas_s2,
                device=d) for d in self.devices]
            self._fast_apply = self._nets[0]
        else:
            for d in self.devices:
                with torch.device("meta"):
                    model = model_from_config(config, n_classes, dtype)
                model.load_state_dict(state_dict, strict=True, assign=True)
                self._nets.append(model.to(
                    d, memory_format=torch.channels_last).eval())
            self.model = self._nets[0]

    # -- int8: calibration and the scales cache ---------------------------------

    def _calib_dir_fingerprint(self):
        """Identity of the calibration set: sha256 over the sorted first
        `calib_images` file names and sizes of `calib_dir`."""
        import hashlib

        from ..data.image_folder import list_images

        h = hashlib.sha256()
        for p in list_images(self._calib_dir)[:self._calib_images]:
            h.update(os.path.basename(p).encode())
            h.update(str(os.path.getsize(p)).encode())
        return h.hexdigest()[:16]

    def _calib_dir_batches(self):
        """The first `calib_images` decodable images of `calib_dir` in
        sorted-name order, as uint8 base batches, and their count."""
        from ..data.image_folder import iter_image_folder

        batches, n = [], 0
        for fb in iter_image_folder(self._calib_dir, batch_size=32,
                                    fast_decode=self._fast_decode):
            good = fb.images[np.asarray(fb.valid)]
            take = min(self._calib_images - n, len(good))
            if take:
                batches.append(good[:take])
                n += take
            if n >= self._calib_images:
                break
        if n == 0:
            raise FileNotFoundError(
                f"calib_dir {self._calib_dir!r}: no decodable images")
        return batches, n

    def _stat_matches(self, prov_stat) -> bool:
        """True iff a cache's provenance stat satisfies the requested one;
        'auto' accepts any 'auto:<picked>' cache (the pick is a function of
        the weights, the set and the headroom, which the other checks
        pin)."""
        if prov_stat == self._calib_stat:
            return True
        return (self._calib_stat == "auto" and isinstance(prov_stat, str)
                and prov_stat.startswith("auto:"))

    def _calibrate_batches(self, batches, n_crops=None):
        """(scales, stat for the provenance) from uint8 base batches at the
        requested stat; 'auto' records 'auto:<picked>'."""
        from ..models import quant

        if n_crops is None:
            n_crops = self.n_crops
        if self._calib_stat == "auto":
            scales, picked, kls = quant.autoselect_scales(
                self._state_dict, batches, self._qnet, arch=self.model_arch,
                n_classes=self._n_classes, n_crops=n_crops, crop=self.crop,
                headroom=self._calib_headroom, device=self.device)
            print("int8: auto calibration picked stat=" + picked
                  + " (parity-proxy KL "
                  + ", ".join(f"{s}={kls[s]:.5f}" for s in kls) + ")",
                  flush=True)
            self.int8_calib_kls = kls
            return scales, f"auto:{picked}"
        scales = quant.calibrate(self._state_dict, batches, self.model_arch,
                                 n_crops=n_crops, crop=self.crop,
                                 stat=self._calib_stat,
                                 headroom=self._calib_headroom,
                                 device=self.device)
        return scales, self._calib_stat

    # Persist first-batch scales only when calibrated on a varied sample: a
    # serving micro-batch padded from one image must not become the cache.
    MIN_DISTINCT_FOR_PERSIST = 6

    def _read_cache(self, path, fingerprint):
        """(scales, provenance) of a trusted cache at `path`, else
        (None, None), saying why once. The JAX package's trust rules: the
        weights hash; the pixel pipeline and the stat and headroom (except
        for trained 'qat'/'distill' scales); with calib_dir, a calib_dir
        cache of this very set."""
        import json

        from ..models.quant import unpack_scales

        try:
            with open(path) as f:
                obj = json.load(f)
        except (json.JSONDecodeError, OSError):
            return None, None
        scales, prov = unpack_scales(obj, self.model_arch,
                                     expect_hash=self._qhash)
        why = prov
        if scales is not None:
            trained = prov.get("source") in ("qat", "distill")
            if not trained and not (
                    prov.get("fast_decode") == bool(self._fast_decode)
                    and prov.get("crop") == self.crop
                    and prov.get("n_crops") == self.n_crops):
                scales, why = None, ("cache calibrated under a different "
                                     "pixel pipeline")
            elif not trained and not (
                    self._stat_matches(prov.get("stat"))
                    and prov.get("headroom") == self._calib_headroom):
                scales, why = None, (
                    "cache calibrated at different settings (stat="
                    f"{prov.get('stat')!r}, headroom={prov.get('headroom')!r}"
                    f"; requested {self._calib_stat!r}@"
                    f"{self._calib_headroom!r})")
            elif self._calib_dir and trained:
                print("int8: keeping the checkpoint's trained "
                      f"{prov['source']} scales; --calib_dir is ignored for "
                      "trained-against scales (use --recalibrate to "
                      "override)", flush=True)
            elif self._calib_dir and not (
                    prov.get("source") == "calib_dir"
                    and prov.get("calib_fingerprint") == fingerprint):
                scales, why = None, ("cache not from this calibration "
                                     "set/settings")
        if scales is None:
            print(f"int8: ignoring scales cache {path}: {why}", flush=True)
            return None, None
        return scales, prov

    def _write_cache(self, path, scales, source, n_images, stat, fingerprint):
        """Atomic write of the scales cache. A first-batch calibration does
        not replace a calib_dir-made cache unless int8_recalibrate (the JAX
        package replaces it, ROADMAP.md Queue 3)."""
        import json

        from ..models.quant import pack_scales

        try:
            with open(path) as f:
                old_src = json.load(f).get("provenance", {}).get("source")
        except (OSError, json.JSONDecodeError, AttributeError):
            old_src = None
        if (source == "first_batch" and old_src == "calib_dir"
                and not self._int8_recalibrate):
            print(f"int8: not replacing the calib_dir scales cache at {path} "
                  "with first-batch scales (pass --recalibrate to replace "
                  "it)", flush=True)
            return
        if old_src in ("qat", "distill"):
            print(f"int8: WARNING -- overwriting {old_src}-trained scales at "
                  f"{path} with a fresh {source} calibration (--recalibrate); "
                  "the trained scales have no other copy", flush=True)
        try:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(pack_scales(
                    scales, weights_hash=self._qhash, source=source,
                    n_images=n_images, stat=stat,
                    headroom=self._calib_headroom,
                    calib_fingerprint=fingerprint,
                    fast_decode=bool(self._fast_decode), crop=self.crop,
                    n_crops=self.n_crops), f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass  # read-only checkpoint dir: recalibrate next run

    def _build_int8(self, images_u8):
        """Calibrate (calib_dir > valid cache > this first batch, a uint8
        numpy array) and build the int8 forward."""
        from ..models.quant import build_int8_apply

        fingerprint = (self._calib_dir_fingerprint() if self._calib_dir
                       else None)
        path = self._int8_scales_path
        scales = prov = None
        n_images = 0
        if path and os.path.exists(path) and not self._int8_recalibrate:
            scales, prov = self._read_cache(path, fingerprint)
        if scales is not None:
            source, stat_used = "cache", prov.get("stat")
        elif self._calib_dir:
            batches, n_images = self._calib_dir_batches()
            scales, stat_used = self._calibrate_batches(batches)
            source = "calib_dir"
        else:
            arr = np.asarray(images_u8)
            # distinct images over the leading axis: a host-cropped image is
            # one image however many crops it has
            n_images = len({im.tobytes() for im in arr})
            n_crops = self.n_crops
            if arr.ndim == 5:
                arr, n_crops = arr.reshape((-1,) + arr.shape[-3:]), 1
            scales, stat_used = self._calibrate_batches([arr], n_crops)
            source = "first_batch"
        if (path and source != "cache" and self._int8_persist
                and (source == "calib_dir"
                     or n_images >= self.MIN_DISTINCT_FOR_PERSIST)):
            self._write_cache(path, scales, source, n_images, stat_used,
                              fingerprint)
        self.int8_calib_source = source
        self.int8_calib_stat = stat_used
        self.int8_scales = scales
        feature_tta = ({"crop": self.crop, "n_crops": self.n_crops,
                        "level": self._feature_tta_level}
                       if self.tta_mode == "feature" else None)
        self._int8_nets = [build_int8_apply(
            self._qnet, scales, n_classes=self._n_classes,
            feature_tta=feature_tta, device=d) for d in self.devices]
        self._int8_apply = self._int8_nets[0]

    @torch.inference_mode()
    def crop_logits(self, images_u8, replica=0):
        """uint8 (B, base, base, 3) tensor on the device of `replica` (the
        engine's device by default), or host crops (B, n_crops, crop, crop,
        3) -> list of per-head (B * n_crops, C) float32 logits. An int8
        engine calibrates on these images if it has not yet."""
        feature = self.tta_mode == "feature"
        if self._int8:
            if self._int8_apply is None:
                with span("engine.calibrate"):
                    self._build_int8(images_u8.cpu().numpy())
            if feature:
                # the base image: the crops are taken at a feature map
                x = shift_s8(images_u8)
            elif images_u8.ndim == 5:
                x = shift_s8(images_u8.reshape((-1,) + images_u8.shape[-3:]))
            else:
                x = eval_pipeline_s8(images_u8, n_crops=self.n_crops,
                                     crop=self.crop)
            return self._int8_nets[replica](x.contiguous())
        if feature:
            return self._nets[replica](normalize(images_u8, torch.bfloat16))
        if images_u8.ndim == 5:
            # host-precropped: normalize only, crops folded into the batch
            x = normalize(images_u8.reshape((-1,) + images_u8.shape[-3:]),
                          self.dtype)
        else:
            x = eval_pipeline(images_u8, n_crops=self.n_crops,
                              crop=self.crop, dtype=self.dtype)
        return self._nets[replica](x)

    @torch.inference_mode()
    def _forward(self, images_u8, replica=0):
        with span("models.forward", device=True):
            logits = [mean_tta_logits(l, self.n_crops, fold=self.tta_fold)
                      for l in self.crop_logits(images_u8, replica)]
            return self._pack(predict_all(logits, self._harrays[replica]))

    @staticmethod
    def _pack(preds):
        """{p_key: (cls, lat, lng)} -> one (K, 3, B) float32 tensor (keys
        sorted), so the results come back in one transfer. Class indices
        are exact in float32 (< 2^24)."""
        return torch.stack([
            torch.stack([preds[k][0].float(), preds[k][1].float(),
                         preds[k][2].float()])
            for k in sorted(preds)
        ])

    @property
    def pred_keys(self):
        """Sorted p_keys matching `_pack`'s leading axis."""
        return sorted([p.name for p in self.partitionings] + ["hierarchy"])

    def predict_batch(self, images_u8: np.ndarray):
        """uint8 (B, base, base, 3), or (B, 10, crop, crop, 3) host crops
        -> {p_key: (cls, lat, lng)} numpy."""
        images_u8 = np.asarray(images_u8)
        self._calls += 1
        with span("engine.predict_batch", request=self._calls):
            if self._int8 and self._int8_apply is None:
                with span("engine.calibrate"):
                    self._build_int8(images_u8)
            count("engine.upload_bytes", images_u8.nbytes)
            if self.layout is None:
                with span("engine.upload", device=True):
                    x = torch.as_tensor(images_u8).to(self.device)
                flat = self._forward(x)
                with span("engine.wait"):
                    flat = flat.cpu().numpy()
            else:
                from ..parallel.mesh import shard_batch_arrays

                # every part is launched before the first transfer waits
                with span("engine.upload", device=True):
                    xs = shard_batch_arrays(self.layout, images_u8)
                parts = [self._forward(x, r) for r, x in enumerate(xs)]
                with span("engine.wait"):
                    flat = torch.cat([p.cpu() for p in parts], dim=-1).numpy()
            return {
                k: (flat[i, 0].astype(np.int64), flat[i, 1], flat[i, 2])
                for i, k in enumerate(self.pred_keys)
            }

    # -- folder-level entry points --------------------------------------------

    def predict_dir(self, image_dir: str, batch_size: int = 64,
                    num_workers: Optional[int] = None, process_slice=None):
        """Reference inference.py output contract (README.md:118-124): a
        pandas DataFrame of (img_id, p_key, pred_class, pred_lat, pred_lng)
        rows.

        process_slice=(p, n): multi-process eval -- this process handles
        sorted(files)[p::n] only (parallel/multihost.py)."""
        import pandas as pd

        from ..data.image_folder import iter_image_folder

        rows = []
        for batch in iter_image_folder(
            image_dir, batch_size=batch_size, num_workers=num_workers,
            tencrop_host=(self.tta_mode == "host_exact"), crop=self.crop,
            fast_decode=self._fast_decode, process_slice=process_slice,
        ):
            preds = self.predict_batch(batch.images)
            for key, (cls, lat, lng) in preds.items():
                for i, img_id in enumerate(batch.ids):
                    if not batch.valid[i]:
                        continue
                    rows.append((img_id, key, int(cls[i]), float(lat[i]),
                                 float(lng[i])))
        df = pd.DataFrame(
            rows,
            columns=["img_id", "p_key", "pred_class", "pred_lat", "pred_lng"],
        )
        return df.sort_values(["img_id", "p_key"]).reset_index(drop=True)

    def evaluate_dir(self, image_dir: str, meta, batch_size: int = 64,
                     thresholds_km=DEFAULT_THRESHOLDS_KM,
                     num_workers: Optional[int] = None,
                     process_slice=None) -> dict:
        """Reference test.py behavior: GCD threshold accuracies per p_key
        against a meta DataFrame (IMG_ID, LAT, LON).

        process_slice=(p, n): multi-process eval -- this process scores
        sorted(files)[p::n], then every process merges its count-based
        accumulators (one all-reduce at the end), so the returned table
        covers the FULL directory on every process."""
        from ..data.image_folder import iter_image_folder

        gt = {
            str(r.IMG_ID): (float(r.LAT), float(r.LON))
            for r in meta.itertuples()
        }
        # one accumulator per pred key up front: every process brings the
        # same key set to the merge, one with an empty file slice too
        accs = {k: GcdAccumulator(thresholds_km) for k in self.pred_keys}
        n_missing = 0
        for batch in iter_image_folder(
            image_dir, batch_size=batch_size, num_workers=num_workers,
            tencrop_host=(self.tta_mode == "host_exact"), crop=self.crop,
            fast_decode=self._fast_decode, process_slice=process_slice,
        ):
            true_lat = np.zeros(len(batch.ids), np.float32)
            true_lng = np.zeros(len(batch.ids), np.float32)
            valid = np.array(batch.valid, copy=True)
            for i, img_id in enumerate(batch.ids):
                key = img_id
                if key not in gt:
                    key = os.path.splitext(img_id)[0]
                if key in gt:
                    true_lat[i], true_lng[i] = gt[key]
                else:
                    if valid[i]:
                        n_missing += 1
                    valid[i] = False
            preds = self.predict_batch(batch.images)
            for p_key, (cls, plat, plng) in preds.items():
                counts, total = gcd_threshold_counts(
                    plat, plng, true_lat, true_lng, thresholds_km,
                    valid=valid)
                accs[p_key].update(counts, total)
        if process_slice is not None and process_slice[1] > 1:
            from ..parallel.multihost import merge_gcd_accumulators

            n_missing = merge_gcd_accumulators(accs, n_missing)
        result = {k: a.result() for k, a in accs.items()}
        if n_missing:
            result["_n_images_without_meta"] = n_missing
        return result


def format_accuracy_table(results: dict, dataset_name: str = "") -> str:
    """Render the README-style accuracy table (reference README.md:169-187)."""
    keys = [k for k in results if not k.startswith("_")]
    order = [k for k in ("coarse", "middle", "fine", "hierarchy") if k in keys]
    order += [k for k in keys if k not in order]
    lines = []
    if dataset_name:
        lines.append(f"== {dataset_name}")
    header = None
    for key in order:
        accs = results[key]
        if header is None:
            ths = list(accs)
            header = "p_key".ljust(12) + "".join(
                f"{int(t)} km".rjust(10) for t in ths
            )
            lines.append(header)
        lines.append(
            key.ljust(12)
            + "".join(f"{100 * v:10.1f}" for v in accs.values())
        )
    return "\n".join(lines)
