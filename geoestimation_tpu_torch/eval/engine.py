"""Batched inference engine: images -> per-partitioning + f* predictions.

The port of `geoestimation_tpu/eval/engine.py` (device TTA and host-exact
ten-crop). One forward takes the uint8 host batch to the device, normalizes
and crops it there (or only normalizes the host's exact ten-crops),
runs the classifier -- the module path, or the BN-folded fast path with the
fused CUDA bottleneck kernel -- folds the crops, applies the f* rule, and
returns predicted classes and coordinates for every partitioning key plus
'hierarchy' in one small transfer.

Runs on CUDA unless `device="cpu"` is asked for; there is no fallback from
one to the other.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..geo import Hierarchy, load_partitionings
from ..ingest.pipeline import eval_pipeline, normalize
from ..models.classifier import MultiPartitioningClassifier
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


def _not_ported(what, item):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1, {item!r})")


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
        int8: bool = False,
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
        from a 256 square on the device) or 'host_exact' (torchvision-exact
        host ten-crop of the full resized rectangle, for parity on
        non-square images; forces n_crops=10). tta_fold: how per-crop
        logits combine (eval.infer.mean_tta_logits). fast_decode: scaled
        DCT JPEG decode on the host. device: 'cuda' (default) or 'cpu'.
        """
        if int8:
            _not_ported("int8 serving", "int8 serving path")
        if layout is not None:
            _not_ported("sharded eval (layout)", "Training")
        if tta_mode == "feature":
            _not_ported("tta_mode='feature'", "TTA variants")
        if tta_mode not in ("device", "host_exact"):
            raise ValueError(f"unknown tta_mode {tta_mode!r}")
        if tta_mode == "host_exact":
            n_crops = 10
        if tta_fold not in TTA_FOLDS:
            raise ValueError(
                f"unknown tta_fold {tta_fold!r}; have {TTA_FOLDS}")
        mp = config.model_params
        if mp.scene_gating:
            _not_ported("ISN (scene_gating)", "ISN")
        self.device = resolve_device(device)
        if partitionings is None:
            paths = resolve_partitioning_paths(mp.partitionings.files,
                                               search_dirs)
            partitionings = load_partitionings(
                paths, names=list(mp.partitionings.shortnames))
        self.partitionings = partitionings
        self.hierarchy = Hierarchy.build(partitionings)
        self.harrays = HierarchyArrays.from_hierarchy(self.hierarchy,
                                                      self.device)
        self.n_crops = n_crops
        self.crop = crop
        self.dtype = dtype
        self.tta_mode = tta_mode
        self.tta_fold = tta_fold
        self._fast_decode = fast_decode
        n_classes = tuple(len(p) for p in partitionings)
        self.model = None
        self._fast_apply = None
        if fast:
            # The fold computes in bf16; refuse a float32 request instead of
            # returning bf16 results labeled fp32.
            if dtype != torch.bfloat16:
                raise ValueError(
                    "--fast folds BatchNorm into bf16 conv weights; "
                    "--precision 32 is not available in this mode "
                    "(use --precision 16, or drop --fast)")
            from ..models.fast_infer import build_fast_apply

            self._fast_apply = build_fast_apply(
                state_dict, mp.arch, n_classes=n_classes,
                use_pallas=use_pallas, use_pallas_s2=use_pallas_s2,
                device=self.device)
        else:
            with torch.device("meta"):
                model = MultiPartitioningClassifier(n_classes, mp.arch, dtype)
            model.load_state_dict(state_dict, strict=True, assign=True)
            self.model = model.to(
                self.device, memory_format=torch.channels_last).eval()

    @torch.inference_mode()
    def crop_logits(self, images_u8):
        """uint8 (B, base, base, 3) tensor on the engine's device, or host
        crops (B, n_crops, crop, crop, 3) -> list of per-head
        (B * n_crops, C) float32 logits."""
        if images_u8.ndim == 5:
            # host-precropped: normalize only, crops folded into the batch
            x = normalize(images_u8.reshape((-1,) + images_u8.shape[-3:]),
                          self.dtype)
        else:
            x = eval_pipeline(images_u8, n_crops=self.n_crops,
                              crop=self.crop, dtype=self.dtype)
        if self._fast_apply is not None:
            return self._fast_apply(x)
        return self.model(x)

    @torch.inference_mode()
    def _forward(self, images_u8):
        logits = [mean_tta_logits(l, self.n_crops, fold=self.tta_fold)
                  for l in self.crop_logits(images_u8)]
        return self._pack(predict_all(logits, self.harrays))

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
        images = torch.as_tensor(np.asarray(images_u8)).to(self.device)
        flat = self._forward(images).cpu().numpy()
        return {
            k: (flat[i, 0].astype(np.int64), flat[i, 1], flat[i, 2])
            for i, k in enumerate(self.pred_keys)
        }

    # -- folder-level entry points --------------------------------------------

    def predict_dir(self, image_dir: str, batch_size: int = 64,
                    num_workers: Optional[int] = None, process_slice=None):
        """Reference inference.py output contract (README.md:118-124): a
        pandas DataFrame of (img_id, p_key, pred_class, pred_lat, pred_lng)
        rows."""
        import pandas as pd

        from ..data.image_folder import iter_image_folder

        if process_slice is not None:
            _not_ported("multi-process eval (process_slice)", "Training")
        rows = []
        for batch in iter_image_folder(
            image_dir, batch_size=batch_size, num_workers=num_workers,
            tencrop_host=(self.tta_mode == "host_exact"), crop=self.crop,
            fast_decode=self._fast_decode,
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
        against a meta DataFrame (IMG_ID, LAT, LON)."""
        from ..data.image_folder import iter_image_folder

        if process_slice is not None:
            _not_ported("multi-process eval (process_slice)", "Training")
        gt = {
            str(r.IMG_ID): (float(r.LAT), float(r.LON))
            for r in meta.itertuples()
        }
        accs = {k: GcdAccumulator(thresholds_km) for k in self.pred_keys}
        n_missing = 0
        for batch in iter_image_folder(
            image_dir, batch_size=batch_size, num_workers=num_workers,
            tencrop_host=(self.tta_mode == "host_exact"), crop=self.crop,
            fast_decode=self._fast_decode,
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
