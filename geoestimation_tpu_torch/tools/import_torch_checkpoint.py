"""Import a reference PyTorch Lightning checkpoint into a port checkpoint.

The counterpart of `tools/import_torch_checkpoint.py`, writing the port's
checkpoint directory instead of an orbax one. The reference shipped a
Lightning `.ckpt` (+ hparams.yaml) of a torchvision ResNet with one Linear
head per partitioning; users migrating from it load such files here and
evaluate or serve them at parity (with `--exact_tta` for the reference's
ten-crop geometry).

Handles: the Lightning wrapper (`state_dict`), the `model.` / `module.` /
`net.` / `backbone.` prefixes, BatchNorm running statistics, and any naming
of the per-partitioning Linear heads: they are matched by output size
against the partitionings' class counts, in encounter order, and
concatenated into `heads.fused_head`. The output directory holds
`hparams.yaml` (the arch and the absolute cell files) and `state_dict.pt`
under the keys `convert.from_jax_variables` gives.

Usage:
  python -m geoestimation_tpu_torch.tools.import_torch_checkpoint \\
      --torch_ckpt epoch=014-val_loss=18.4833.ckpt \\
      --cell_files cells_50_5000.csv cells_50_2000.csv cells_50_1000.csv \\
      --output models/base_M_imported [--arch resnet50]

The `.ckpt` is unpickled (`torch.load(weights_only=False)`, as Lightning
files hold more than tensors): load only files you trust.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..checkpoint import save_checkpoint
from ..geo import load_partitionings
from ..models.resnet import STAGE_SIZES
from ..utils.config import Config

PREFIXES = ("model.", "module.", "net.", "backbone.")


def load_torch_state_dict(path):
    """The tensors of a `.ckpt` (Lightning wrapper or a bare state dict)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k: v.detach().cpu() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def strip_prefixes(sd):
    """Remove the common wrappers, nested in any order."""
    def strip(k):
        for p in PREFIXES:
            if k.startswith(p):
                return strip(k[len(p):])
        return k

    return {strip(k): v for k, v in sd.items()}


def convert_backbone(sd, arch):
    """torchvision resnet keys -> the port's `backbone.` keys, float32, with
    `num_batches_tracked` reset as the weights bridge sets it."""
    out = {}

    def copy(src, dst):
        out[f"backbone.{dst}"] = sd[src].to(torch.float32).clone()

    def conv(name):
        copy(f"{name}.weight", f"{name}.weight")

    def bn(name):
        for field in ("weight", "bias", "running_mean", "running_var"):
            copy(f"{name}.{field}", f"{name}.{field}")
        out[f"backbone.{name}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1")
    bn("bn1")
    for stage, n_blocks in enumerate(STAGE_SIZES[arch]):
        for b in range(n_blocks):
            blk = f"layer{stage + 1}.{b}"
            for i in (1, 2, 3):
                conv(f"{blk}.conv{i}")
                bn(f"{blk}.bn{i}")
            if f"{blk}.downsample.0.weight" in sd:
                conv(f"{blk}.downsample.0")
                bn(f"{blk}.downsample.1")
    return out


def find_heads(sd, n_classes):
    """The per-partitioning Linear heads, matched by output size in the
    order of `n_classes` (encounter order among equal sizes) ->
    (weight (sum, feat), bias (sum,)) of the fused head."""
    candidates = {}
    for k, v in sd.items():
        if k.endswith(".weight") and v.ndim == 2:
            base = k[:-len(".weight")]
            candidates.setdefault(v.shape[0], []).append(
                (v, sd.get(base + ".bias")))
    weights, biases = [], []
    for n in n_classes:
        if not candidates.get(n):
            shapes = sorted({tuple(v.shape) for vs in candidates.values()
                             for v, _ in vs})
            raise KeyError(f"no Linear head with {n} outputs in checkpoint; "
                           f"2D weight shapes present: {shapes}")
        w, b = candidates[n].pop(0)
        weights.append(w.to(torch.float32))
        biases.append(torch.zeros(n) if b is None else b.to(torch.float32))
    return torch.cat(weights), torch.cat(biases)


def convert(sd, arch, n_classes):
    """A stripped torchvision state dict -> the port's state dict."""
    out = convert_backbone(sd, arch)
    out["heads.fused_head.weight"], out["heads.fused_head.bias"] = \
        find_heads(sd, n_classes)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Lightning .ckpt -> port checkpoint directory")
    p.add_argument("--torch_ckpt", required=True)
    p.add_argument("--cell_files", nargs="+", required=True,
                   help="partitioning CSVs, coarse -> fine")
    p.add_argument("--output", required=True,
                   help="port checkpoint directory to write")
    p.add_argument("--arch", default="resnet50", choices=list(STAGE_SIZES))
    args = p.parse_args(argv)

    parts = load_partitionings(args.cell_files)
    n_classes = [len(pt) for pt in parts]
    print(f"partitionings: {[pt.name for pt in parts]} -> {n_classes}")
    sd = convert(strip_prefixes(load_torch_state_dict(args.torch_ckpt)),
                 args.arch, n_classes)
    print(f"tensors: {len(sd)}; fused head: "
          f"{tuple(sd['heads.fused_head.weight'].shape)}")
    config = Config()
    config.model_params.arch = args.arch
    config.model_params.partitionings.files = [
        os.path.abspath(f) for f in args.cell_files]
    save_checkpoint(args.output, sd, config)
    print(f"wrote port checkpoint to {args.output}")


if __name__ == "__main__":
    main()
