"""The float32 teacher of the int8 path: what `--calib_stat auto` needs of
`geoestimation_tpu/models/qat.py`.

  * `fold_variables`: the BN-folded float32 network (ImageNet normalization
    folded into the stem, which takes (pixel - 128) inputs), from the port's
    state dict -- the same fold as `quant.quantize_model`, before rounding;
  * `build_qat_apply(..., fake_quant=False)`: that network's forward, with
    the int8 path's structure (explicit stem border pad, relu at the lo=0
    sites, the stage-entry conv3 un-clipped) and float32 heads;
  * `teacher_student_kl`: the summed per-head KL(teacher || student), the
    parity proxy `quant.autoselect_scales` scores candidates by.

Quantization-aware training itself (`fake_quant=True`, the STE
fake-quant, the train step and export) is not ported yet (ROADMAP.md
Queue 1 item 10).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ingest.decode import IMAGENET_MEAN
from .quant import (_folded_blocks, _folded_conv, _oihw, _stem_fold,
                    folded_trunk)
from .resnet import BN_EPSILON


def teacher_student_kl(t_logits, s_logits):
    """Sum over heads of the batch-mean KL(teacher || student)."""
    kl = 0.0
    for t, s in zip(t_logits, s_logits):
        t, s = t.float(), s.float()
        p = torch.softmax(t, dim=-1)
        kl = kl + torch.mean(torch.sum(
            p * (torch.log_softmax(t, dim=-1) - torch.log_softmax(s, dim=-1)),
            dim=-1))
    return kl


def fold_variables(state_dict, arch="resnet50", eps=BN_EPSILON,
                   device="cpu"):
    """The port's state dict -> the folded float32 network on `device`:
    {"stem": (kernel, bias), "blocks": [(name, stride, {conv: (kernel,
    bias)})], "heads": {"fused_head": {"kernel", "bias"}}}, the convs laid
    out as `quant._oihw` does and the head kernel (in, out)."""
    device = torch.device(device)
    if any(k.startswith("scene") for k in state_dict):
        raise NotImplementedError(
            "ISN checkpoints are not ported yet (ROADMAP.md Queue 1 item 8, "
            "'ISN')")
    wp, bpp, _ = _stem_fold(state_dict, eps)
    w = state_dict["heads.fused_head.weight"]
    heads = {"fused_head": {
        "kernel": w.detach().to(device, torch.float32).t(),
        "bias": state_dict["heads.fused_head.bias"].detach().to(
            device, torch.float32)}}
    return {"stem": _oihw(wp, bpp, device),
            "blocks": _folded_blocks(state_dict, arch, eps, device),
            "heads": heads}


def build_qat_apply(arch, act_scales, n_classes=None, fake_quant=True):
    """Returns `apply(folded, x) -> [per-head float32 logits]` for x the
    (B, H, W, 3) float32 (pixel - 128) crops.

    Only `fake_quant=False` is ported: the folded float32 forward of the
    original network (the teacher of `quant.autoselect_scales`), with the
    stem's borders padded with the exact dataset mean, then the calibration
    traversal's trunk (`quant.folded_trunk`: relu at the lo=0 requant
    sites, the stage-entry conv3 un-clipped), and float32 heads.
    `act_scales` and `arch` (carried by `folded`) are unused then, as
    `act_scales` is in the JAX package."""
    if fake_quant:
        raise NotImplementedError(
            "quantization-aware training (fake_quant) is not ported yet "
            "(ROADMAP.md Queue 1 item 10, 'QAT and distillation')")

    @torch.inference_mode()
    def apply(folded, x):
        # the teacher pads with the exact (unquantized) dataset mean: the
        # original model's zero in the normalized domain
        pad_val = torch.tensor(np.asarray(IMAGENET_MEAN, np.float32) * 255.0
                               - 128.0, device=x.device)
        xp = F.pad((x - pad_val).permute(0, 3, 1, 2), (3, 3, 3, 3)) \
            + pad_val[:, None, None]
        y = torch.relu(_folded_conv(xp, folded["stem"], 2))
        feats = folded_trunk(y, folded["blocks"]).mean(dim=(2, 3))
        head = folded["heads"]["fused_head"]
        logits = feats @ head["kernel"] + head["bias"]
        if n_classes is None:
            return logits
        return list(torch.split(logits, tuple(n_classes), dim=-1))

    return apply
