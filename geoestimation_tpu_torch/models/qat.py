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
from .isn import route_rows
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
    out as `quant._oihw` does and the head kernels (in, out); an ISN
    checkpoint's heads are {"scene_head": ..., "scene_geo_heads": ...}."""
    device = torch.device(device)
    wp, bpp, _ = _stem_fold(state_dict, eps)

    def linear(name):
        return {"kernel": state_dict[f"{name}.weight"].detach().to(
                    device, torch.float32).t(),
                "bias": state_dict[f"{name}.bias"].detach().to(
                    device, torch.float32)}

    if "scene_head.weight" in state_dict:
        heads = {"scene_head": linear("scene_head"),
                 "scene_geo_heads": linear("scene_geo_heads")}
    else:
        heads = {"fused_head": linear("heads.fused_head")}
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
    sites, the stage-entry conv3 un-clipped), and float32 heads (an ISN
    checkpoint's routed by the scene argmax).
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
        heads = folded["heads"]
        if "scene_geo_heads" in heads:
            # ISN: each row routed to its predicted scene, as the int8
            # path serves it
            scene = heads["scene_head"]
            route = (feats @ scene["kernel"] + scene["bias"]).argmax(-1)
            geo = heads["scene_geo_heads"]
            flat = feats @ geo["kernel"] + geo["bias"]
            logits = route_rows(flat.reshape(flat.shape[0],
                                             scene["bias"].shape[0], -1),
                                route)
        else:
            head = heads["fused_head"]
            logits = feats @ head["kernel"] + head["bias"]
        if n_classes is None:
            return logits
        return list(torch.split(logits, tuple(n_classes), dim=-1))

    return apply
