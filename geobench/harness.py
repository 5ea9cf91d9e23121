"""What every cell shares: finding its files by name, the seeded weights and
photos, the check against the reference, and the result line."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BANNED_MODULES = ("jax", "jaxlib", "flax", "geoestimation_tpu")


def _json(kind, name):
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"geobench: no {kind[:-1]} {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_cell(name):
    """The cell's file, with its configuration and traffic mix merged in
    under "config" and "traffic"."""
    cell = _json("cells", name)
    cell["name"] = name
    cell["config"] = dict(_json("configs", cell["config"]),
                          name=cell["config"])
    cell["traffic"] = dict(_json("traffic", cell["traffic"]),
                           name=cell["traffic"])
    return cell


def load_benchmark(root="."):
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise SystemExit(f"geobench: no BENCHMARK.json in {Path(root).resolve()}")
    with open(path) as f:
        return json.load(f)


def load_module(kind, name):
    """geobench/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"geobench: no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"geobench.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench, cell):
    """(end-to-end metrics, per-layer metrics) that `cell` reports: those
    whose `workloads` list it, or that have no such list and move (or are)
    an end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return e2e, per_layer


def banned_modules():
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (`geoestimation_tpu_torch` is the port, not the JAX
    package)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED_MODULES))


# -- seeded inputs ----------------------------------------------------------------

def state_dict_leaves(arch, n_classes, stage_sizes, feature_dim=2048):
    """[(key, shape, draw, a, b)] of the classifier's state dict in the
    port's torchvision layout: `draw` is "normal" (a * N(0, 1) + b) or
    "uniform" (U(a, b)). He-normal convolutions; BatchNorm scale U(0.5, 1)
    (the residual's last, bn3, U(0.1, 0.3), so that deep stacks stay in
    range), bias and mean 0.1 N(0, 1), variance U(0.5, 1.5); the fused
    head's weight N(0, 1 / features), bias 0.1 N(0, 1)."""
    leaves = []

    def conv(name, cout, cin, k):
        leaves.append((f"{name}.weight", (cout, cin, k, k), "normal",
                       (2.0 / (k * k * cin)) ** 0.5, 0.0))

    def bn(name, c, lo=0.5, hi=1.0):
        leaves.extend([(f"{name}.weight", (c,), "uniform", lo, hi),
                       (f"{name}.bias", (c,), "normal", 0.1, 0.0),
                       (f"{name}.running_mean", (c,), "normal", 0.1, 0.0),
                       (f"{name}.running_var", (c,), "uniform", 0.5, 1.5)])

    conv("backbone.conv1", 64, 3, 7)
    bn("backbone.bn1", 64)
    cin = 64
    for stage, n_blocks in enumerate(stage_sizes):
        mid = 64 * 2 ** stage
        for b in range(n_blocks):
            p = f"backbone.layer{stage + 1}.{b}"
            conv(f"{p}.conv1", mid, cin, 1)
            bn(f"{p}.bn1", mid)
            conv(f"{p}.conv2", mid, mid, 3)
            bn(f"{p}.bn2", mid)
            conv(f"{p}.conv3", 4 * mid, mid, 1)
            bn(f"{p}.bn3", 4 * mid, 0.1, 0.3)
            if b == 0:
                conv(f"{p}.downsample.0", 4 * mid, cin, 1)
                bn(f"{p}.downsample.1", 4 * mid)
            cin = 4 * mid
    total = sum(n_classes)
    leaves.append(("heads.fused_head.weight", (total, feature_dim), "normal",
                   feature_dim ** -0.5, 0.0))
    leaves.append(("heads.fused_head.bias", (total,), "normal", 0.1, 0.0))
    return leaves


def make_state_dict(config, seed, device):
    """The classifier's float32 state dict, made on `device` from `seed` in
    two draws (every normal leaf from one, every uniform leaf from the
    other), with the port's `num_batches_tracked` counters."""
    import math

    import torch

    leaves = state_dict_leaves(config["arch"], config["class_counts"],
                               config["stage_sizes"], config["feature_dim"])
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(math.prod(s) for _, s, k, _, _ in leaves if k == kind)
             for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device)}
    offsets = {"normal": 0, "uniform": 0}
    sd = {}
    for key, shape, kind, a, b in leaves:
        n = math.prod(shape)
        x = pools[kind][offsets[kind]:offsets[kind] + n].view(shape)
        offsets[kind] += n
        sd[key] = x * a + b if kind == "normal" else a + (b - a) * x
        if key.endswith("running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.int64, device=device)
    return sd


def make_partitionings(config, seed):
    """The nested S2 partitionings at the configuration's class counts,
    from `seed` (the frozen generator): [(name, tokens, lat, lng)]."""
    import numpy as np

    from .frozen.world import seeded_partitionings

    return seeded_partitionings(np.random.default_rng([seed, 1]),
                                tuple(config["class_counts"]))


def make_photos(n, size, seed, device):
    """n seeded uint8 photos of `size` (a side, or (height, width)) made on
    `device` (smooth color fields of four octaves, a luminance ramp and
    pixel noise, the statistics of `frozen.world.textured_image`), as a
    host numpy array (n, height, width, 3)."""
    import torch
    import torch.nn.functional as F

    h, w = (size, size) if isinstance(size, int) else size
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.full((n, 3, h, w), 120.0, device=device)
    for g, amp in ((4, 55.0), (8, 30.0), (16, 18.0), (48, 10.0)):
        grid = torch.randn((n, 3, g, g), generator=gen, device=device) * amp
        x += F.interpolate(grid, size=(h, w), mode="bilinear",
                           align_corners=False)
    tilt = (torch.rand((n, 2, 1, 1), generator=gen, device=device) - 0.5) * 80
    x += (tilt[:, :1] * torch.linspace(-0.5, 0.5, h, device=device).view(
        1, 1, -1, 1) + tilt[:, 1:] * torch.linspace(
            -0.5, 0.5, w, device=device).view(1, 1, 1, -1))
    x += torch.randn(x.shape, generator=gen, device=device) * 5.0
    x = x.clamp(0, 255).round().to(torch.uint8)
    return x.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def encode_jpegs(photos, qualities, threads=8):
    """JPEG bytes of each uint8 (H, W, 3) photo at its quality (Pillow, in
    threads: its encoder releases the GIL)."""
    import concurrent.futures as cf
    import io

    from PIL import Image

    def one(i):
        buf = io.BytesIO()
        Image.fromarray(photos[i]).save(buf, format="JPEG",
                                        quality=int(qualities[i]))
        return buf.getvalue()

    with cf.ThreadPoolExecutor(threads) as ex:
        return list(ex.map(one, range(len(photos))))


# -- the port ----------------------------------------------------------------------

def port_partitionings(parts):
    """The benchmark's partitionings as the port's `Partitioning` objects."""
    import numpy as np

    from geoestimation_tpu_torch.geo import Partitioning

    return [Partitioning(name=name, tokens=tokens, lat=lat, lng=lng,
                         counts=np.zeros(len(tokens), np.int64))
            for name, tokens, lat, lng in parts]


def build_engine(cell, sd, parts, device):
    """The port's `InferenceEngine` on the cell's serving path."""
    from geoestimation_tpu_torch.eval.engine import InferenceEngine
    from geoestimation_tpu_torch.utils.config import Config

    cfg = cell["config"]
    config = Config()
    config.model_params.arch = cfg["arch"]
    config.model_params.partitionings.shortnames = [p[0] for p in parts]
    return InferenceEngine(config, sd, partitionings=port_partitionings(parts),
                           n_crops=cfg["n_crops"], crop=cfg["crop"],
                           device=device, **cell["engine"])


# -- the check ---------------------------------------------------------------------

def _reference_scores(cell, sd, parts, images_u8, device, quant, block):
    """(first image, {p_key: scores}) of the reference (rounded by `quant`
    where given) over `images_u8`, `block` images at a time."""
    import numpy as np
    import torch

    from .reference import geo, model

    cfg = cell["config"]
    model.no_tf32()
    maps, valid = geo.ancestor_maps(parts)
    for i in range(0, len(images_u8), block):
        x = torch.as_tensor(np.ascontiguousarray(images_u8[i:i + block]),
                            device=device)
        logits = model.crop_logits(x, sd, cfg["arch"], quant=quant,
                                   crop=cfg["crop"])
        yield i, geo.scores(logits, parts, maps, valid, cfg["n_crops"])


def judge_answers(cell, sd, parts, images_u8, answers, device, block=32):
    """The readings of the program's answers for `images_u8` against the
    float32 reference: {"max_gap", "mean_gap", "disagree_share",
    "coords_off", "classes_out_of_range"} (`reference.geo.judge`)."""
    import numpy as np

    from .reference import geo

    total = {}
    for i, ref in _reference_scores(cell, sd, parts, images_u8, device, None,
                                    block):
        part = {k: tuple(np.asarray(a)[i:i + block] for a in v)
                for k, v in answers.items()}
        for k, v in geo.judge(part, ref, parts).items():
            total[k] = max(total.get(k, v), v) if k == "max_gap" \
                else total.get(k, 0) + v
    n = max(1, total.get("answers", 0))
    return {"max_gap": total.get("max_gap", float("inf")),
            "mean_gap": total.get("gap_sum", 0.0) / n,
            "disagree_share": total.get("disagree", 0) / n,
            "coords_off": total.get("coords_off", 0),
            "classes_out_of_range": total.get("classes_out_of_range", 0)}


def control_answers(cell, sd, parts, images_u8, device, quant, block=32):
    """The answers of the reference rounded by `quant` (the control in the
    program's place): {p_key: (cls, lat, lng)} numpy."""
    import numpy as np

    from .reference import geo

    coords = geo.centers(parts)
    out = {}
    for _, ref in _reference_scores(cell, sd, parts, images_u8, device, quant,
                                    block):
        for key, s in ref.items():
            cls = s.argmax(dim=1).cpu().numpy()
            lat, lng = coords[key]
            out.setdefault(key, []).append((cls, lat[cls], lng[cls]))
    return {k: tuple(np.concatenate(c) for c in zip(*v))
            for k, v in out.items()}


def checks(cell, readings, missing):
    """[(name, value, limit)] of the numbers compared: the readings that
    the cell sets a limit on, then the answers that must be exact (0 off,
    0 out of range, 0 missing). Each passes at or under its limit."""
    return ([(name, readings[name], limit)
             for name, limit in cell["limits"].items()]
            + [("coords_off", readings["coords_off"], 0),
               ("classes_out_of_range", readings["classes_out_of_range"], 0),
               ("answers_missing", missing, 0)])


# -- the result line ---------------------------------------------------------------

def device_info(device, count, memory_peak_bytes, trace=None):
    """The result line's `device`: the card's name, the cards used, the
    peak of the fullest, and with a trace its busy and traced seconds."""
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu"),
            "count": count, "memory_peak_bytes": memory_peak_bytes}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def emit(result, compared):
    """The numbers compared, each beside its limit, as the last lines on
    standard error; then the result as the last line of standard output,
    the numbers compared under "checks", last."""
    for name, value, limit in compared:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in compared}
    print(json.dumps(result), flush=True)
