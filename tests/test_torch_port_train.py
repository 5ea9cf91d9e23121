"""The port's training slice against the JAX package's: msgpack shards and
the batcher (bit for bit), the augmentation on the same draws, the losses,
schedules and optimizers, the train and eval steps (float32 and bf16, base
and ISN), the metrics CSV, and `train_base` end to end on the CPU."""

import io
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from PIL import Image

from geoestimation_tpu.data import loader as jax_loader
from geoestimation_tpu.data import shards as jax_shards
from geoestimation_tpu.ingest import pipeline as jax_pipeline
from geoestimation_tpu.models import MultiPartitioningClassifier as JaxClassifier
from geoestimation_tpu.models import classifier as jax_classifier
from geoestimation_tpu.models import isn as jax_isn
from geoestimation_tpu.train import optim as jax_optim
from geoestimation_tpu.train import step as jax_step
from geoestimation_tpu.utils import config as jax_config
from geoestimation_tpu.utils import logging as jax_logging
from geoestimation_tpu_torch.convert import from_jax_variables
from geoestimation_tpu_torch.data import loader, shards
from geoestimation_tpu_torch.geo import load_partitionings
from geoestimation_tpu_torch.ingest import pipeline
from geoestimation_tpu_torch.models import classifier, isn, resnet
from geoestimation_tpu_torch.models.isn import ISNClassifier
from geoestimation_tpu_torch.tools import world
from geoestimation_tpu_torch.ingest.decode import IMAGENET_MEAN, IMAGENET_STD
from geoestimation_tpu_torch.train import loop, optim, step
from geoestimation_tpu_torch.train.init import init_weights
from geoestimation_tpu_torch.utils import logging as port_logging
from geoestimation_tpu_torch.utils.config import load_config
from tests.torch_port_world import one_thread_no_tensorboard  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(8)
N_CLASSES = (3, 5, 9)
ARCH = "resnet14"
BATCH, SIZE, CROP = 8, 40, 32


def jpeg_bytes(rng, h, w):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
        buf, format="JPEG", quality=85)
    return buf.getvalue()


@pytest.fixture
def pil_both(monkeypatch):
    """Both packages decode through PIL, so both see the same pixels."""
    monkeypatch.setattr("geoestimation_tpu.ingest.native.available",
                        lambda: False)
    monkeypatch.setattr("geoestimation_tpu_torch.ingest.native.available",
                        lambda: False)


# -- shards and the batcher ------------------------------------------------------

@pytest.fixture(scope="module")
def shard_world(tmp_path_factory, geo_parts):
    """4 shards of 10 records, written once by each package, plus the
    partitionings for the port. Records 0-34 lie in the partitionings'
    patch, 35-38 far outside it, and the last has no coordinates."""
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(3)
    recs = []
    for i in range(40):
        r = {"id": f"r{i:02d}", "image": jpeg_bytes(rng, 48 + i % 3, 44)}
        if i < 35:
            r["lat"] = float(rng.uniform(47.6, 49.4))
            r["lng"] = float(rng.uniform(1.6, 3.4))
        elif i < 39:
            r["lat"], r["lng"] = -40.0 - i, 170.0
        recs.append(r)
    for s in range(4):
        jax_shards.write_shard(recs[10 * s:10 * s + 10],
                               str(root / "jax" / f"s{s}.msgpack"))
        shards.write_shard(recs[10 * s:10 * s + 10],
                           str(root / "port" / f"s{s}.msgpack"))
    paths = []
    for p in geo_parts:
        paths.append(str(root / f"{p.name}.csv"))
        p.to_csv(paths[-1])
    return {"root": root, "recs": recs,
            "jax": [str(root / "jax" / "*.msgpack")],
            "port": [str(root / "port" / "*.msgpack")],
            "parts": load_partitionings(paths, [p.name for p in geo_parts])}


def test_shards_are_byte_identical_and_cross_readable(shard_world):
    root, recs = shard_world["root"], shard_world["recs"]
    for s in range(4):
        a, b = (root / "jax" / f"s{s}.msgpack", root / "port" / f"s{s}.msgpack")
        assert a.read_bytes() == b.read_bytes()
        want = [shards.normalize_record(r) for r in recs[10 * s:10 * s + 10]]
        assert list(shards.iter_shard(str(a))) == want
        assert list(jax_shards.iter_shard(str(b))) == want


@pytest.mark.parametrize("shuffle, host", [(False, (0, 1)), (True, (0, 1)),
                                           (True, (1, 2))])
def test_record_order_and_index_match_jax(shard_world, shuffle, host):
    """Each package reads the other's files in the same order, for the same
    seed and host split; counts, byte-offset index and random access
    agree."""
    kw = dict(shuffle=shuffle, seed=3, shuffle_buffer=8, host_id=host[0],
              host_count=host[1])
    ref = [r["id"] for r in jax_shards.iter_records(shard_world["port"], **kw)]
    got = [r["id"] for r in shards.iter_records(shard_world["jax"], **kw)]
    assert got == ref and len(got) == 40 // host[1]
    for pat in ("jax", "port"):
        assert shards.count_records(shard_world[pat]) == \
            jax_shards.count_records(shard_world[pat]) == 40
        index = shards.build_index(shard_world[pat])
        assert index == jax_shards.build_index(shard_world[pat])
    source = shards.MsgpackDataSource(shard_world["jax"])
    for i in (0, 17, 39):
        assert source[i] == jax_shards.read_record_at(*index[i])
    source.close()


def test_load_label_csv_matches_jax(tmp_path):
    path = tmp_path / "labels.csv"
    pd.DataFrame({"IMG_ID": [f"r{i}" for i in range(6)],
                  "Coarse": [0, 1, 2, 0, 1, 2], "middle": range(6),
                  "fine": range(6, 12), "S3_Label": [0, 1, 2, 2, 1, 0]}
                 ).to_csv(path, index=False)
    names = ["coarse", "middle", "fine"]
    for with_scene in (False, True):
        ref = jax_loader.load_label_csv(str(path), names, with_scene)
        got = loader.load_label_csv(str(path), names, with_scene)
        if not with_scene:
            ref, got = (ref, None), (got, None)
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if g is not None:
                assert g.keys() == r.keys()
                for k in r:
                    np.testing.assert_array_equal(g[k], r[k])


@pytest.mark.parametrize("mode", ["global", "buffer"])
def test_shard_batcher_matches_jax(shard_world, geo_parts, mode, pil_both):
    """The same batches, bit for bit: ids, labels from lat/lng (records
    outside every cell dropped), uint8 images, coordinates, and the masked
    padding of the last batch."""
    kw = dict(batch_size=8, base_size=48, resize_to=48, shuffle=True, seed=5,
              repeat=False, num_workers=2, host_id=0, host_count=1,
              shuffle_mode=mode, mask_padding=True)
    ref = list(jax_loader.ShardBatcher(shard_world["jax"],
                                       partitionings=geo_parts, **kw))
    got = list(loader.ShardBatcher(shard_world["port"],
                                   partitionings=shard_world["parts"], **kw))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert g.ids == r.ids
        for field in ("images", "labels", "latlng", "scene"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(r, field))
    # the records outside every cell were dropped, the padding masked
    assert any((b.labels == -1).all(axis=0).any() for b in got)


# -- augmentation ------------------------------------------------------------------

def jax_crop_draws(key, b, h, w, crop):
    """`random_crop_flip`'s draws from its key, as torch tensors."""
    k1, k2, k3 = jax.random.split(key, 3)
    return {"size": crop,
            "tops": torch.tensor(np.asarray(
                jax.random.randint(k1, (b,), 0, h - crop + 1))),
            "lefts": torch.tensor(np.asarray(
                jax.random.randint(k2, (b,), 0, w - crop + 1))),
            "flips": torch.tensor(np.asarray(
                jax.random.bernoulli(k3, 0.5, (b,))))}


def test_random_crop_flip_bitwise_on_jax_draws():
    u8 = RNG.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    key = jax.random.fold_in(jax.random.PRNGKey(4), 3)
    ref = jax_pipeline.random_crop_flip(key, jnp.asarray(u8), crop=CROP)
    draws = jax_crop_draws(key, BATCH, SIZE, SIZE, CROP)
    assert draws["flips"].any() and not draws["flips"].all()
    got = pipeline.crop_flip(torch.from_numpy(u8), **draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


RESIZED_TOL = 0.02   # on the 0-255 scale: float32 sums of the same taps


@pytest.fixture(scope="module")
def resized_by_jax():
    """{size: (uint8 images, key, JAX output)} for each of the 8 sizes at
    base 256: keys searched until every size is drawn."""
    u8 = RNG.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    sizes = pipeline.resized_crop_sizes(256)
    fn = jax.jit(lambda k, x: jax_pipeline.random_resized_crop_flip(
        k, x, crop=224))
    out, i = {}, 0
    while len(out) < len(sizes):
        key = jax.random.PRNGKey(i)
        i += 1
        s = sizes[int(jax.random.randint(jax.random.split(key, 3)[0], (), 0,
                                         len(sizes)))]
        if s not in out:
            out[s] = (u8, key, np.asarray(fn(key, jnp.asarray(u8))))
    return out


@pytest.mark.parametrize("size", [207, 214, 221, 228, 235, 242, 249, 256])
def test_resized_crop_flip_matches_jax(resized_by_jax, size):
    """On JAX's own draws (the step's size, the offsets, the flips), within
    RESIZED_TOL of `jax.image.resize(..., "bilinear")`, antialiased when it
    downsamples."""
    assert pipeline.resized_crop_sizes(256) == \
        [207, 214, 221, 228, 235, 242, 249, 256]
    u8, key, ref = resized_by_jax[size]
    _, k_off, k_flip = jax.random.split(key, 3)
    off_u = np.asarray(jax.random.uniform(k_off, (2, 2)))
    tops = (off_u[:, 0] * np.float32(256 - size + 1)).astype(np.int64)
    lefts = (off_u[:, 1] * np.float32(256 - size + 1)).astype(np.int64)
    flips = np.asarray(jax.random.bernoulli(k_flip, 0.5, (2,)))
    got = pipeline.resized_crop_flip(
        torch.from_numpy(u8), size, torch.from_numpy(tops),
        torch.from_numpy(lefts), torch.from_numpy(flips), crop=224)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=RESIZED_TOL)


@pytest.mark.parametrize("crop_scale", [None, (0.66, 1.0)])
def test_draws_depend_on_seed_and_step_alone(crop_scale):
    """A resumed run draws at step k what an unbroken run draws there."""
    u8 = torch.from_numpy(RNG.integers(0, 256, (4, 64, 64, 3),
                                       dtype=np.uint8))
    run = [pipeline.train_pipeline(u8, 7, k, crop=48, dtype=torch.float32,
                                   crop_scale=crop_scale) for k in range(4)]
    resumed = pipeline.train_pipeline(u8, 7, 2, crop=48, dtype=torch.float32,
                                      crop_scale=crop_scale)
    torch.testing.assert_close(resumed, run[2], rtol=0, atol=0)
    assert not torch.equal(run[1], run[2])
    assert not torch.equal(run[2], pipeline.train_pipeline(
        u8, 8, 2, crop=48, dtype=torch.float32, crop_scale=crop_scale))


def test_normalize_constants_are_made_once():
    """`normalize` takes its mean and std from a cache per device, the
    float32 values it made on every call before, with the same bits out."""
    u8 = torch.from_numpy(RNG.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8))
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32) * 255.0
    for dtype in (torch.float32, torch.bfloat16):
        want = ((u8.to(torch.float32) - mean) / std).to(dtype)
        assert torch.equal(pipeline.normalize(u8, dtype), want)
    cpu = torch.device("cpu")
    assert pipeline._mean_std(cpu) is pipeline._mean_std(cpu)
    assert torch.equal(pipeline._mean_std(cpu)[0], mean)


@pytest.mark.parametrize("size", [207, 235, 256])
def test_triangle_weights_are_made_once_per_size(size):
    """A window size's weights come from the cache, the bits a fresh
    computation gives; the resize reads them there."""
    cpu = torch.device("cpu")
    w = pipeline._triangle_weights(size, 224, cpu)
    assert w is pipeline._triangle_weights(size, 224, cpu)
    fresh = pipeline._triangle_weights.__wrapped__(size, 224, cpu)
    assert w.dtype == torch.float32 and torch.equal(w, fresh)
    x = torch.from_numpy(RNG.random((1, size, size, 3), dtype=np.float32))
    assert torch.equal(pipeline.resize_bilinear(x, 224),
                       torch.einsum("bhwc,hH,wW->bHWc", x, fresh, fresh))


@pytest.mark.parametrize("crop_scale", [None, (0.66, 1.0)])
def test_packed_draws_augment_as_the_draws(crop_scale):
    """The draws packed into the one tensor a card's copy sends, and
    unpacked, augment to the bits of the draws themselves; JAX's int32
    offsets too."""
    u8 = torch.from_numpy(RNG.integers(0, 256, (8, 64, 64, 3),
                                       dtype=np.uint8))
    draws = pipeline.crop_draws(pipeline.step_generator(7, 3), 8, 64, 64, 48,
                                crop_scale)
    assert draws["flips"].any() and not draws["flips"].all()
    jdraws = jax_crop_draws(jax.random.PRNGKey(2), 8, 64, 64, 48)
    for d, scale in ((draws, crop_scale), (jdraws, None)):
        packed = pipeline._pack_draws(d)
        assert packed.shape == (3, 8) and packed.dtype == torch.int64
        got = pipeline.augment(u8, pipeline._unpack_draws(d["size"], packed),
                               48, scale)
        assert torch.equal(got, pipeline.augment(u8, d, 48, scale))
    assert pipeline._draws_on(draws, torch.device("cpu")) is draws


def test_host_feed_on_the_cpu_moves_arrays_as_they_are():
    """Off a card the feed is `torch.as_tensor(arr).to(device)`: the same
    dtype and values, no staging buffer kept."""
    feed = loop.HostFeed(torch.device("cpu"))
    latlng = RNG.normal(size=(6, 2))
    arrays = [RNG.integers(0, 256, (6, 16, 16, 3), dtype=np.uint8),
              RNG.integers(-1, 9, (3, 6)).astype(np.int32),
              latlng[:, 0], ~np.isnan(latlng[:, 1])]
    for arr in arrays:
        got = feed(arr)
        want = torch.as_tensor(arr)
        assert got.device.type == "cpu" and got.dtype == want.dtype
        assert torch.equal(got, want)
    assert feed._slots == {}


# -- losses, schedules, optimizers ---------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_losses_match_jax(smoothing):
    b = 6
    logits = [RNG.normal(0, 3, (b, n)).astype(np.float32) for n in N_CLASSES]
    labels = np.stack([RNG.integers(0, n, b) for n in N_CLASSES]).astype(
        np.int32)
    labels[0, 1] = labels[2, 4] = -1
    valid = RNG.random((3, b)) > 0.2
    for v in (None, valid):
        ref, ref_heads = jax_classifier.multi_head_cross_entropy(
            [jnp.asarray(l) for l in logits], jnp.asarray(labels),
            label_smoothing=smoothing, valid=None if v is None
            else jnp.asarray(v))
        got, got_heads = classifier.multi_head_cross_entropy(
            [torch.from_numpy(l) for l in logits], torch.from_numpy(labels),
            label_smoothing=smoothing,
            valid=None if v is None else torch.from_numpy(v))
        np.testing.assert_allclose(float(got), float(ref), rtol=0, atol=1e-6)
        for g, r in zip(got_heads, ref_heads):
            np.testing.assert_allclose(float(g), float(r), rtol=0, atol=1e-6)
    scene_logits = RNG.normal(0, 2, (b, 3)).astype(np.float32)
    heads = [RNG.normal(0, 3, (b, 3, n)).astype(np.float32)
             for n in N_CLASSES]
    scene = np.array([0, 2, -1, 1, -1, 2], np.int32)
    ref, ref_c = jax_isn.isn_loss(
        jnp.asarray(scene_logits), [jnp.asarray(h) for h in heads],
        jnp.asarray(labels), jnp.asarray(scene), scene_loss_weight=0.7,
        label_smoothing=smoothing)
    got, got_c = isn.isn_loss(
        torch.from_numpy(scene_logits), [torch.from_numpy(h) for h in heads],
        torch.from_numpy(labels), torch.from_numpy(scene),
        scene_loss_weight=0.7, label_smoothing=smoothing)
    np.testing.assert_allclose(float(got), float(ref), rtol=0, atol=1e-6)
    for key in ("scene_loss", "geo_loss"):
        np.testing.assert_allclose(float(got_c[key]), float(ref_c[key]),
                                   rtol=0, atol=1e-6)


SCHEDULES = {
    "multistep_warmup": dict(name="multistep", milestones=[2, 4, 7],
                             gamma=0.5, warmup_epochs=1.5),
    "multistep": dict(name="multistep", milestones=[2, 4], gamma=0.1),
    "cosine": dict(name="cosine", milestones=[6]),
    "constant": dict(name="constant"),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_optax(name):
    """The learning rate at every step 0..59, 5 steps an epoch: boundaries
    at count >= boundary, warmup from 0, milestones after it shifted."""
    opt = jax_config.OptimizerConfig(lr=0.1)
    sched = jax_config.LRScheduleConfig(**SCHEDULES[name])
    _, ref = jax_optim.build_optimizer(opt, sched, steps_per_epoch=5)
    got = optim.build_schedule(opt, sched, steps_per_epoch=5)
    for count in range(60):
        assert abs(got(count) - float(ref(count))) <= 1e-7, count
    if name == "multistep_warmup":
        assert got(0) == 0.0 and got(7) == pytest.approx(0.1)


def test_milestone_inside_warmup_raises_as_jax():
    args = (1.0, [1, 3], 0.1, 10, 1.5)
    with pytest.raises(ValueError) as ref:
        jax_optim.multistep_schedule(*args)
    with pytest.raises(ValueError) as got:
        optim.multistep_schedule(*args)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("name, kw", [
    ("sgd", dict(momentum=0.9, weight_decay=1e-2)),
    ("sgd", dict(momentum=0.9, nesterov=True, weight_decay=1e-2)),
    ("sgd", dict(momentum=0.5)),
    ("adamw", dict(weight_decay=1e-2)),
], ids=["sgd", "sgd_nesterov", "sgd_no_decay", "adamw"])
def test_optimizer_matches_optax(name, kw):
    """Three updates on fixed gradients, under a warmup schedule."""
    opt_cfg = jax_config.OptimizerConfig(name=name, lr=0.3, **kw)
    sched = jax_config.LRScheduleConfig(milestones=[2], gamma=0.5,
                                        warmup_epochs=1.0)
    tx, _ = jax_optim.build_optimizer(opt_cfg, sched, steps_per_epoch=2)
    init = {"a": RNG.normal(size=(3, 4)).astype(np.float32),
            "b": RNG.normal(size=5).astype(np.float32)}
    params = {k: jnp.asarray(v) for k, v in init.items()}
    tparams = {k: torch.tensor(v) for k, v in init.items()}
    opt_state = tx.init(params)
    port = optim.build_optimizer(list(tparams.values()), opt_cfg, sched,
                                 steps_per_epoch=2)
    for _ in range(3):
        grads = {k: RNG.normal(size=v.shape).astype(np.float32)
                 for k, v in init.items()}
        updates, opt_state = tx.update(
            {k: jnp.asarray(g) for k, g in grads.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        port.step()
        for k in init:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(params[k]), rtol=0,
                                       atol=1e-6)
    assert port.count == 3


def _sgd_per_leaf(opt, lr):
    """SGD leaf by leaf, six elementwise operations each: the arrangement
    the update over all leaves at once has to round as."""
    for p, t in zip(opt.params, opt.slots["trace"]):
        u = p.grad
        if opt.weight_decay:
            u = u + opt.weight_decay * p
        t.mul_(opt.momentum).add_(u)
        p.sub_(lr * (u + opt.momentum * t if opt.nesterov else t))


@pytest.mark.parametrize("nesterov", [False, True],
                         ids=["momentum", "nesterov"])
@pytest.mark.parametrize("wd", [0.0, 1e-4], ids=["no_decay", "decay"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_sgd_over_all_leaves_keeps_the_per_leaf_bits(dtype, wd, nesterov):
    """Three updates at learning rates that are no powers of two: every
    leaf and its trace bit for bit the per-leaf formula's."""
    gen = torch.Generator().manual_seed(5)
    shapes = [(3, 4), (5,), (2, 3, 3, 2), (1,), (7, 1)]
    init = [torch.randn(s, generator=gen).to(dtype) for s in shapes]
    schedule = lambda count: 0.3 * (count + 1) / 3   # noqa: E731
    got, want = ([t.clone() for t in init] for _ in range(2))
    kw = dict(momentum=0.9, nesterov=nesterov, weight_decay=wd)
    opt = optim.Optimizer(got, schedule, **kw)
    ref = optim.Optimizer(want, schedule, **kw)
    for k in range(3):
        for p, q in zip(got, want):
            p.grad = torch.randn(p.shape, generator=gen).to(dtype)
            q.grad = p.grad.clone()
        opt.step()
        _sgd_per_leaf(ref, schedule(k))
    assert opt.count == 3
    for a, b in zip(got + opt.slots["trace"], want + ref.slots["trace"]):
        assert a.dtype == dtype and torch.equal(a, b)


def test_running_stats_over_all_norms_keep_the_per_norm_bits():
    """`update_running_stats` over every BatchNorm at once: each running
    mean and variance bit for bit one BatchNorm's own momentum * running +
    (1 - momentum) * batch."""
    gen = torch.Generator().manual_seed(3)
    bns = [torch.nn.BatchNorm2d(c) for c in (4, 16, 7)]
    for bn in bns:
        bn.running_mean.normal_(generator=gen)
        bn.running_var.uniform_(0.5, 2.0, generator=gen)
    stats = [t for bn in bns for t in (
        torch.randn(bn.num_features, generator=gen),
        torch.rand(bn.num_features, generator=gen))]
    m = resnet.BN_MOMENTUM
    want = [(m * bn.running_mean + (1 - m) * mean,
             m * bn.running_var + (1 - m) * var)
            for bn, mean, var in zip(bns, stats[0::2], stats[1::2])]
    resnet.update_running_stats(bns, stats)
    for bn, (mean, var) in zip(bns, want):
        assert torch.equal(bn.running_mean, mean)
        assert torch.equal(bn.running_var, var)


# -- the steps ------------------------------------------------------------------------

OPT = jax_config.OptimizerConfig(lr=0.05, momentum=0.9, weight_decay=1e-4)
CONSTANT = jax_config.LRScheduleConfig(name="constant")


def _states(dtype, n_scenes=None):
    """The same seeded weights as a JAX TrainState and the port's."""
    rng = np.random.default_rng(5)
    params, stats = world.seeded_jax_variables(rng, ARCH, N_CLASSES,
                                               n_scenes)
    if n_scenes:
        jmodel = jax_isn.ISNClassifier(n_classes=N_CLASSES, n_scenes=n_scenes,
                                       arch=ARCH, dtype=getattr(jnp, dtype))
        model = ISNClassifier(N_CLASSES, n_scenes, ARCH, getattr(torch, dtype))
    else:
        jmodel = JaxClassifier(n_classes=N_CLASSES, arch=ARCH,
                               dtype=getattr(jnp, dtype))
        model = classifier.MultiPartitioningClassifier(
            N_CLASSES, ARCH, getattr(torch, dtype))
    tx, _ = jax_optim.build_optimizer(OPT, CONSTANT, 10)
    jstate = jax_step.create_train_state(
        jmodel, {"params": params, "batch_stats": stats}, tx)
    model.load_state_dict(from_jax_variables(params, stats, ARCH, N_CLASSES))
    return jstate, step.TrainState(
        model, optim.build_optimizer(model.parameters(), OPT, CONSTANT, 10))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    labels = np.stack([rng.integers(0, n, BATCH) for n in N_CLASSES]).astype(
        np.int32)
    labels[1, 2] = -1
    return images, labels


def _hold_state(jstate, state, atol, rtol, stat_atol, stat_rtol):
    """Parameters and BatchNorm statistics after the steps, by name."""
    ref = from_jax_variables(jax.tree.map(np.asarray, jstate.params),
                             jax.tree.map(np.asarray, jstate.batch_stats),
                             ARCH, N_CLASSES)
    got = state.model.state_dict()
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        stat = k.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(
            got[k].numpy(), r.numpy(), err_msg=k,
            atol=stat_atol if stat else atol,
            rtol=stat_rtol if stat else rtol)


def _steps(dtype, modes=(False, True)):
    """One step per entry of `modes`: augment=False takes the center crops,
    augment=True is augmented on the JAX step's own draws (its
    fold_in(rng, step)); returns both states and both metrics of each
    step."""
    jstate, state = _states(dtype)
    images, labels = _batch()
    rng = jax.random.PRNGKey(0)
    jdt = getattr(jnp, dtype)
    metrics = []
    for augment in modes:
        draws = jax_crop_draws(jax.random.fold_in(rng, state.step), BATCH,
                               SIZE, SIZE, CROP) if augment else None
        jstate, jm = jax.jit(
            lambda s, i, l, r: jax_step.train_step(
                s, i, l, r, crop=CROP, augment=augment, dtype=jdt))(
            jstate, jnp.asarray(images), jnp.asarray(labels), rng)
        state, pm = step.train_step(state, torch.from_numpy(images),
                                    torch.from_numpy(labels), 0, crop=CROP,
                                    augment=augment, draws=draws)
        metrics.append((jm, pm))
    assert state.step == int(jstate.step) == len(modes)
    return jstate, state, metrics


def test_train_step_float32_matches_jax():
    """float32: losses within rtol 1e-5, parameters and BatchNorm statistics
    within atol 1e-5 / rtol 1e-4; the running variance is flax's, the
    biased batch variance under momentum 0.9."""
    jstate, state, metrics = _steps("float32")
    for jm, pm in metrics:
        assert set(pm) == set(jm) == {"loss", "loss_head0", "loss_head1",
                                      "loss_head2", "n_valid"}
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
        assert int(pm["n_valid"]) == BATCH - 1
    _hold_state(jstate, state, 1e-5, 1e-4, 1e-5, 1e-4)
    ref = jstate.batch_stats["backbone"]["layer4_block0"]["bn2"]["var"]
    got = state.model.state_dict()["backbone.layer4.0.bn2.running_var"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


# bf16: every convolution rounds its output to bf16 (8 bits of mantissa,
# 2^-9 relative), and XLA's CPU convolutions and oneDNN's round different
# sums; through 17 convolutions that moves the losses by up to about 0.3%,
# and after an SGD step at lr 0.05 the parameters by up to about 1e-2 and the
# running statistics of the deep layers by up to about 1%.
BF16_LOSS_RTOL = 1e-2
BF16_PARAM_ATOL, BF16_PARAM_RTOL = 1e-2, 1e-2
BF16_STAT_ATOL, BF16_STAT_RTOL = 2e-2, 2e-2


def test_train_step_bf16_matches_jax():
    """One augmented step on the JAX step's draws, at bf16."""
    jstate, state, metrics = _steps("bfloat16", modes=(True,))
    jm, pm = metrics[0]
    for k in ("loss", "loss_head0", "loss_head1", "loss_head2"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                   rtol=BF16_LOSS_RTOL, err_msg=k)
    _hold_state(jstate, state, BF16_PARAM_ATOL, BF16_PARAM_RTOL,
                BF16_STAT_ATOL, BF16_STAT_RTOL)


def test_eval_step_matches_jax():
    jstate, state = _states("float32")
    images, labels = _batch(1)
    ref, ref_logits = jax.jit(lambda s, i, l: jax_step.eval_step(
        s, i, l, crop=CROP, dtype=jnp.float32))(
        jstate, jnp.asarray(images), jnp.asarray(labels))
    got, logits = step.eval_step(state, torch.from_numpy(images),
                                 torch.from_numpy(labels), crop=CROP)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5)
    for g, r in zip(logits, ref_logits):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


def test_isn_steps_match_jax(tmp_path):
    """One ISN train step (scene labels from a label CSV's S3 column, one
    unknown) and the ISN eval step, float32."""
    images, labels = _batch(2)
    path = tmp_path / "labels.csv"
    pd.DataFrame({"IMG_ID": [f"i{k}" for k in range(BATCH)],
                  "coarse": 0, "middle": 0, "fine": 0,
                  "S3_Label": [0, 1, 2, 2, 1, 0, -1, 1]}).to_csv(path,
                                                               index=False)
    _, scene_map = loader.load_label_csv(str(path), ["coarse", "middle",
                                                     "fine"], with_scene=True)
    scene = np.array([scene_map[f"i{k}"] for k in range(BATCH)], np.int32)
    jstate, state = _states("float32", n_scenes=3)
    jstate, jm = jax.jit(lambda s, i, l, c, r: jax_step.train_step_isn(
        s, i, l, c, r, crop=CROP, dtype=jnp.float32, augment=False,
        scene_loss_weight=0.5))(
        jstate, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(scene),
        jax.random.PRNGKey(0))
    state, pm = step.train_step_isn(
        state, torch.from_numpy(images), torch.from_numpy(labels),
        torch.from_numpy(scene), 0, crop=CROP, scene_loss_weight=0.5,
        augment=False)
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    ref, _ = jax.jit(lambda s, i, l, c: jax_step.eval_step_isn(
        s, i, l, c, crop=CROP, dtype=jnp.float32))(
        jstate, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(scene))
    got, _ = step.eval_step_isn(state, torch.from_numpy(images),
                                torch.from_numpy(labels),
                                torch.from_numpy(scene), crop=CROP)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_remat_changes_nothing():
    """Recomputing each block on the backward pass gives the same
    parameters and running statistics: the statistics update once."""
    images, labels = _batch(3)
    states = []
    for remat in (False, True):
        model = init_weights(classifier.MultiPartitioningClassifier(
            N_CLASSES, ARCH, torch.float32, remat=remat), seed=1)
        state = step.TrainState(model, optim.build_optimizer(
            model.parameters(), OPT, CONSTANT, 10))
        step.train_step(state, torch.from_numpy(images),
                        torch.from_numpy(labels), 0, crop=CROP)
        states.append(state.model.state_dict())
    for k in states[0]:
        torch.testing.assert_close(states[1][k], states[0][k], rtol=1e-6,
                                   atol=1e-7, msg=k)


def test_metrics_csv_matches_jax(tmp_path, monkeypatch):
    """The same rows and columns, including a resumed logger that absorbs
    the file and a row that adds columns."""
    monkeypatch.setattr("time.time", lambda: 1700000000.5)
    rows = [(1, {"loss": 2.5, "lr": 0.01}, "train/"),
            (2, {"loss": 2.25, "lr": 0.01}, "train/"),
            (2, {"val_loss": 3.0, "gcd@25km": 0.5}, "val/")]
    for mod, d in ((jax_logging, "jax"), (port_logging, "port")):
        for part in (rows[:2], rows[2:]):
            logger = mod.MetricsLogger(str(tmp_path / d), tensorboard=False,
                                       stdout=lambda s: None)
            for step_, m, prefix in part:
                logger.log(step_, m, prefix=prefix)
            logger.close()
    assert (tmp_path / "port" / "metrics.csv").read_text() == \
        (tmp_path / "jax" / "metrics.csv").read_text()


# -- train_base end to end ------------------------------------------------------------

@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    """A seeded shard world (`tools.world.write_shard_world`) on the baseM
    recipe at resnet14, batch 8, 64-px crops, keeping 1 checkpoint."""
    root = tmp_path_factory.mktemp("train_world")
    parts = world.seeded_partitionings(np.random.default_rng(1), (12, 24, 48))
    config = load_config(str(REPO / "configs" / "baseM.yml"))
    config.model_params.arch = ARCH
    tp = config.train_params
    tp.batch_size, tp.image_size, tp.num_workers = 8, 64, 2
    tp.log_every_steps, tp.checkpoint_every_steps = 1, 0
    tp.keep_checkpoints = 1
    path = world.write_shard_world(str(root), parts, config, per_shard=16,
                                   n_val=8, sizes=(72, 96))
    return {"config": path, "ckpt": str(root / "ckpt"), "root": root}


def test_train_base_trains_resumes_and_serves(train_world, capsys, tmp_path):
    from geoestimation_tpu_torch.checkpoint import (
        CheckpointManager,
        load_checkpoint,
    )
    from geoestimation_tpu_torch.classification import inference, train_base

    train_base.main(["--config", train_world["config"], "--max_steps", "4",
                     "--cpu"])
    out = capsys.readouterr().out
    assert "step 4/4" in out and "val @ 4" in out
    mgr = CheckpointManager(train_world["ckpt"])
    assert mgr.all_steps() == [4]
    train_base.main(["--config", train_world["config"], "--max_steps", "6",
                     "--cpu"])
    out = capsys.readouterr().out
    assert "resuming from step 4" in out and "step 5/6" in out
    # best-1 by val_loss: the better of steps 4 and 6 survives
    kept = mgr.all_steps()
    assert len(kept) == 1 and mgr.best_step() == kept[0]
    df = pd.read_csv(os.path.join(train_world["ckpt"], "metrics.csv"))
    gcd = [f"val/gcd@{k}km" for k in (1, 25, 200, 750, 2500)]
    assert list(df.columns) == ["step", "time", "train/loss", "train/lr",
                                "train/images_per_sec", "val/val_loss"] + gcd
    assert list(df.step) == [1, 2, 3, 4, 4, 5, 6, 6]
    vals = df.dropna(subset=["val/val_loss"]).set_index("step")
    assert kept[0] == vals["val/val_loss"].idxmin()
    assert np.isfinite(df["train/loss"].dropna()).all()
    _, sd = load_checkpoint(train_world["ckpt"])
    assert torch.equal(sd["heads.fused_head.weight"],
                       mgr.restore(kept[0])["model"]["heads.fused_head.weight"])

    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(4)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (90, 80, 3), dtype=np.uint8)
                        ).save(images / f"q{i}.jpg")
    inference.main(["--checkpoint", train_world["ckpt"], "--image_dir",
                    str(images), "--output", str(tmp_path / "p.csv"),
                    "--crops", "1", "--cpu"])
    preds = pd.read_csv(tmp_path / "p.csv")
    assert len(preds) == 3 * 4
    assert set(preds.p_key) == {"coarse", "middle", "fine", "hierarchy"}


def test_train_base_needs_cuda_unless_cpu(train_world, monkeypatch):
    from geoestimation_tpu_torch.classification import train_base

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_base.main(["--config", train_world["config"], "--max_steps",
                         "1"])


@pytest.mark.parametrize("flags", [["--coordinator", "localhost:1234"],
                                   ["--num_processes", "2"]])
def test_train_base_refuses_multi_process_flags(train_world, flags):
    """Refused here until multi-process training was ported; now an orphan
    --num_processes exits with the JAX package's message and --coordinator
    HOST:PORT without the process flags exits naming them
    (tests/test_torch_port_multiprocess_eval.py trains in two processes)."""
    from geoestimation_tpu_torch.classification import train_base

    message = ("--num_processes/--process_id require --coordinator"
               if "--num_processes" in flags
               else "needs --num_processes and --process_id")
    with pytest.raises(SystemExit, match=message):
        train_base.main(["--config", train_world["config"], "--cpu"] + flags)


def test_trainer_checkpoints_on_sigterm_and_traces(train_world, tmp_path):
    """SIGTERM during fit: a metric-less checkpoint at the next step (kept
    as a resume point) and a clean return; --profile_dir's trace is
    written."""
    import signal

    from geoestimation_tpu_torch.checkpoint import CheckpointManager
    from geoestimation_tpu_torch.train.loop import Trainer

    config = load_config(train_world["config"])
    config.train_params.checkpoint_dir = str(tmp_path / "ckpt")
    config.train_params.profile_dir = str(tmp_path / "prof")
    lines = []

    def log(line):
        lines.append(line)
        if line.startswith("step 1/"):
            os.kill(os.getpid(), signal.SIGTERM)

    Trainer(config, search_dirs=[str(train_world["root"])], log_fn=log,
            device="cpu").fit(max_steps=6)
    assert "checkpointed at step 1 after SIGTERM; exiting" in lines
    mgr = CheckpointManager(config.train_params.checkpoint_dir)
    assert mgr.all_steps() == [1] and mgr.metrics(1) is None
    assert mgr.restore(1)["step"] == 1
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_trainer_refuses_a_mesh(train_world):
    """A mesh the processes do not make is refused with `make_mesh`'s
    message (the data axis is the ranks; here one); a model axis in one
    process names --coordinator (a rank holds each slice of the head)."""
    from geoestimation_tpu_torch.train.loop import Trainer

    config = load_config(train_world["config"])
    config.train_params.mesh_shape = [2, 1]
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        Trainer(config, device="cpu")
    config.train_params.mesh_shape = [1, 1]
    trainer = Trainer(config, search_dirs=[str(train_world["root"])],
                      device="cpu")
    assert (trainer.layout.n_data, trainer.layout.n_model) == (1, 1)
    assert trainer.sharded == {}
    config.train_params.mesh_shape = [1, 2]
    with pytest.raises(ValueError, match="--coordinator"):
        Trainer(config, device="cpu")
