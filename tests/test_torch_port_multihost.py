"""The port's process layer (`geoestimation_tpu_torch/parallel/`) against the
JAX package's: the lockstep slicer, the strided feed and the GCD merge over
two gloo ranks, the flags and the mesh's messages, the global batch's draws,
and a two-rank train step (plain, with remat, ISN) against the JAX float32
step on the same global batch. The ranks run in processes of their own
(`tests/torch_ranks.py`, torch.multiprocessing with spawn), each with a
30 s collective timeout and a 120 s limit."""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoestimation_tpu.parallel import mesh as jax_mesh
from geoestimation_tpu.parallel import multihost as jax_multihost
from geoestimation_tpu.train import step as jax_step
from geoestimation_tpu_torch.convert import from_jax_variables
from geoestimation_tpu_torch.data.loader import TrainBatch
from geoestimation_tpu_torch.ingest import pipeline
from geoestimation_tpu_torch.parallel import mesh, multihost
from tests import torch_ranks
from tests.test_torch_port_train import (
    BATCH,
    CROP,
    SIZE,
    _batch,
    _states,
    jax_crop_draws,
)

ARCH, N_CLASSES = torch_ranks.ARCH, torch_ranks.N_CLASSES


# -- the lockstep slicer, the flags, the mesh ---------------------------------

class _Batcher:
    def __init__(self, batches, batch_size):
        self.batches, self.batch_size = batches, batch_size

    def __iter__(self):
        return iter(self.batches)


def _train_batches(rng, n, b=8):
    return [TrainBatch(
        images=rng.integers(0, 255, (b, 4, 4, 3), dtype=np.uint8),
        labels=rng.integers(-1, 9, (3, b)).astype(np.int32),
        ids=[f"i{k}_{j}" for j in range(b)],
        latlng=rng.normal(0, 30, (b, 2)).astype(np.float32),
        scene=rng.integers(-1, 3, b).astype(np.int32)) for k in range(n)]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_lockstep_slicer_matches_jax(n):
    """Every process's slices of the same global batches, field by field."""
    batches = _train_batches(np.random.default_rng(n), 3)
    for p in range(n):
        got = list(multihost.LockstepSlicer(_Batcher(batches, 8), p, n))
        ref = list(jax_multihost.LockstepSlicer(_Batcher(batches, 8), p, n))
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            for f in dataclasses.fields(TrainBatch):
                a, b = getattr(g, f.name), getattr(r, f.name)
                if isinstance(b, np.ndarray):
                    np.testing.assert_array_equal(a, b, err_msg=f.name)
                else:
                    assert a == b, f.name
            assert g.images.shape[0] == 8 // n


def test_lockstep_slicer_rejects_an_indivisible_batch_as_jax():
    with pytest.raises(ValueError) as ref:
        jax_multihost.LockstepSlicer(_Batcher([], 6), 0, 4)
    with pytest.raises(ValueError, match="not divisible by 4") as got:
        multihost.LockstepSlicer(_Batcher([], 6), 0, 4)
    assert str(got.value) == str(ref.value)


def _flags(**kw):
    return argparse.Namespace(**{"coordinator": None, "num_processes": None,
                                 "process_id": None, "cpu": True, **kw})


@pytest.mark.parametrize("kw", [{"num_processes": 2}, {"process_id": 1},
                                {"num_processes": 2, "process_id": 0}])
def test_maybe_initialize_orphan_flags_exit_as_jax(kw):
    with pytest.raises(SystemExit) as ref:
        jax_multihost.maybe_initialize(_flags(**kw))
    with pytest.raises(SystemExit) as got:
        multihost.maybe_initialize(_flags(**kw))
    assert str(got.value) == str(ref.value) == \
        "--num_processes/--process_id require --coordinator"
    assert not multihost.maybe_initialize(_flags())
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.device_group() is None


def test_coordinator_needs_the_process_flags():
    with pytest.raises(SystemExit, match="needs --num_processes and "
                                         "--process_id"):
        multihost.maybe_initialize(_flags(coordinator="127.0.0.1:1"))


def test_coordinator_flags_and_help_match_jax():
    parsers = []
    for mod in (jax_multihost, multihost):
        p = argparse.ArgumentParser()
        mod.add_coordinator_args(p, extra_help="x")
        parsers.append({a.dest: (a.default, a.type)
                        for a in p._actions if a.dest != "help"})
    assert parsers[0] == parsers[1]


@pytest.mark.parametrize("shape, n_dev", [
    ((3, 1), 2), ((None, 3), 2), ((2, 2), 3), ((4, 1, 3), 4),
])
def test_make_mesh_messages_match_jax(shape, n_dev, monkeypatch):
    """The JAX package's validation, word for word (its checks run before
    any device is touched, so placeholders stand in for devices): over
    n_dev ranks (rank 0's view), and, without a model axis, over one
    process's n_dev devices (one process refuses a model axis first,
    `test_one_process_model_axis_names_the_coordinator`)."""
    args = dict(zip(("n_data", "n_model", "dcn_data"), shape))
    with pytest.raises(ValueError) as ref:
        jax_mesh.make_mesh(devices=[object()] * n_dev, **args)
    if args.get("n_model", 1) == 1:
        with pytest.raises(ValueError) as got:
            mesh.make_mesh(devices=["cpu"] * n_dev, **args)
        assert str(got.value) == str(ref.value)
    monkeypatch.setattr(multihost, "process_count", lambda: n_dev)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)
    monkeypatch.setattr(multihost, "rank_devices", lambda: ["cpu"] * n_dev)
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(**args)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("args", [dict(n_data=1, n_model=2),
                                  dict(n_data=2, dcn_data=2)])
def test_model_axis_and_dcn_layouts_match_jax(args, monkeypatch):
    """Over two ranks (rank 1's view): the slots' coordinates, the groups
    asked for, and the fused head's placement for an even and an odd class
    count, against the JAX package's mesh on two of its CPU devices (its
    (features, classes) kernel is torch's (classes, features) weight
    transposed)."""
    asked = []
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    monkeypatch.setattr(multihost, "rank_devices", lambda: ["cpu", "cpu"])
    monkeypatch.setattr(multihost, "mesh_groups",
                        lambda *shape: asked.append(shape))
    layout = mesh.make_mesh(**args)
    ref = jax_mesh.make_mesh(devices=jax.devices()[:2], **args)
    assert (layout.n_data, layout.n_model) == (ref.n_data, ref.n_model)
    assert asked == [(layout.n_data, layout.n_model,
                      args.get("dcn_data", 1))]
    assert layout.processes == (0, 1)
    assert (layout.data_index, layout.model_index) == \
        divmod(1, layout.n_model)
    assert multihost.data_axis_is_process_contiguous(layout)
    # a model axis of one splits nothing: JAX's spec names it, the port
    # says None
    torch_dim = ({(None, "model"): 0, ("model", None): 1, ("model",): 0}
                 if layout.n_model > 1 else {})
    for n_total in (16, 17):
        kernel = torch_dim.get(tuple(ref.head_kernel(n_total).spec))
        bias = torch_dim.get(tuple(ref.head_bias(n_total).spec))
        assert layout.head_kernel(n_total) == kernel
        assert layout.head_bias(n_total) == bias
        assert layout.params({
            "heads.fused_head.weight": torch.zeros(n_total, 4),
            "heads.fused_head.bias": torch.zeros(n_total),
            "backbone.conv1.weight": torch.zeros(2, 3, 7, 7)}) == {
            "heads.fused_head.weight": kernel, "heads.fused_head.bias": bias,
            "backbone.conv1.weight": None}
    if layout.n_model > 1:
        assert (layout.head_kernel(16), layout.head_kernel(17)) == (0, 1)


def test_one_process_model_axis_names_the_coordinator():
    """One process has no rank for each head slice: a model axis is
    refused naming --coordinator before the devices are counted."""
    for n_data, n_model, n_dev in ((1, 2, 2), (None, 3, 2), (2, 2, 3)):
        with pytest.raises(ValueError, match="--coordinator"):
            mesh.make_mesh(n_data, n_model, devices=["cpu"] * n_dev)


def test_mesh_layout_and_batch_split():
    layout = mesh.make_mesh(devices=["cpu", "cpu"])
    assert layout.n_data == 2 and layout.processes == (0, 0)
    assert multihost.data_axis_is_process_contiguous(layout)
    assert not multihost.data_axis_is_process_contiguous(
        mesh.MeshLayout(devices=("cpu",) * 3, processes=(0, 1, 0)))
    images = np.arange(4 * 2 * 2 * 3, dtype=np.uint8).reshape(4, 2, 2, 3)
    xs = mesh.shard_batch_arrays(layout, images)
    assert [len(x) for x in xs] == [2, 2]
    np.testing.assert_array_equal(torch.cat(xs).numpy(), images)
    with pytest.raises(ValueError, match="does not split evenly"):
        mesh.shard_batch_arrays(layout, images[:3])


def test_default_mesh_needs_cuda(monkeypatch):
    """Without devices, one process's layout is its local cards: where CUDA
    is absent it raises, naming --cpu, and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available.*--cpu"):
        mesh.make_mesh()
    assert mesh.make_mesh(devices=["cpu"]).n_data == 1


@pytest.mark.parametrize("crop_scale", [None, (0.66, 1.0)])
def test_each_process_takes_its_rows_of_the_global_draws(crop_scale):
    """A process's rows through `train_pipeline(shard=(p, 2))` are the rows
    one process gives the global batch at the same (seed, step)."""
    rng = np.random.default_rng(4)
    images = torch.from_numpy(
        rng.integers(0, 255, (8, 48, 48, 3), dtype=np.uint8))
    whole = pipeline.train_pipeline(images, 7, 3, crop=32,
                                    dtype=torch.float32,
                                    crop_scale=crop_scale)
    for p in range(2):
        got = pipeline.train_pipeline(images[4 * p:4 * p + 4], 7, 3,
                                      crop=32, dtype=torch.float32,
                                      crop_scale=crop_scale, shard=(p, 2))
        torch.testing.assert_close(got, whole[4 * p:4 * p + 4], rtol=0,
                                   atol=0)


# -- collectives on two gloo ranks --------------------------------------------

GCD_COUNTS = [  # per rank: {key: [(counts, total), ...]}
    {"coarse": [([1, 2, 3, 4, 5], 6), ([0, 0, 1, 1, 2], 3)],
     "hierarchy": [([2, 2, 2, 3, 3], 4)]},
    {"coarse": [([0, 1, 1, 1, 1], 2)], "hierarchy": []},   # an idle key
]


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives")
    torch_ranks.spawn(torch_ranks.collectives, out, GCD_COUNTS)
    return [torch.load(out / f"collectives{r}.pt") for r in range(2)]


def test_strided_feed_ends_globally_on_uneven_streams(collectives):
    """Ranks with 3 and 5 batches both stop after 3."""
    assert [c["uneven"] for c in collectives] == [[0, 1, 2], [0, 1, 2]]


def test_strided_feed_error_reraises_there_and_the_peer_exits(collectives):
    r0, r1 = collectives
    assert r1["error"] == "decode failed at 1" and r1["before_error"] == [0]
    assert "error" not in r0 and r0["before_error"] == [0]


def test_merge_gcd_accumulators_equals_one_accumulator(collectives):
    """Both ranks' merged counts are those of one accumulator over every
    rank's batches; the missing counts sum."""
    from geoestimation_tpu_torch.eval.metrics import GcdAccumulator

    want = {}
    for key in ("coarse", "hierarchy"):
        acc = GcdAccumulator()
        for rank in GCD_COUNTS:
            for counts, total in rank[key]:
                acc.update(np.asarray(counts), total)
        want[key] = (acc.counts.tolist(), acc.total)
    for c in collectives:
        assert c["merged"] == want
        assert c["n_missing"] == 3 + 4


def test_host_flags_agree(collectives):
    for c in collectives:
        assert c["any"] == [True, False] and c["all"] == [False, True]


# -- a two-rank train step against the JAX step -------------------------------

# rank 0's rows (0-3) hold every -1 label and both unknown scenes, rank 1's
# none: a division by local valid counts would show
UNEVEN = [(0, 1), (1, 2), (1, 0), (2, 3)]
SCENE = np.array([0, 1, -1, -1, 2, 2, 1, 0], np.int32)
# float32 on XLA's and oneDNN's CPU convolutions, two SGD steps at lr 0.05
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-5
LOSS_RTOL = 1e-5


def _global_batch():
    images, labels = _batch()
    for h, row in UNEVEN:
        labels[h, row] = -1
    return images, labels


@pytest.fixture(scope="module")
def two_rank_steps(tmp_path_factory):
    """The ranks' two steps (plain, remat) and ISN step, started before the
    JAX package's own on the global batch runs here; both results."""
    images, labels = _global_batch()
    rng = jax.random.PRNGKey(0)
    draws = jax_crop_draws(jax.random.fold_in(rng, 1), BATCH, SIZE, SIZE,
                           CROP)
    draws = {k: v if k == "size" else v.numpy() for k, v in draws.items()}
    out = tmp_path_factory.mktemp("steps")
    started = torch_ranks.start(torch_ranks.train_steps, out, images, labels,
                                SCENE, draws, CROP)
    jstate, _ = _states("float32")
    jax_metrics = []
    for augment in (False, True):
        jstate, jm = jax.jit(
            lambda s, i, l, r: jax_step.train_step(
                s, i, l, r, crop=CROP, augment=augment, dtype=jnp.float32))(
            jstate, jnp.asarray(images), jnp.asarray(labels), rng)
        jax_metrics.append(jm)
    jisn, _ = _states("float32", n_scenes=3)
    jisn, jm = jax.jit(lambda s, i, l, c, r: jax_step.train_step_isn(
        s, i, l, c, r, crop=CROP, dtype=jnp.float32, augment=False,
        scene_loss_weight=0.5))(
        jisn, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(SCENE),
        rng)
    torch_ranks.join(started)
    ranks = [torch.load(out / f"steps{r}.pt") for r in range(2)]
    return {"plain": (jstate, jax_metrics), "remat": (jstate, jax_metrics),
            "isn": (jisn, [jm])}, ranks


def _jax_state_dict(jstate):
    return from_jax_variables(jax.tree.map(np.asarray, jstate.params),
                              jax.tree.map(np.asarray, jstate.batch_stats),
                              ARCH, N_CLASSES)


@pytest.mark.parametrize("variant", ["plain", "remat", "isn"])
def test_two_rank_steps_match_jax(two_rank_steps, variant):
    """Both ranks report the global batch's losses and valid count, JAX's;
    both hold the same parameters and running statistics, JAX's after the
    steps (two for plain and remat, one ISN step)."""
    ref, ranks = two_rank_steps
    jstate, jax_metrics = ref[variant]
    (sd0, m0), (sd1, m1) = ranks[0][variant], ranks[1][variant]
    assert m0 == m1
    for jm, pm in zip(jax_metrics, m0, strict=True):
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(pm[k], float(jm[k]), rtol=LOSS_RTOL,
                                       err_msg=k)
    for k in sd0:
        torch.testing.assert_close(sd1[k], sd0[k], rtol=0, atol=0, msg=k)
    for k, r in _jax_state_dict(jstate).items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(sd0[k].numpy(), r.numpy(), err_msg=k,
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_two_rank_valid_counts_are_global(two_rank_steps):
    _, ranks = two_rank_steps
    n_valid = BATCH - len({row for _, row in UNEVEN})
    assert [m["n_valid"] for m in ranks[0]["plain"][1]] == [n_valid] * 2


def test_sigterm_on_one_rank_checkpoints_every_rank_at_one_step(
        tmp_path_factory):
    """The port agrees the SIGTERM flag over the ranks once a step (the JAX
    loop acts on each process's own flag, leaving the others in the next
    step's collective; ROADMAP.md Queue 3): rank 1 alone is signalled
    during step 1, and both ranks checkpoint at step 1 and return."""
    from geoestimation_tpu_torch.checkpoint import CheckpointManager
    from geoestimation_tpu_torch.tools import world
    from geoestimation_tpu_torch.utils.config import Config

    root = tmp_path_factory.mktemp("sigterm")
    config = Config()
    config.model_params.arch = ARCH
    config.model_params.dtype = "float32"
    tp = config.train_params
    tp.batch_size, tp.image_size, tp.num_workers = 4, 32, 1
    tp.log_every_steps, tp.checkpoint_every_steps = 1, 0
    path = world.write_shard_world(
        str(root), world.seeded_partitionings(np.random.default_rng(2),
                                              N_CLASSES),
        config, per_shard=8, n_val=4, sizes=(40, 48))
    torch_ranks.spawn(torch_ranks.sigterm_fit, root, path)
    seen = [torch.load(root / f"sigterm{r}.pt") for r in range(2)]
    assert [s["step"] for s in seen] == [1, 1]
    assert "checkpointed at step 1 after SIGTERM; exiting" in seen[0]["log"]
    assert seen[1]["log"] == []
    assert CheckpointManager(str(root / "ckpt")).all_steps() == [1]

