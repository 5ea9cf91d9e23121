"""Model-axis head sharding on gloo ranks against one process and the JAX
package's mesh.

Each case runs the seeded float32 state of `tests/torch_ranks.py` (resnet14
at 64 px, SGD with momentum) through two train steps (a center crop, then
the global batch's draws) on ranks of its own (spawned processes,
`tests/torch_ranks.py`): mesh (1, 2) with an even class count (the classes
split), (1, 2) with an odd one (the features split), (2, 2) on four ranks,
and (4, 1, dcn_data=2) beside the flat (4, 1). The whole state the ranks
gather (as a checkpoint holds it) is held against the port's one-process
steps at rtol 1e-5, and the (2, 2) state after its first step against the
JAX package's `make_mesh(4, 2)` step on its 8 CPU devices at the tolerances
`tests/test_torch_port_multihost.py` holds the data axis to. A two-rank
`Trainer.fit` at `mesh_shape` [1, 2] is held against one process's, and its
checkpoint loads whole in one process. Model-axis peers step with the same
replicated gradients by construction, and a planted fault -- the
features' gradient not summed or gathered over the model group -- moves
the trunk past the tolerance in both splits.

A sharded step sums in another order than one process (the head's partial
products, the gradients over other groups of ranks), and a float32 step can
carry such a difference past a ReLU's kink: a third step of these worlds,
augmented, moves layer4's weights by 2.6e-4 in one process when only the
head's sum is split in two. So the steps are held only where that
reordering stays inside the tolerance, which
`test_reference_is_stable_under_a_reordered_head` checks."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from geoestimation_tpu.parallel import mesh as jax_mesh
from geoestimation_tpu.train import step as jax_step
from geoestimation_tpu_torch.checkpoint import CheckpointManager
from geoestimation_tpu_torch.convert import from_jax_variables
from geoestimation_tpu_torch.models import classifier
from geoestimation_tpu_torch.train import step
from tests import torch_ranks
from tests.test_torch_port_train import _states

ARCH = torch_ranks.ARCH
EVEN, ODD = (3, 5, 8), (3, 5, 9)       # 16 and 17 classes
BATCH, SIZE, CROP = 8, 72, 64
# float32 on oneDNN's CPU convolutions: sums over other groups of ranks
# reorder the reductions, nothing else
RTOL, ATOL = 1e-5, 1e-6
# against XLA's convolutions, as tests/test_torch_port_multihost.py
JAX_RTOL, JAX_ATOL = 1e-5, 1e-5
# the Trainer world's momentum after two augmented steps at lr 0.01 is
# its gradients', which one process moves by 1.7e-5 in norm (20x rtol 1e-5
# elementwise) when only the head's sum is split in two: each leaf is held
# in norm, relative to one process's
FIT_TRACE_RTOL = 1e-3

CASES = {  # name: (world, n_classes, {shape name: mesh shape})
    # "fault": one step with `torch_ranks._unreduced_feature_grad` planted
    "columns": (2, EVEN, {"mesh": (1, 2), "fault": (1, 2)}),
    "rows": (2, ODD, {"mesh": (1, 2), "fault": (1, 2)}),
    "2x2": (4, ODD, {"mesh": (2, 2)}),
    "dcn": (4, ODD, {"mesh": (4, 1, 2), "flat": (4, 1)}),
}


def _global_batch(n_classes):
    rng = np.random.default_rng(11)
    images = rng.integers(0, 255, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    labels = np.stack([rng.integers(0, n, BATCH) for n in n_classes]) \
        .astype(np.int32)
    labels[1, 2] = labels[2, 5] = -1
    return images, labels


def _whole(state):
    names = [k for k, _ in state.model.named_parameters()]
    return {"model": {k: v.clone() for k, v in
                      state.model.state_dict().items()},
            "trace": {k: t.clone() for k, t in
                      zip(names, state.optimizer.slots["trace"])}}


def _split_head_forward(self, features):
    """The fused head's one-process forward with its sum over the features
    in two halves: the order of the features split's partial products."""
    x, w = features.float(), self.fused_head.weight
    half = w.shape[1] // 2
    logits = (F.linear(x[:, :half], w[:, :half])
              + F.linear(x[:, half:], w[:, half:]) + self.fused_head.bias)
    return list(torch.split(logits, self.n_classes, dim=-1))


def _one_process(n_classes):
    """The port's one-process steps on the global batch: the metrics and
    the whole state after each step."""
    torch.set_num_threads(1)
    images, labels = _global_batch(n_classes)
    state = torch_ranks.seeded_state(n_classes=n_classes)
    metrics, states = [], []
    for augment in torch_ranks.AUGMENT:
        state, m = step.train_step(state, torch.from_numpy(images),
                                   torch.from_numpy(labels), 0, crop=CROP,
                                   augment=augment)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_whole(state))
    return metrics, states


_reference = functools.lru_cache(_one_process)


def _jax_step():
    """The JAX package's jitted step on make_mesh(4, 2) (8 CPU devices), on
    center crops, from `_states`' weights (the ranks' seed): the state dict
    after it."""
    images, labels = _global_batch(ODD)
    jstate, _ = _states("float32")
    layout = jax_mesh.make_mesh(4, 2)
    jstate = jstate.replace(
        params=jax.device_put(jstate.params, layout.params(jstate.params)),
        opt_state=jax.device_put(jstate.opt_state,
                                 layout.params(jstate.opt_state)))
    fn = jax.jit(functools.partial(jax_step.train_step, crop=CROP,
                                   augment=False, dtype=jnp.float32),
                 in_shardings=(None, layout.batch(), layout.labels(),
                               layout.replicated()))
    x = jax.device_put(jnp.asarray(images), layout.batch())
    y = jax.device_put(jnp.asarray(labels), layout.labels())
    rng = jax.device_put(jax.random.PRNGKey(0), layout.replicated())
    jstate, _ = fn(jstate, x, y, rng)
    return from_jax_variables(jax.tree.map(np.asarray, jstate.params),
                              jax.tree.map(np.asarray, jstate.batch_stats),
                              ARCH, ODD)


@pytest.fixture(scope="module")
def model_axis(tmp_path_factory):
    """Every case's ranks, started together; while they run, the one-process
    references and the JAX mesh's steps here."""
    started = {}
    for name, (world, n_classes, shapes) in CASES.items():
        images, labels = _global_batch(n_classes)
        out = tmp_path_factory.mktemp(name)
        started[name] = (out, torch_ranks.start(
            torch_ranks.model_axis_steps, out, shapes, n_classes, images,
            labels, CROP, world=world))
    refs = {n: _reference(n) for n in (EVEN, ODD)}
    jax_sd = _jax_step()
    ranks = {}
    for name, (out, procs) in started.items():
        torch_ranks.join(procs, timeout=240)
        ranks[name] = [torch.load(out / f"model_axis{r}.pt")
                       for r in range(CASES[name][0])]
    return ranks, refs, jax_sd, {n: o for n, (o, _) in started.items()}


def _hold(got, want, rtol, atol, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("case, shape", [
    ("columns", "mesh"), ("rows", "mesh"), ("2x2", "mesh"), ("dcn", "mesh"),
    ("dcn", "flat")])
def test_sharded_steps_match_one_process(model_axis, case, shape):
    """Every rank reports the global batch's losses and valid count; the
    whole parameters, statistics and momentum after each step are one
    process's, and every rank gathers the same, bit for bit."""
    ranks, refs = model_axis[0][case], model_axis[1]
    ref_metrics, ref_states = refs[CASES[case][1]]
    for r in ranks:
        got = r[shape]
        assert got["metrics"] == ranks[0][shape]["metrics"]
        for g, w in zip(got["after"], ranks[0][shape]["after"], strict=True):
            for part in ("model", "trace"):
                assert all(torch.equal(t, w[part][k])
                           for k, t in g[part].items()), (case, part)
        for g, w in zip(got["metrics"], ref_metrics, strict=True):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=k)
        for g, w in zip(got["after"], ref_states, strict=True):
            _hold(g["model"], w["model"], RTOL, ATOL, f"{case} model")
            _hold(g["trace"], w["trace"], RTOL, ATOL, f"{case} momentum")
    assert ranks[0][shape]["metrics"][0]["n_valid"] == BATCH - 2


@pytest.mark.parametrize("case", ["columns", "rows"])
def test_unreduced_feature_gradient_leaves_the_tolerance(model_axis, case):
    """The gate above catches a planted fault in either split: with the
    features' gradient not summed over the model group (classes split,
    `model_copy` the identity) or not gathered (features split), the
    trunk's parameters after one step leave one process's rtol 1e-5."""
    ranks, refs = model_axis[0][case], model_axis[1]
    want = refs[CASES[case][1]][1][0]["model"]
    got = ranks[0]["fault"]["after"][0]["model"]
    trunk = [k for k in want if k.startswith("backbone.")
             and not k.endswith("num_batches_tracked")]
    with pytest.raises(AssertionError):
        _hold({k: got[k] for k in trunk}, {k: want[k] for k in trunk},
              RTOL, ATOL, f"{case} trunk")


@pytest.mark.parametrize("shape, world", [
    ((1, 2), 2), ((2, 2), 4), ((2, 2, 2), 4)])
def test_model_axis_peers_take_one_replicated_gradient(tmp_path, shape,
                                                       world):
    """Ranks whose gradients differ everywhere (as two backwards that
    disagree in the last bit would): after `all_reduce_grads` every rank
    holds the replicated gradient of the model group's first rank summed
    over the data axis, and each head slice its own data group's sum."""
    torch_ranks.spawn(torch_ranks.peer_grads, tmp_path, shape, world=world)
    seen = [torch.load(tmp_path / f"peer_grads{r}.pt") for r in range(world)]
    n_model = shape[1]
    for r, got in enumerate(seen):
        d, m = got["coords"]
        assert (d, m) == divmod(r, n_model)
        peers = range(m, world, n_model)
        torch.testing.assert_close(got["rep"], sum(
            torch.arange(5.0) + 10.0 * q for q in range(0, world, n_model)),
            rtol=0, atol=0)
        torch.testing.assert_close(got["head"], sum(
            torch.arange(3.0) + 100.0 * q for q in peers), rtol=0, atol=0)


@pytest.mark.parametrize("case, split, n_model", [
    ("columns", 0, 2), ("rows", 1, 2), ("2x2", 1, 2), ("dcn", None, 1)])
def test_each_rank_holds_its_head_slice(model_axis, case, split, n_model):
    """Rank r at (r // n_model, r % n_model) holds 1/n_model of the head's
    weight and of its momentum: the classes' slice (with the bias's) for
    an even count, the features' (the bias whole) for an odd one."""
    ranks = model_axis[0][case]
    n_total = sum(CASES[case][1])
    whole_w = (n_total, 2048)
    for r, seen in enumerate(ranks):
        got = seen["mesh"]
        assert got["coords"] == divmod(r, n_model)
        w, b = got["head"]
        if split is None:
            assert (w, b) == (whole_w, (n_total,)) and got["sharded"] == {}
            continue
        assert w[split] * n_model == whole_w[split]
        assert w[1 - split] == whole_w[1 - split]
        assert got["trace"] == w
        assert b == ((n_total // n_model,) if split == 0 else (n_total,))
        assert got["sharded"] == {
            "heads.fused_head.weight": split,
            **({"heads.fused_head.bias": 0} if split == 0 else {})}


def test_reference_is_stable_under_a_reordered_head():
    """The one-process steps with the head's sum split in two stay within
    the tolerance of the plain ones: a reordering of the sums moves these
    steps by less than the gates allow."""
    for n_classes in (EVEN, ODD):
        _, plain = _reference(n_classes)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(classifier.MultiHeadClassifier, "forward",
                       _split_head_forward)
            _, split = _one_process(n_classes)
        for g, w in zip(split, plain, strict=True):
            _hold(g["model"], w["model"], RTOL, ATOL, "reordered head")


def test_2x2_matches_the_jax_mesh_4x2(model_axis):
    """The first (center-crop) step of four ranks at (2, 2) against the JAX
    package's step on make_mesh(4, 2), on the same weights and batch."""
    ranks, _, jax_sd, _ = model_axis
    for seen in ranks["2x2"]:
        _hold(seen["mesh"]["after"][0]["model"], jax_sd, JAX_RTOL,
              JAX_ATOL, "2x2 vs JAX")


@pytest.mark.parametrize("case", ["columns", "rows", "2x2"])
def test_gathered_checkpoint_loads_in_one_process(model_axis, case):
    """Rank 0's checkpoint holds the whole head and momentum: it loads
    into a one-process classifier as it is, equals what every rank
    gathered, and cut again under the mesh it equals each rank's slices
    bitwise."""
    ranks, outs = model_axis[0][case], model_axis[3]
    restored = CheckpointManager(str(outs[case] / "ckpt")).restore()
    model = classifier.MultiPartitioningClassifier(CASES[case][1], ARCH,
                                                   torch.float32)
    model.load_state_dict(restored["model"])
    last = ranks[0]["mesh"]["after"][-1]
    for k, v in model.state_dict().items():
        assert torch.equal(v, last["model"][k]), k
    names = [k for k, _ in model.named_parameters()]
    for k, t in zip(names, restored["optimizer"]["slots"]["trace"],
                    strict=True):
        assert torch.equal(t, last["trace"][k]), k
    assert all(r["mesh"]["recut_equal"] for r in ranks)


# -- the Trainer at mesh_shape [1, 2] --------------------------------------------

def test_trainer_fit_on_the_model_axis_matches_one_process(
        tmp_path_factory):
    """Trainer.fit for 2 steps at mesh_shape [1, 2] (the real count's odd
    parity: the features split) on two ranks, against one process: the
    checkpoints' whole parameters and statistics at rtol 1e-5, their
    momentum in norm (`FIT_TRACE_RTOL`), and a resume re-cuts them to each
    rank's slices bitwise."""
    from geoestimation_tpu_torch.tools import world
    from geoestimation_tpu_torch.train.loop import Trainer
    from geoestimation_tpu_torch.utils.config import Config, load_config

    root = tmp_path_factory.mktemp("fit")
    config = Config()
    config.model_params.arch = ARCH
    config.model_params.dtype = "float32"
    tp = config.train_params
    tp.batch_size, tp.image_size, tp.num_workers = 4, 32, 1
    tp.log_every_steps, tp.checkpoint_every_steps = 1, 0
    path = world.write_shard_world(
        str(root), world.seeded_partitionings(np.random.default_rng(3), ODD),
        config, per_shard=8, n_val=4, sizes=(40, 48))
    started = torch_ranks.start(torch_ranks.mesh_fit, root, path, (1, 2))
    torch.set_num_threads(1)
    single = load_config(path)
    single.train_params.checkpoint_dir = str(root / "ckpt1")
    Trainer(single, device="cpu", log_fn=lambda *_: None).fit(
        max_steps=2, resume=False)
    torch_ranks.join(started)
    seen = [torch.load(root / f"fit{r}.pt") for r in range(2)]
    assert [s["head"] for s in seen] == [(17, 1024)] * 2
    assert all(s["resumed_equal"] and s["step"] == 2 for s in seen)
    assert seen[1]["log"] == [] and any(
        line.startswith("step 2/2") for line in seen[0]["log"])
    got = CheckpointManager(str(root / "ckpt")).restore(2)
    want = CheckpointManager(str(root / "ckpt1")).restore(2)
    _hold(got["model"], want["model"], RTOL, ATOL, "fit model")
    for g, w in zip(got["optimizer"]["slots"]["trace"],
                    want["optimizer"]["slots"]["trace"], strict=True):
        assert g.shape == w.shape
        assert float((g - w).norm() / w.norm()) <= FIT_TRACE_RTOL


# -- where a pair departs from one process in bf16 --------------------------------

def _trunk_departure(dtype):
    """One train step of the seeded state at `dtype`, plain and with only
    the fused head's float32 sum split in two: the relative difference (in
    norm) of the two updates, by group of parameters."""
    images, labels = _global_batch(ODD)
    updates = []
    for forward in (classifier.MultiHeadClassifier.forward,
                    _split_head_forward):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(classifier.MultiHeadClassifier, "forward", forward)
            state = torch_ranks.seeded_state()
            model = state.model
            if dtype != torch.float32:
                model.backbone.dtype = dtype
            before = {k: v.detach().clone()
                      for k, v in model.named_parameters()}
            step.train_step(state, torch.from_numpy(images),
                            torch.from_numpy(labels), 0, crop=CROP,
                            augment=False)
            updates.append({k: v.detach() - before[k]
                            for k, v in model.named_parameters()})
    plain, split = updates
    groups = {}
    for k, u in plain.items():
        groups.setdefault("heads" if k.startswith("heads.")
                          else "trunk", []).append(k)
    return {g: float(torch.cat([(split[k] - plain[k]).flatten()
                                for k in ks]).norm()
                     / torch.cat([plain[k].flatten() for k in ks]).norm())
            for g, ks in groups.items()}


def test_bf16_carries_a_reordered_head_sum_into_the_trunk():
    """Why a pair's trunk update departs from one process's in bf16 while
    its heads' does not (PERF.md §6): the first sum a pair orders
    differently -- here only the head's float32 sum, split in two as the
    features split computes it -- moves one bf16 step's trunk update by
    about 1e-3 in norm, a thousand times the float32 step's, while the
    heads' update stays at float32's 1e-7. On the card, one process run
    twice is bitwise equal, and a model-axis pair, which differs from one
    process only in that sum, departs by as much as a data-axis pair."""
    f32 = _trunk_departure(torch.float32)
    bf16 = _trunk_departure(torch.bfloat16)
    assert f32["trunk"] < 1e-4 and f32["heads"] < 1e-5, f32
    assert bf16["trunk"] > 1e-3 > 1e2 * f32["trunk"], (bf16, f32)
    assert bf16["heads"] < 1e-5, bf16
