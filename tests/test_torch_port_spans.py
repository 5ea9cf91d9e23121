"""The port's spans and counters (`utils/spans.py`): off unless a torch
profiler records, FUNCTION-scope ranges in the profiler's trace with their
parents, the bounded record, the engine's and the train step's spans on the
CPU, and the benchmark's readers of them."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from geoestimation_tpu_torch.utils import spans
from tests.torch_port_world import one_thread_no_tensorboard  # noqa: F401

READERS = {   # the benchmark's readers of the spans: (span, key per call)
    "engine.upload_gbps": None, "engine.host_ms": None,
    "models.forward_ms": ("models.forward", "device_s"),
    "models.stem_ms": ("models.stem", "device_s"),
    "train.forward_ms": ("train.forward", "device_s"),
    "train.backward_ms": ("train.backward", "device_s"),
    "train.optimizer_ms": ("train.optimizer", "device_s"),
}


@pytest.fixture(autouse=True)
def fresh_record():
    """An empty record."""
    spans.reset()
    yield
    spans.reset()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_keeps_nothing():
    """With no profiler recording, a span is the one shared no-op and keeps
    no record, and a counter does not count."""
    assert not torch.autograd.profiler._is_profiler_enabled
    first = spans.span("engine.upload", device=True)
    assert spans.span("models.forward", request=3) is first
    with first:
        with spans.span("models.stem"):
            spans.count("engine.upload_bytes", 7)
    s = spans.summary()
    assert s["spans"] == {} and spans.records() == [] and s["dropped"] == 0
    assert s["counters"] == {}


def test_spans_are_function_scope_events_with_parents():
    """Under a CPU profiler each span is a FUNCTION-scope event (scope 0,
    not a user annotation) nested in its parent's, and the record keeps the
    parent's index, the root's request id and the counter's count."""
    spans.count("engine.upload_bytes", 5)
    with cpu_profile() as prof:
        for call in (1, 2):
            with spans.span("engine.predict_batch", request=call):
                with spans.span("models.forward", device=True):
                    with spans.span("models.stem", device=True):
                        torch.ones(4).add_(1)
                spans.count("engine.upload_bytes", 100)
    ours = [e for e in prof.events() if e.name.split(".")[0] in
            ("engine", "models")]
    assert len(ours) == 6
    scopes = torch._C._profiler.RecordScope
    assert all(e.scope == int(scopes.FUNCTION) != int(scopes.USER_SCOPE)
               for e in ours)
    parent = {"models.forward": "engine.predict_batch",
              "models.stem": "models.forward"}
    for e in ours:
        want = parent.get(e.name)
        assert (e.cpu_parent.name if e.cpu_parent else None) == want
    recs = spans.records()
    assert [(name, p, req) for name, _, _, p, req in recs] == [
        ("engine.predict_batch", -1, 1), ("models.forward", 0, 1),
        ("models.stem", 1, 1), ("engine.predict_batch", -1, 2),
        ("models.forward", 3, 2), ("models.stem", 4, 2)]
    assert all(t1 >= t0 for _, t0, t1, _, _ in recs)
    s = spans.summary()
    assert {k: v["calls"] for k, v in s["spans"].items()} == {
        "engine.predict_batch": 2, "models.forward": 2, "models.stem": 2}
    # no card: a device span keeps host time only
    assert all(v["device_s"] is None for v in s["spans"].values())
    root = s["spans"]["engine.predict_batch"]
    fwd = s["spans"]["models.forward"]
    assert root["self_host_s"] == pytest.approx(
        root["host_s"] - fwd["host_s"], abs=1e-9)
    assert s["counters"] == {"engine.upload_bytes": 200}


def test_the_bound_counts_its_drops(monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 3)
    with cpu_profile():
        for i in range(5):
            with spans.span("models.forward", request=i):
                with spans.span("models.stem"):
                    pass
    s = spans.summary()
    assert len(spans.records()) == 3 and s["dropped"] == 7
    assert s["spans"]["models.forward"]["calls"] == 2
    assert s["spans"]["models.stem"]["calls"] == 1


@pytest.fixture(scope="module")
def tiny_world():
    """A resnet14 state dict in the port's layout and three nested seeded
    partitionings (6, 12, 24 cells)."""
    from geoestimation_tpu_torch.convert import from_jax_variables
    from geoestimation_tpu_torch.tools import world

    rng = np.random.default_rng(15)
    counts = (6, 12, 24)
    parts = world.seeded_partitionings(rng, counts)
    params, stats = world.seeded_jax_variables(rng, "resnet14", counts)
    return from_jax_variables(params, stats, "resnet14", counts), parts


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_engine_records_its_spans(tiny_world, precision):
    """A CPU `predict_batch` (five crops of 32 px from 40 px photos) records
    the engine's and the model's spans, every one of a call under its
    call's request id, and counts the uploaded bytes."""
    from geoestimation_tpu_torch.eval.engine import InferenceEngine
    from geoestimation_tpu_torch.utils.config import Config

    sd, parts = tiny_world
    config = Config()
    config.model_params.arch = "resnet14"
    config.model_params.partitionings.shortnames = [p.name for p in parts]
    kw = (dict(int8=True, calib_stat="absmax", int8_persist=False)
          if precision == "int8" else dict(fast=True, use_pallas=True))
    engine = InferenceEngine(config, sd, partitionings=parts, n_crops=5,
                             crop=32, device="cpu", **kw)
    images = np.random.default_rng(1).integers(0, 255, (2, 40, 40, 3),
                                               dtype=np.uint8)
    engine.predict_batch(images)   # the int8 engine calibrates here
    spans.reset()
    with cpu_profile():
        for _ in range(2):
            engine.predict_batch(images)
    recs = spans.records()
    names = {name for name, *_ in recs}
    want = {"engine.predict_batch", "engine.upload", "engine.wait",
            "models.forward", "models.stem", "models.fstar"}
    assert names == want
    roots = [(i, req) for i, (name, _, _, p, req) in enumerate(recs)
             if name == "engine.predict_batch"]
    assert [req for _, req in roots] == [2, 3] and all(
        recs[i][3] == -1 for i, _ in roots)
    for i, (_, _, _, parent, req) in enumerate(recs):
        root = max(j for j, _ in roots if j <= i)
        assert req == recs[root][4]
        assert (parent == -1) == (i == root)
    s = spans.summary()
    assert s["spans"]["models.stem"]["calls"] == 2
    assert s["counters"] == {"engine.upload_bytes": 2 * images.nbytes}


def test_train_step_records_its_stages():
    """One CPU train step, inside a `train.step` span as the trainer opens
    one, records its forward, backward and optimizer stages as that step's
    children (the all-reduce a no-op in one process, its span kept)."""
    from geoestimation_tpu_torch.models.classifier import (
        MultiPartitioningClassifier,
    )
    from geoestimation_tpu_torch.train import optim, step
    from geoestimation_tpu_torch.utils.config import Config

    torch.manual_seed(0)
    model = MultiPartitioningClassifier((3, 5, 9), "resnet14", torch.float32)
    tp = Config().train_params
    state = step.TrainState(model, optim.build_optimizer(
        model.parameters(), tp.optimizer, tp.lr_schedule, 10))
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 255, (4, 40, 40, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(np.stack([rng.integers(0, n, 4)
                                        for n in (3, 5, 9)]))
    with cpu_profile():
        with spans.span("train.step", request=state.step):
            step.train_step(state, images, labels, 0, crop=32)
    recs = spans.records()
    assert [(name, p, req) for name, _, _, p, req in recs] == [
        ("train.step", -1, 0), ("train.forward", 0, 0),
        ("train.backward", 0, 0), ("train.all_reduce", 0, 0),
        ("train.optimizer", 0, 0)]
    assert state.step == 1


def _load_reader(name):
    from geobench import harness

    return harness.load_module("metrics", name)


def _ms(t):
    return int(t * 1e6)


# two planted `predict_batch` calls of 20 ms: 12 ms in `engine.wait`, 2 ms
# in a wait under `models.forward`, whose own nested wait counts once; a
# wait outside any call is not subtracted
PLANTED_RECORDS = [
    ("engine.predict_batch", _ms(0), _ms(20), -1, 1),
    ("models.forward", _ms(1), _ms(7), 0, 1),
    ("models.wait", _ms(4), _ms(6), 1, 1),
    ("other.wait", _ms(4), _ms(5), 2, 1),
    ("engine.wait", _ms(8), _ms(20), 0, 1),
    ("engine.predict_batch", _ms(30), _ms(50), -1, 2),
    ("engine.wait", _ms(36), _ms(50), 5, 2),
    ("serve.wait", _ms(60), _ms(90), -1, None),
]


def test_host_less_waits_subtracts_the_outermost_waits_inside_the_root(
        monkeypatch):
    """The host's own work in a root span: its time less every outermost
    `.wait` span beneath it, however deep, and nothing outside it."""
    from geobench.metrics._spans import host_less_waits_ms

    monkeypatch.setattr(spans, "records", lambda: PLANTED_RECORDS)
    traced = {"trace": object()}
    assert host_less_waits_ms(traced, "engine.predict_batch") == \
        pytest.approx(((20 - 2 - 12) + (20 - 14)) / 2)
    assert host_less_waits_ms(traced, "train.step") is None
    assert host_less_waits_ms({"trace": None}, "engine.predict_batch") is None


def test_fstar_makes_no_tensor_from_host_data(monkeypatch):
    """f* launches without a copy from host memory: on the card such a
    copy would wait for the forward, hiding the host's wait inside
    `models.fstar` rather than in `engine.wait`."""
    from geoestimation_tpu_torch.eval import infer

    harrays = infer.HierarchyArrays(
        maps=(torch.tensor([0, 0, 1]), torch.tensor([0, 1, 2])),
        valid=torch.tensor([True, False, True]),
        lats=(torch.zeros(2), torch.arange(3.0)),
        lngs=(torch.zeros(2), -torch.arange(3.0)), names=("a", "b"))
    logits = [torch.tensor([[0.0, 2.0], [1.0, 0.0]]),
              torch.tensor([[0.0, 9.0, 1.0], [3.0, 9.0, 0.0]])]

    def no_host_tensor(*a, **k):
        raise AssertionError("f* made a tensor from host data")

    monkeypatch.setattr(infer.torch, "tensor", no_host_tensor)
    scores = infer.hierarchical_log_probs(logits, harrays)
    assert torch.isneginf(scores[:, 1]).all()
    cls, lat, lng = infer.predict_hierarchical(logits, harrays)
    assert cls.tolist() == [2, 0] and lat.tolist() == [2.0, 0.0]


@pytest.mark.parametrize("name", sorted(READERS))
def test_benchmark_reader(name, monkeypatch):
    """Each reader of the spans reports nothing without a traced window or
    on an empty summary, and the right number from a planted one."""
    reader = _load_reader(name)
    traced = {"trace": object()}
    assert reader.read({"trace": None}) is None
    assert reader.read(traced) is None      # nothing recorded
    planted = {"spans": {
        "engine.predict_batch": dict(calls=4, host_s=0.2, self_host_s=0.1,
                                     device_s=None),
        "engine.wait": dict(calls=4, host_s=0.12, self_host_s=0.12,
                            device_s=None),
        "engine.upload": dict(calls=4, host_s=0.02, self_host_s=0.02,
                              device_s=0.008),
        **{span: dict(calls=4, host_s=0.4, self_host_s=0.3, device_s=0.1)
           for span in ("models.forward", "models.stem", "train.step",
                        "train.forward", "train.backward", "train.optimizer")},
    }, "counters": {"engine.upload_bytes": 4 * 10 ** 7}, "dropped": 0}
    monkeypatch.setattr(spans, "summary", lambda: planted)
    monkeypatch.setattr(spans, "records", lambda: PLANTED_RECORDS)
    want = {"engine.upload_gbps": 4e7 / 0.008 / 1e9,
            "engine.host_ms": 6.0}.get(name)
    if want is None:
        span, key = READERS[name]
        want = 1e3 * planted["spans"][span][key] / 4
    assert reader.read(traced) == pytest.approx(want)
    assert reader.read({"trace": None}) is None


def test_span_check_splits_a_roots_blocking_time():
    """`geoestimation_tpu_torch/tools/span_check.py`'s reduction of a traced
    window: per call of a root span, its wall, its outermost `.wait` spans,
    and the blocking runtime calls inside and outside them (times in
    microseconds)."""
    from geoestimation_tpu_torch.tools import span_check as check

    host = [
        ("engine.predict_batch", 0, 20000),
        ("engine.upload", 100, 2100),
        ("cudaMemcpyAsync", 200, 1800),
        ("cudaStreamSynchronize", 1800, 2000),
        ("cudaLaunchKernel", 2200, 2210),
        ("engine.wait", 8000, 20000),
        ("models.wait", 9000, 9500),      # inside a wait: counted once
        ("cudaMemcpyAsync", 8100, 19900),
        ("engine.predict_batch", 30000, 40000),
        ("engine.wait", 36000, 40000),
        ("cudaStreamSynchronize", 50000, 51000),   # outside every call
    ]
    got = check.blocking(host, "engine.predict_batch")
    assert got["calls"] == 2
    assert got["root_ms"] == pytest.approx(15.0)
    assert got["wait_ms"] == pytest.approx(8.0)
    assert got["host_ms"] == pytest.approx(7.0)
    assert got["blocking_ms"] == pytest.approx((1600 + 200 + 11800) / 2e3)
    assert got["blocking_outside_waits_ms"] == pytest.approx(0.9)
    assert check.blocking(host, "train.step") is None
