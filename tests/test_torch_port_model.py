"""The port's model against the JAX package's, on the same weights: the
weights bridge, the module forward in float32 and bfloat16, and the
BN-folded fast path with the fused bottleneck (plain version on the CPU)
against the JAX fast path with the Pallas kernel in interpret mode.
resnet14 at 64 px keeps it small; its layer1 block is the projection
variant of the kernel (the identity variant is covered by
tests/test_torch_port_ops.py)."""

import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoestimation_tpu.ingest.pipeline import normalize
from geoestimation_tpu.models import MultiPartitioningClassifier
from geoestimation_tpu.models.fast_infer import build_fast_apply
from geoestimation_tpu_torch.convert import from_jax_variables
from geoestimation_tpu_torch.models import fast_infer as port_fast
from geoestimation_tpu_torch.models.classifier import (
    MultiPartitioningClassifier as PortClassifier,
)
from tests.torch_port_world import one_thread_no_tensorboard  # noqa: F401

N_CLASSES = (7, 13, 29)
ARCH = "resnet14"


def _load_tool():
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "import_torch_checkpoint.py")
    spec = importlib.util.spec_from_file_location("import_torch_checkpoint",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_vars():
    """resnet14 variables with non-trivial batch stats and BN scales."""
    model = MultiPartitioningClassifier(n_classes=N_CLASSES, arch=ARCH)
    variables = jax.jit(lambda x: model.init(jax.random.PRNGKey(0), x,
                                             train=False))(
        jnp.zeros((2, 64, 64, 3), jnp.float32))
    imgs = jax.random.normal(jax.random.PRNGKey(1), (4, 64, 64, 3))
    _, mutated = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, imgs)
    rng = np.random.default_rng(3)

    def scale_like(a):  # the zero-init bn3 scales would hide conv3
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(
        lambda path, a: scale_like(a) if path[-1].key == "scale"
        else np.asarray(a), variables["params"])
    stats = jax.tree.map(np.asarray, mutated["batch_stats"])
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    return np.array(normalize(jnp.asarray(u8), jnp.float32))


def port_model(jax_vars, dtype):
    sd = from_jax_variables(jax_vars["params"], jax_vars["batch_stats"], ARCH,
                            N_CLASSES)
    model = PortClassifier(N_CLASSES, ARCH, dtype)
    model.load_state_dict(sd, strict=True)
    return model.eval(), sd


def test_weights_bridge_round_trip(jax_vars):
    """from_jax_variables -> state dict -> the reference importer gives the
    original arrays bit for bit."""
    tool = _load_tool()
    sd, = port_model(jax_vars, torch.float32)[1:]
    sd = tool.strip_prefixes({k: v.numpy() for k, v in sd.items()})
    bb_params, bb_stats = tool.convert_backbone(sd, ARCH)
    kernel, bias = tool.find_heads(sd, [sum(N_CLASSES)])
    want_p = jax_vars["params"]["backbone"]
    want_s = jax_vars["batch_stats"]["backbone"]
    for got, want in ((bb_params, want_p), (bb_stats, want_s)):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (_, g), (_, w) in zip(flat_got, flat_want):
            np.testing.assert_array_equal(g, w)
    head = jax_vars["params"]["heads"]["fused_head"]
    np.testing.assert_array_equal(kernel, head["kernel"])
    np.testing.assert_array_equal(bias, head["bias"])


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_module_forward_matches_jax(jax_vars, images, precision):
    jdtype, tdtype = {"float32": (jnp.float32, torch.float32),
                      "bfloat16": (jnp.bfloat16, torch.bfloat16)}[precision]
    jmodel = MultiPartitioningClassifier(n_classes=N_CLASSES, arch=ARCH,
                                         dtype=jdtype)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jax_vars, jnp.asarray(images))
    model, _ = port_model(jax_vars, tdtype)
    with torch.inference_mode():
        got = model(torch.from_numpy(images))
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.dtype == np.float32 and g.shape == r.shape
        if precision == "float32":
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)
        else:  # tests/test_fast_infer.py:43 tolerance
            np.testing.assert_allclose(g, r, rtol=0.1, atol=0.15)
        np.testing.assert_array_equal(g.argmax(-1), r.argmax(-1))


def test_fast_path_with_kernel_matches_jax_pallas(jax_vars, images,
                                                  monkeypatch):
    fbmod = importlib.import_module("geoestimation_tpu.ops.fused_bottleneck")
    orig = fbmod.fused_bottleneck
    monkeypatch.setattr(
        "geoestimation_tpu.models.fast_infer.fused_bottleneck",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    ref = build_fast_apply(jax_vars, ARCH, n_classes=N_CLASSES,
                           use_pallas=True)(jnp.asarray(images))
    _, sd = port_model(jax_vars, torch.bfloat16)
    port_fb = importlib.import_module(
        "geoestimation_tpu_torch.ops.fused_bottleneck")
    launches = port_fb.fused_bottleneck.launches
    apply = port_fast.build_fast_apply(sd, ARCH, n_classes=N_CLASSES,
                                       use_pallas=True, device="cpu")
    with torch.inference_mode():
        got = apply(torch.from_numpy(images))
    # the CPU runs the plain version: no kernel launch is counted
    assert port_fb.fused_bottleneck.launches == launches
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        # tests/test_fast_infer.py:110 tolerance
        np.testing.assert_allclose(g, r, rtol=0.15, atol=0.2)
        np.testing.assert_array_equal(g.argmax(-1), r.argmax(-1))


def test_fast_path_without_kernel_matches_jax(jax_vars, images):
    ref = build_fast_apply(jax_vars, ARCH, n_classes=N_CLASSES,
                           use_pallas=False)(jnp.asarray(images))
    _, sd = port_model(jax_vars, torch.bfloat16)
    with torch.inference_mode():
        got = port_fast.build_fast_apply(
            sd, ARCH, n_classes=N_CLASSES, use_pallas=False,
            device="cpu")(torch.from_numpy(images))
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0.1, atol=0.15)
        np.testing.assert_array_equal(g.argmax(-1), r.argmax(-1))


def test_fast_path_matches_module_path(jax_vars, images):
    """Within the port: the folded path with the kernel's plain version
    against the unfolded bf16 module path, at the tolerance chip_smoke.py
    holds the card's run to (tests/test_fast_infer.py:110)."""
    model, sd = port_model(jax_vars, torch.bfloat16)
    apply = port_fast.build_fast_apply(sd, ARCH, n_classes=N_CLASSES,
                                       use_pallas=True, device="cpu")
    x = torch.from_numpy(images)
    with torch.inference_mode():
        for g, r in zip(apply(x), model(x)):
            torch.testing.assert_close(g, r, rtol=0.15, atol=0.2)
            assert torch.equal(g.argmax(-1), r.argmax(-1))


def _counting(calls, fn, **extra):
    """`fn` that first records the NHWC shape of its input in `calls`."""
    def wrapper(x, *args, **kwargs):
        calls.append(tuple(x.shape))
        return fn(x, *args, **{**kwargs, **extra})
    return wrapper


def test_fast_path_with_both_kernels_matches_jax_pallas(jax_vars, images,
                                                        monkeypatch):
    """use_pallas_s2: the port (plain versions on the CPU) against the JAX
    fast path with both Pallas kernels in interpret mode. At 64 px the stage
    entries of layer2 (16 wide) and layer3 (8 wide) take the stride-2
    kernel on both sides; layer4's (4 wide) stays on the convolutions."""
    jfb = importlib.import_module("geoestimation_tpu.ops.fused_bottleneck")
    jax_s2, port_s2 = [], []
    monkeypatch.setattr(
        "geoestimation_tpu.models.fast_infer.fused_bottleneck",
        lambda *a, **k: jfb.fused_bottleneck(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(
        "geoestimation_tpu.models.fast_infer.fused_bottleneck_s2",
        _counting(jax_s2, jfb.fused_bottleneck_s2, interpret=True))
    ref = build_fast_apply(jax_vars, ARCH, n_classes=N_CLASSES,
                           use_pallas=True,
                           use_pallas_s2=True)(jnp.asarray(images))
    monkeypatch.setattr(port_fast, "fused_bottleneck_s2",
                        _counting(port_s2, port_fast.fused_bottleneck_s2))
    _, sd = port_model(jax_vars, torch.bfloat16)
    apply = port_fast.build_fast_apply(sd, ARCH, n_classes=N_CLASSES,
                                       use_pallas=True, use_pallas_s2=True,
                                       device="cpu")
    with torch.inference_mode():
        got = apply(torch.from_numpy(images))
    assert jax_s2 == port_s2 == [(2, 16, 16, 256), (2, 8, 8, 512)]
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0.15, atol=0.2)
        np.testing.assert_array_equal(g.argmax(-1), r.argmax(-1))


def test_stage_fns_and_head_reproduce_apply(jax_vars, images):
    _, sd = port_model(jax_vars, torch.bfloat16)
    apply = port_fast.build_fast_apply(sd, ARCH, n_classes=N_CLASSES,
                                       use_pallas=True, use_pallas_s2=True,
                                       device="cpu")
    assert len(apply.stage_fns) == 5   # stem, layer1..4
    x = torch.from_numpy(images)
    with torch.inference_mode():
        want = apply(x)
        for fn in apply.stage_fns:
            x = fn(x)
        got = apply.head_logits(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- routing at ResNet50, 224 px --------------------------------------------

R50_CLASSES = (5, 7, 11)


@pytest.fixture(scope="module")
def r50_weights():
    """Seeded full-width ResNet50 weights: the JAX tree and the port's
    state dict."""
    from geoestimation_tpu_torch.tools.world import seeded_jax_variables

    params, stats = seeded_jax_variables(np.random.default_rng(0),
                                         "resnet50", R50_CLASSES)
    return ({"params": params, "batch_stats": stats},
            from_jax_variables(params, stats, "resnet50", R50_CLASSES))


def _jax_routes(monkeypatch, calls):
    """Replaces the JAX fast path's block functions by recorders that give
    zeros of the block's output shape: (route, NHWC input at its logical
    width) per block."""
    def pallas(x, fb, npi, stride=1, logical_w=None):
        b, h, w, c = x.shape
        calls.append(("fused" if stride == 1 else "fused_s2",
                      (b, h, logical_w or w, c)))
        hw = (h, w) if stride == 1 else (h // 2, w // 2)
        return jnp.zeros((b, *hw, fb["conv3"][0].shape[-1]), jnp.bfloat16)

    def xla(x, fb, stride, mirror=False):
        b, h, w, c = x.shape
        calls.append(("conv", (b, h, w, c)))
        return jnp.zeros((b, h // stride, w // stride,
                          fb["conv3"][0].shape[-1]), jnp.bfloat16)

    monkeypatch.setattr("geoestimation_tpu.models.fast_infer._pallas_block",
                        pallas)
    monkeypatch.setattr("geoestimation_tpu.models.fast_infer._xla_block", xla)


def _port_routes(monkeypatch, calls):
    """The same recorders around the port's kernel wrappers (NHWC in) and
    its convolution block (NCHW channels-last in)."""
    def kernel(route, stride):
        def rec(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None):
            b, h, w, _ = x.shape
            calls.append((route, tuple(x.shape)))
            return torch.zeros((b, h // stride, w // stride, w3.shape[0]),
                               dtype=torch.bfloat16)
        return rec

    def conv(x, weights, stride, mirror=False):
        b, c, h, w = x.shape
        calls.append(("conv", (b, h, w, c)))
        out = torch.zeros((b, weights[2][0].shape[0], h // stride,
                           w // stride), dtype=torch.bfloat16)
        return out.contiguous(memory_format=torch.channels_last)

    monkeypatch.setattr(port_fast, "fused_bottleneck", kernel("fused", 1))
    monkeypatch.setattr(port_fast, "fused_bottleneck_s2",
                        kernel("fused_s2", 2))
    monkeypatch.setattr(port_fast, "_conv_block", conv)


@pytest.mark.parametrize("batch,kw,n_fused,n_s2", [
    (2, dict(use_pallas=True), 6, 0),                          # default
    (2, dict(use_pallas=True, use_pallas_s2=True), 6, 1),
    (1, dict(use_pallas=True, use_pallas_s2=True), 3, 1),      # odd batch
    (2, dict(use_pallas=True, use_pallas_s2=True,
             pallas_stages={}), 0, 1),
    (2, dict(use_pallas=False, use_pallas_s2=True), 0, 0),
])
def test_routing_matches_jax_at_resnet50(r50_weights, monkeypatch, batch, kw,
                                         n_fused, n_s2):
    """The port sends the same blocks to the same functions as the JAX
    package, decided on the activation's shape: a stage entry takes the
    stride-2 kernel only when its input width is a multiple of 8 (at
    224 px, layer2.0 alone), layer2's stride-1 blocks only when the batch
    divides by their images-per-tile (2), and `pallas_stages={}` sends no
    stride-1 block to the kernel."""
    jax_vars, sd = r50_weights
    images = np.zeros((batch, 224, 224, 3), np.float32)
    want, got = [], []
    _jax_routes(monkeypatch, want)
    build_fast_apply(jax_vars, "resnet50", n_classes=R50_CLASSES,
                     **kw)(jnp.asarray(images))
    _port_routes(monkeypatch, got)
    with torch.inference_mode():
        port_fast.build_fast_apply(sd, "resnet50", n_classes=R50_CLASSES,
                                   device="cpu",
                                   **kw)(torch.from_numpy(images))
    assert got == want and len(got) == 16
    assert [r for r, _ in got].count("fused") == n_fused
    s2 = [shape for r, shape in got if r == "fused_s2"]
    assert s2 == [(batch, 56, 56, 256)] * n_s2
