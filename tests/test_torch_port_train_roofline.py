"""The port's train-step roofline tool against the JAX package's
(`tools/train_roofline.py`), on the CPU: the collective audit of a 2-rank
gloo data axis bucketed as the JAX tool buckets its mesh's all-reduces, its
byte counts derived from the JAX model's parameters and BatchNorm channels,
and the roofline's operation and byte counters on a tiny step."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoestimation_tpu_torch.tools import bench_train, train_roofline
from tests.torch_port_world import one_thread_no_tensorboard  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
AUDIT = ["--collectives", "2", "--arch", "resnet14", "--batch", "4",
         "--cpu_crop", "32"]
CLASSES = (3298, 7202, 12893)      # the published counts, the tool's heads


@pytest.fixture(scope="module")
def jax_shapes():
    """(parameter count, [channels of each BatchNorm]) of the JAX resnet14
    classifier at the published class counts, from flax's init (shapes
    only)."""
    from geoestimation_tpu.models import MultiPartitioningClassifier

    model = MultiPartitioningClassifier(n_classes=CLASSES, arch="resnet14",
                                        dtype=jnp.bfloat16)
    variables = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    n_params = sum(int(np.prod(x.shape))
                   for x in jax.tree.leaves(variables["params"]))
    channels = [x.shape[0] for path, x in
                jax.tree_util.tree_flatten_with_path(
                    variables["batch_stats"])[0]
                if path[-1].key == "mean"]
    return n_params, channels


@pytest.fixture(scope="module")
def audit():
    return train_roofline.main(AUDIT)


def test_collective_audit_counts_from_the_jax_model(audit, jax_shapes):
    """grad_psum: one all-reduce of every float32 gradient; bn_stats: each
    BatchNorm's (sum, sum of squares, count) in the forward, 2C + 1
    float32, and the backward's per-channel sums of the gradient and of its
    product with the normalized input, 2C float32; the rest: the loss's
    valid counts and the metrics."""
    n_params, channels = jax_shapes
    b = audit["buckets"]
    assert len(channels) == 17
    assert b["grad_psum"] == {"n": 1, "bytes": 4 * n_params}
    assert b["bn_stats"] == {"n": 2 * len(channels),
                             "bytes": sum(4 * (2 * c + 1) + 4 * 2 * c
                                          for c in channels)}
    assert b["other_small"]["n"] == 2
    assert set(audit["callers"]) == {
        "all_reduce in all_reduce_grads.<locals>.reduce",
        "all_reduce in sum_over_ranks",
        "all_reduce in sum_bn_grads", "all_reduce in device_sum"}
    total = sum(v["bytes"] for v in b.values())
    assert audit["bn_share_of_collective_bytes"] == round(
        b["bn_stats"]["bytes"] / total, 6)
    assert (audit["metric"], audit["mesh_devices"], audit["batch"]) == (
        "train_step_collectives_resnet14", 2, 4)


def _conv_flops(arch, n, crop):
    """(multiply-adds x 2 of every convolution's forward, the stem's) of
    the v1.5 bottleneck ResNet at `crop` px, its stages those of the JAX
    package's model."""
    from geoestimation_tpu.models.resnet import ARCHS

    def conv(h, cin, cout, k, s):
        ho = (h - 1) // s + 1
        return ho, 2 * n * ho * ho * cout * cin * k * k

    h, stem = conv(crop, 3, 64, 7, 2)
    total, h, cin = stem, (h - 1) // 2 + 1, 64
    for stage, blocks in enumerate(ARCHS[arch]().stage_sizes):
        mid = 64 * 2 ** stage
        for b in range(blocks):
            s = 2 if stage > 0 and b == 0 else 1
            parts = [conv(h, cin, mid, 1, 1), conv(h, mid, mid, 3, s)]
            ho = parts[-1][0]
            parts.append(conv(ho, mid, 4 * mid, 1, 1))
            if b == 0:
                parts.append(conv(h, cin, 4 * mid, 1, s))
            total += sum(f for _, f in parts)
            h, cin = ho, 4 * mid
    return total, stem


def test_count_step_flops_are_the_step_convolutions_and_heads():
    """One step's counted operations: every convolution forward, its
    gradients by input (not the stem's: the images need none) and by
    weight; the heads' matrix product and its two gradients."""
    n, crop, classes = 2, 32, (3, 5, 9)
    _, _, _, step = bench_train.setup(n, "resnet14", device="cpu",
                                      n_classes=classes, crop=crop,
                                      base=crop + 8)
    flops, nbytes, ops = train_roofline.count_step(step)
    conv, stem = _conv_flops("resnet14", n, crop)
    head = 2 * n * 2048 * sum(classes)
    assert flops == 3 * conv - stem + 3 * head
    assert nbytes > 0 and ops > 100


def test_bytes_accessed_counts_inputs_and_outputs_not_views():
    a, b = torch.ones(4, 4), torch.ones(4, 4)
    with train_roofline.BytesAccessed() as counted:
        c = a + b                  # two inputs read, one output written
        c.view(16)                 # a view moves nothing
        torch.empty(5)             # nor an uninitialized allocation
        c.add_(a)                  # in place: c, a read; c written
    assert (counted.bytes, counted.ops) == (6 * 64, 2)


@pytest.mark.slow     # the JAX tool's compile on a 2-device CPU mesh: ~40 s
def test_collective_audit_against_the_jax_tool(audit, jax_shapes):
    """The JAX tool's own audit at the same settings. Both take one
    gradient all-reduce. XLA's also holds the step's 3 loss scalars, and
    of the BatchNorm parameters' gradients only one of each block
    BatchNorm's two and neither of the stem's: XLA reads the others from
    the BatchNorm backward's all-reduces of the same sums. So it is
    4 x (the sum of every BatchNorm's C + the stem's C - 3) bytes short of
    every gradient's."""
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "train_roofline.py"), *AUDIT],
        check=True, capture_output=True, text=True, cwd=REPO, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}).stdout
    ref = json.loads(out[out.index("{"):])
    n_params, channels = jax_shapes
    got, want = audit["buckets"], ref["buckets"]
    assert got["grad_psum"]["n"] == want["grad_psum"]["n"] == 1
    assert got["grad_psum"]["bytes"] == 4 * n_params
    assert want["grad_psum"]["bytes"] == 4 * (n_params - sum(channels)
                                              - channels[0] + 3)
    assert (ref["mesh_devices"], ref["batch"], ref["metric"]) == (
        audit["mesh_devices"], audit["batch"], audit["metric"])
