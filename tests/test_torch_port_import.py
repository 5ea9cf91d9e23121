"""The port's import of a reference Lightning checkpoint against the JAX
package's: the same `.ckpt` gives exactly the state dict that the weights
bridge makes of the JAX tool's variables, and the port engine on the
imported directory predicts what the JAX engine predicts on the JAX tool's
checkpoint (fp32 on the CPU)."""

import os
import sys

import numpy as np
import pytest
import torch
import yaml

from geoestimation_tpu_torch.checkpoint import load_checkpoint
from geoestimation_tpu_torch.convert import from_jax_variables
from geoestimation_tpu_torch.models.resnet import STAGE_SIZES
from geoestimation_tpu_torch.tools import import_torch_checkpoint as port_imp
from tests.torch_port_world import one_thread_no_tensorboard  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import import_torch_checkpoint as jax_imp  # noqa: E402

ARCH = "resnet14"


def lightning_state_dict(n_classes, seed=0, prefix="model."):
    """A torchvision-layout ResNet with one Linear head per partitioning,
    as the reference's LightningModule saves it: seeded weights, BatchNorm
    statistics and counters, under `prefix`."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(shape, scale=0.05, offset=0.0):
        return torch.tensor(rng.normal(offset, scale, shape).astype(np.float32))

    def bn(name, c):
        sd[f"{name}.weight"] = t((c,), 0.2, 1.0)
        sd[f"{name}.bias"] = t((c,), 0.1)
        sd[f"{name}.running_mean"] = t((c,), 0.1)
        sd[f"{name}.running_var"] = torch.abs(t((c,), 0.2)) + 1.0
        sd[f"{name}.num_batches_tracked"] = torch.tensor(1234)

    sd["conv1.weight"] = t((64, 3, 7, 7))
    bn("bn1", 64)
    cin = 64
    for stage, n_blocks in enumerate(STAGE_SIZES[ARCH]):
        cmid = 64 * 2 ** stage
        for b in range(n_blocks):
            blk = f"layer{stage + 1}.{b}"
            sd[f"{blk}.conv1.weight"] = t((cmid, cin, 1, 1))
            bn(f"{blk}.bn1", cmid)
            sd[f"{blk}.conv2.weight"] = t((cmid, cmid, 3, 3))
            bn(f"{blk}.bn2", cmid)
            sd[f"{blk}.conv3.weight"] = t((4 * cmid, cmid, 1, 1))
            bn(f"{blk}.bn3", 4 * cmid)
            if b == 0:
                sd[f"{blk}.downsample.0.weight"] = t((4 * cmid, cin, 1, 1))
                bn(f"{blk}.downsample.1", 4 * cmid)
            cin = 4 * cmid
    for i, n in enumerate(n_classes):   # nn.ModuleList of Linear heads
        sd[f"classifier.{i}.weight"] = t((n, cin))
        sd[f"classifier.{i}.bias"] = t((n,), 0.1)
    return {prefix + k: v for k, v in sd.items()}


@pytest.fixture(scope="module")
def reference_ckpt(geo_parts, tmp_path_factory):
    root = tmp_path_factory.mktemp("lightning")
    files = []
    for p in geo_parts:
        files.append(str(root / f"{p.name}.csv"))
        p.to_csv(files[-1])
    n_classes = [len(p) for p in geo_parts]
    path = str(root / "epoch=014-val_loss=18.4833.ckpt")
    torch.save({"epoch": 14, "global_step": 1234,
                "state_dict": lightning_state_dict(n_classes),
                "hyper_parameters": {"arch": ARCH}}, path)
    return {"ckpt": path, "files": files, "n_classes": n_classes,
            "root": root}


def jax_tool_state_dict(path, n_classes):
    """The JAX tool's variables for `path`, through the weights bridge."""
    sd = jax_imp.strip_prefixes(jax_imp.load_torch_state_dict(path))
    params, stats = jax_imp.convert_backbone(sd, ARCH)
    kernel, bias = jax_imp.find_heads(sd, n_classes)
    return from_jax_variables(
        {"backbone": params,
         "heads": {"fused_head": {"kernel": kernel, "bias": bias}}},
        {"backbone": stats}, ARCH, n_classes)


def test_import_equals_weights_bridge_of_jax_tool(reference_ckpt, tmp_path):
    out = str(tmp_path / "port_ckpt")
    port_imp.main(["--torch_ckpt", reference_ckpt["ckpt"], "--cell_files",
                   *reference_ckpt["files"], "--output", out, "--arch", ARCH])
    config, got = load_checkpoint(out)
    ref = jax_tool_state_dict(reference_ckpt["ckpt"],
                              reference_ckpt["n_classes"])
    assert list(got) == list(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        assert torch.equal(got[key], ref[key]), key
    assert got["heads.fused_head.weight"].shape == (
        sum(reference_ckpt["n_classes"]), 2048)
    assert config.model_params.arch == ARCH
    assert list(config.model_params.partitionings.files) == [
        os.path.abspath(f) for f in reference_ckpt["files"]]
    with open(os.path.join(out, "hparams.yaml")) as f:
        assert yaml.safe_load(f)["model_params"]["arch"] == ARCH


def test_prefixes_and_bare_state_dicts(reference_ckpt, tmp_path):
    """Nested wrappers (`module.model.`) and a bare state dict without the
    Lightning wrapper import the same."""
    sd = lightning_state_dict(reference_ckpt["n_classes"],
                              prefix="module.model.")
    torch.save(sd, tmp_path / "bare.pt")
    got = port_imp.convert(
        port_imp.strip_prefixes(port_imp.load_torch_state_dict(
            str(tmp_path / "bare.pt"))), ARCH, reference_ckpt["n_classes"])
    ref = jax_tool_state_dict(reference_ckpt["ckpt"],
                              reference_ckpt["n_classes"])
    assert list(got) == list(ref)
    assert all(torch.equal(got[k], ref[k]) for k in ref)


def test_heads_of_equal_size_in_encounter_order():
    rng = np.random.default_rng(3)
    sd = {f"head_{c}.weight": rng.normal(0, 1, (5, 8)).astype(np.float32)
          for c in "ab"}
    sd.update({f"head_{c}.bias": rng.normal(0, 1, 5).astype(np.float32)
               for c in "ab"})
    sd["head_c.weight"] = rng.normal(0, 1, (3, 8)).astype(np.float32)
    kernel, bias = jax_imp.find_heads(sd, [5, 3, 5])
    w, b = port_imp.find_heads({k: torch.tensor(v) for k, v in sd.items()},
                               [5, 3, 5])
    np.testing.assert_array_equal(w.numpy(), kernel.T)
    np.testing.assert_array_equal(b.numpy(), bias)
    np.testing.assert_array_equal(w[:5].numpy(), sd["head_a.weight"])
    assert not b[5:8].any()   # head_c has no bias
    with pytest.raises(KeyError, match="no Linear head with 999"):
        port_imp.find_heads({k: torch.tensor(v) for k, v in sd.items()},
                            [999])


def test_engine_on_import_predicts_as_jax_engine(reference_ckpt, tmp_path):
    import jax.numpy as jnp
    from geoestimation_tpu.eval.engine import InferenceEngine as JaxEngine
    from geoestimation_tpu.train.checkpoint import load_for_inference

    from geoestimation_tpu_torch.eval.engine import InferenceEngine

    argv = ["--torch_ckpt", reference_ckpt["ckpt"], "--cell_files",
            *reference_ckpt["files"], "--arch", ARCH, "--output"]
    jax_imp.main(argv + [str(tmp_path / "jax_ckpt")])
    port_imp.main(argv + [str(tmp_path / "port_ckpt")])
    jax_config, state = load_for_inference(str(tmp_path / "jax_ckpt"))
    jax_engine = JaxEngine(jax_config, state, n_crops=10, crop=56,
                           dtype=jnp.float32)
    config, sd = load_checkpoint(str(tmp_path / "port_ckpt"))
    engine = InferenceEngine(config, sd, n_crops=10, crop=56,
                             dtype=torch.float32, device="cpu")
    images = np.random.default_rng(5).integers(0, 256, (3, 64, 64, 3),
                                               dtype=np.uint8)
    ref = jax_engine.predict_batch(images)
    got = engine.predict_batch(images)
    assert sorted(got) == sorted(ref)
    for key, (cls, lat, lng) in ref.items():
        np.testing.assert_array_equal(got[key][0], cls)
        np.testing.assert_allclose(got[key][1], lat, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[key][2], lng, rtol=0, atol=1e-5)
