"""The port's host-ingest, end-to-end eval and int8-stem tools against the
JAX package's (`tools/bench_ingest.py`, `tools/bench_e2e_eval.py`,
`tools/bench_stem.py`), on the CPU: the same JPEG bytes and corpus, the
same output labels and result keys, and every stem form bit for bit the
shipped space-to-depth form, which is bit for bit the JAX tool's."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from geoestimation_tpu_torch.ingest import decode
from geoestimation_tpu_torch.tools import bench_e2e_eval, bench_ingest
from geoestimation_tpu_torch.tools import bench_stem
from tests.torch_port_world import one_thread_no_tensorboard  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("content,size", [("photo", (48, 40)),
                                          ("noise", (40, 32))])
def test_make_jpegs_bytes_equal_jax(content, size):
    from tools.bench_ingest import make_jpegs as jax_make_jpegs

    got = bench_ingest.make_jpegs(3, size=size, seed=5, content=content)
    assert got == jax_make_jpegs(3, size=size, seed=5, content=content)
    assert len(set(got)) == 3


@pytest.mark.parametrize("img_size", [0, 96])
def test_generate_corpus_bytes_equal_jax(tmp_path, img_size):
    from tools.bench_e2e_eval import generate_corpus as jax_corpus

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_corpus(str(tmp_path / "jax"), 5, seed=3, img_size=img_size)
    bench_e2e_eval.generate_corpus(str(tmp_path / "port"), 5, seed=3,
                                   img_size=img_size)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 5
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


def test_bench_ingest_prints_the_jax_labels(capsys):
    results = bench_ingest.main(["--n", "4", "--iters", "1"])
    lines = capsys.readouterr().out.splitlines()
    want = (["turbo", "turbo+fast"] if decode.native.available() else []) \
        + ["pil", "pil+fast"]
    assert [l.split(":")[0].strip() for l in lines] == want
    assert [r["backend"] for r in results] == want
    cores = os.cpu_count() or 1
    for line in lines:
        assert " images/sec (" in line and f"/core x {cores} cores; 4 photo " \
            "blobs of 320x280" in line and "x 1 iters, threads=auto)" in line


def _jax_result_keys():
    """The keys of the `result = {...}` literal of the JAX tool."""
    tree = ast.parse((REPO / "tools" / "bench_e2e_eval.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "result"
                        for t in node.targets):
            return [k.value for k in node.value.keys]
    raise AssertionError("no result literal in tools/bench_e2e_eval.py")


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_bench_e2e_eval_cpu_result_keys(precision, tmp_path, capsys):
    out = tmp_path / "e2e.json"
    result = bench_e2e_eval.main([
        "--cpu", "--arch", "resnet14", "--n_images", "8", "--batch_size", "4",
        "--crops", "1", "--precision", precision, "--json", str(out)])
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert list(printed) == _jax_result_keys()
    assert printed == result == json.loads(out.read_text())
    assert result["n_images"] == 8 and result["platform"] == "cpu"
    assert result["precision"] == precision
    for key in ("value", "device_busy_frac", "device_resident_images_per_sec",
                "host_decode_images_per_sec_per_core",
                "host_cores_per_chip_budget"):
        assert np.isfinite(result[key]) and result[key] > 0, key


def test_bench_e2e_eval_counts_conv_s8_launches(monkeypatch):
    """The int8 forward runs every convolution through `conv_s8`: 17 calls
    for resnet14 (the stem and 4 blocks of 4), none in bf16."""
    from geoestimation_tpu_torch.models import quant

    calls = []
    real = quant.conv_s8
    monkeypatch.setattr(quant, "conv_s8",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (2, 256, 256, 3), dtype=np.uint8))
    cls, lat, lng = bench_e2e_eval.build_forward("resnet14", "int8", 1,
                                                 "cpu")(x)
    assert len(calls) == 17
    assert cls.shape == lat.shape == lng.shape == (2,)
    assert bool(torch.isfinite(lat).all() and torch.isfinite(lng).all())
    calls.clear()
    bench_e2e_eval.build_forward("resnet14", "bf16", 1, "cpu")(x)
    assert calls == []


def test_synthetic_harrays_equal_jax():
    from __graft_entry__ import _synthetic_harrays

    want = _synthetic_harrays((5, 9, 20))
    got = bench_e2e_eval.synthetic_harrays((5, 9, 20), "cpu")
    for g, w in zip(got.maps + got.lats + got.lngs,
                    want.maps + want.lats + want.lngs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.valid.all() and got.names == tuple(want.names)


@pytest.fixture(scope="module")
def stem_inputs():
    rng = np.random.default_rng(0)
    stem = bench_stem.seeded_stem(rng)
    x = rng.integers(-128, 128, (2, 224, 224, 3)).astype(np.int8)
    return stem, x


def test_stem_forms_bitwise_s2d_and_jax(stem_inputs):
    import jax
    import jax.numpy as jnp
    from tools.bench_stem import build_variants as jax_variants

    stem, x = stem_inputs
    forms = bench_stem.build_variants(*stem, "cpu")
    library = bench_stem.build_variants(*stem, "cpu", library=True)
    assert list(forms) == list(bench_stem.FORMS)
    assert bench_stem.check_forms(forms, library, torch.as_tensor(x)) == \
        (2, 56, 56, 64)
    got = forms["s2d"](torch.as_tensor(x)).numpy()
    want = np.asarray(jax.jit(jax_variants(*stem, "reduce_window")["s2d"])(
        jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    # the requant is not saturated: over 100 distinct codes
    assert len(np.unique(got)) > 100


def test_stem_float32_library_route_within_one_code(stem_inputs):
    """The timed library route (float32 requant, not the kernel's FMA) is
    s2d's output give or take one code where the rounding differs, and its
    gemm is the exact library route's integer sums."""
    stem, x = stem_inputs
    x = torch.as_tensor(x)
    forms = bench_stem.build_variants(*stem, "cpu")
    ref = forms["s2d"](x).int()
    for name in bench_stem.FORMS:
        got = forms[name].float32(x)
        assert got.shape == ref.shape and got.dtype == torch.int8
        assert int((got.int() - ref).abs().max()) <= 1
    acc = forms["s2d"].gemm(x)
    assert acc.dtype == torch.int32 and acc.shape == (2 * 112 * 112, 64)


def test_stem_check_catches_a_differing_form(stem_inputs):
    stem, x = stem_inputs
    forms = bench_stem.build_variants(*stem, "cpu")
    library = bench_stem.build_variants(*stem, "cpu", library=True)
    real = forms["hfold48"]

    def one_bit_off(t):
        out = real(t).clone()
        out[0, 0, 0, 0] ^= 1
        return out

    forms["hfold48"] = one_bit_off
    with pytest.raises(RuntimeError, match="hfold48 \\(conv_s8\\)"):
        bench_stem.check_forms(forms, library, torch.as_tensor(x))


def test_card_tools_refuse_without_cuda(monkeypatch):
    from geoestimation_tpu_torch.tools import train_roofline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="bench_stem"):
        bench_stem.main(["--crops", "4", "--iters", "1"])
    with pytest.raises(SystemExit, match="train_roofline"):
        train_roofline.main(["--batch", "2", "--iters", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_e2e_eval.main(["--arch", "resnet14", "--n_images", "1"])
    with pytest.raises(SystemExit, match="unknown pool mode"):
        bench_stem.main(["--pool_modes", "window"])


@pytest.mark.slow     # the JAX tool's bf16 resnet14 graph on the CPU: ~40 s
def test_bench_e2e_eval_matches_jax_tool(tmp_path):
    """The JAX tool's own run on the CPU: the same keys and image count."""
    args = ["--cpu", "--arch", "resnet14", "--n_images", "8",
            "--batch_size", "4", "--crops", "1", "--precision", "bf16",
            "--json"]
    subprocess.run([sys.executable, str(REPO / "tools" / "bench_e2e_eval.py"),
                    *args, str(tmp_path / "jax.json")], check=True, cwd=REPO,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=600)
    ref = json.loads((tmp_path / "jax.json").read_text())
    got = bench_e2e_eval.main(args + [str(tmp_path / "port.json")])
    assert list(got) == list(ref)
    for key in ("n_images", "batch_size", "crops", "precision", "arch",
                "fast_decode", "img_size", "platform"):
        assert got[key] == ref[key], key
