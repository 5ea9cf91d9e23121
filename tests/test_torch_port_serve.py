"""The port's inference server: the micro-batcher, the HTTP endpoints, and
its answers against the JAX server's on the same JPEGs and weights (fp32 on
the CPU), as tests/test_serve.py checks the JAX server. Both servers decode
on their native backend."""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from geoestimation_tpu_torch.ingest import decode as port_decode
from geoestimation_tpu_torch.serve import GeoInferenceServer, MicroBatcher
from geoestimation_tpu_torch.serve import server as port_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE, CROP = 64, 56


def jpeg_bytes(seed, h=300, w=280):
    arr = np.random.default_rng(seed).integers(0, 255, (h, w, 3),
                                               dtype=np.uint8)
    b = io.BytesIO()
    Image.fromarray(arr).save(b, format="JPEG", quality=88)
    return b.getvalue()


def fake_predict(calls):
    def predict(images):
        calls.append(images.copy())
        n = images.shape[0]
        return {"hierarchy": (np.zeros(n, np.int32),
                              np.full(n, 1.0, np.float32),
                              np.full(n, 2.0, np.float32))}

    return predict


class TestMicroBatcher:
    def test_batches_concurrent_requests(self):
        calls = []
        mb = MicroBatcher(fake_predict(calls), batch_size=4, max_wait_ms=50,
                          base_size=8)
        imgs = [np.full((8, 8, 3), i, np.uint8) for i in range(6)]
        results = [None] * 6

        def work(i):
            results[i] = mb.submit(imgs[i])

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        mb.close()
        assert all(r["hierarchy"]["lat"] == 1.0 for r in results)
        assert all(r["hierarchy"]["lng"] == 2.0 for r in results)
        stats = mb.stats()
        assert stats["requests"] == 6
        # 6 concurrent requests with batch_size=4 -> at most 3 batches
        assert stats["batches"] <= 3
        assert all(c.shape == (4, 8, 8, 3) for c in calls)

    def test_error_propagates_to_every_waiter(self):
        def boom(images):
            raise RuntimeError("device on fire")

        mb = MicroBatcher(boom, batch_size=4, max_wait_ms=50, base_size=4)
        errors = []

        def work():
            with pytest.raises(RuntimeError, match="device on fire") as e:
                mb.submit(np.zeros((4, 4, 3), np.uint8))
            errors.append(e.value)

        threads = [threading.Thread(target=work) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        mb.close()
        assert len(errors) == 3
        assert mb.stats()["requests"] == 0

    def test_pad_slots_repeat_real_images(self):
        seen = []
        mb = MicroBatcher(fake_predict(seen), batch_size=4, max_wait_ms=1,
                          base_size=8)
        try:
            mb.submit(np.full((8, 8, 3), 200, np.uint8))
        finally:
            mb.close()
        assert (seen[0] == 200).all()


# -- the port server against the JAX server, fp32 on the CPU -----------------

@pytest.fixture(scope="module")
def servers(geo_parts, tmp_path_factory):
    from geoestimation_tpu.eval.engine import InferenceEngine as JaxEngine
    from geoestimation_tpu.serve import GeoInferenceServer as JaxServer
    from geoestimation_tpu.train.init import init_model_state
    from geoestimation_tpu.utils.config import Config as JaxConfig
    from tests.test_torch_port_ingest import build_jax_native, jax_native_from

    from geoestimation_tpu_torch.checkpoint import save_checkpoint
    from geoestimation_tpu_torch.convert import from_jax_variables
    from geoestimation_tpu_torch.eval.engine import InferenceEngine
    from geoestimation_tpu_torch.geo import load_partitionings
    from geoestimation_tpu_torch.utils.config import Config

    root = tmp_path_factory.mktemp("serve")
    files = []
    for p in geo_parts:
        files.append(str(root / f"{p.name}.csv"))
        p.to_csv(files[-1])
    parts = load_partitionings(files, names=[p.name for p in geo_parts])
    jax_config = JaxConfig()
    jax_config.model_params.arch = "resnet14"
    jax_config.model_params.partitionings.files = []
    _, state = init_model_state(jax_config, geo_parts, seed=0, image_size=64)
    import jax.numpy as jnp

    jax_engine = JaxEngine(jax_config, state, partitionings=geo_parts,
                           n_crops=10, crop=CROP, dtype=jnp.float32)
    sd = from_jax_variables(state["params"], state["batch_stats"],
                            "resnet14", [len(p) for p in geo_parts])
    config = Config()
    config.model_params.arch = "resnet14"
    config.model_params.partitionings.files = files
    engine = InferenceEngine(config, sd, partitionings=parts, n_crops=10,
                             crop=CROP, dtype=torch.float32, device="cpu")
    ckpt = str(root / "port_ckpt")
    save_checkpoint(ckpt, sd, config)

    kw = dict(port=0, batch_size=4, max_wait_ms=20, resize_to=BASE,
              base_size=BASE)
    with jax_native_from(build_jax_native(root)):
        assert port_decode.auto_backend() == "turbo", \
            port_decode.native.build_error()
        port_srv = GeoInferenceServer(engine, **kw)
        jax_srv = JaxServer(jax_engine, **kw)
        port_srv.start_background()
        jax_srv.start_background()
        yield {"port": port_srv, "jax": jax_srv, "engine": engine,
               "ckpt": ckpt}
        port_srv.close()
        jax_srv.close()


def url(srv, path):
    return f"http://127.0.0.1:{srv.port}{path}"


def post(srv, blob, path="/predict"):
    req = urllib.request.Request(url(srv, path), data=blob, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def get(srv, path):
    with urllib.request.urlopen(url(srv, path), timeout=60) as r:
        return r.status, r.headers["Content-Type"], r.read()


def post_all(srv, blobs):
    """POST every blob from its own thread (so the batcher groups them)."""
    out = [None] * len(blobs)

    def work(i):
        out[i] = post(srv, blobs[i])["predictions"]

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(blobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return out


def test_predict_matches_jax_server(servers):
    blobs = [jpeg_bytes(10 + i, 90 + 13 * i, 70 + 9 * i) for i in range(6)]
    got = post_all(servers["port"], blobs)
    ref = post_all(servers["jax"], blobs)
    for g, r in zip(got, ref):
        assert set(g) == set(r) == {"coarse", "middle", "fine", "hierarchy"}
        for key in r:
            assert g[key]["class"] == r[key]["class"], key
            np.testing.assert_allclose(
                [g[key]["lat"], g[key]["lng"]],
                [r[key]["lat"], r[key]["lng"]], rtol=0, atol=1e-5)
    # and each answer is predict_batch's on the same decoded image
    images, ok = port_decode.decode_batch(blobs, resize_to=BASE,
                                          base_size=BASE)
    assert ok.all()
    preds = servers["engine"].predict_batch(images)
    for i, g in enumerate(got):
        for key, (cls, lat, lng) in preds.items():
            assert g[key] == {"class": int(cls[i]), "lat": float(lat[i]),
                              "lng": float(lng[i])}


class TestHTTP:
    def test_healthz(self, servers):
        status, _, body = get(servers["port"], "/healthz")
        data = json.loads(body)
        assert status == 200 and data["status"] == "ok"
        assert data["partitionings"] == ["coarse", "middle", "fine"]
        assert data["devices"] == ["cpu"]

    def test_predict(self, servers):
        preds = post(servers["port"], jpeg_bytes(1))["predictions"]
        assert set(preds) == {"coarse", "middle", "fine", "hierarchy"}
        for v in preds.values():
            assert set(v) == {"class", "lat", "lng"}
            assert -90 <= v["lat"] <= 90 and -180 <= v["lng"] <= 180

    @pytest.mark.parametrize("blob", [b"not a jpeg", jpeg_bytes(2)[:200]],
                             ids=["junk", "truncated"])
    def test_bad_image_400(self, servers, blob):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(servers["port"], blob)
        assert e.value.code == 400
        assert json.loads(e.value.read()) == {"error": "undecodable image"}

    def test_empty_body_400(self, servers):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(servers["port"], b"")
        assert e.value.code == 400

    @pytest.mark.parametrize("method, path", [("GET", "/nope"),
                                              ("POST", "/nope")])
    def test_unknown_path_404(self, servers, method, path):
        with pytest.raises(urllib.error.HTTPError) as e:
            if method == "GET":
                get(servers["port"], path)
            else:
                post(servers["port"], jpeg_bytes(3), path)
        assert e.value.code == 404

    def test_demo_page(self, servers):
        for path in ("/", "/demo"):
            status, ctype, body = get(servers["port"], path)
            assert status == 200 and ctype.startswith("text/html")
            html = body.decode()
            # self-contained: posts to /predict, draws the map inline, and
            # references no external origin
            assert "/predict" in html and "<svg" in html
            assert "http://" not in html and "https://" not in html

    def test_stats(self, servers):
        post(servers["port"], jpeg_bytes(4))
        data = json.loads(get(servers["port"], "/stats")[2])
        assert data["requests"] >= 1 and data["batches"] >= 1
        assert data["batch_size"] == 4
        assert 1 <= data["mean_occupancy"] <= 4
        assert data["predict_s"] > 0


# -- the CLI -----------------------------------------------------------------

def test_main_serves_on_the_cpu(servers, monkeypatch, capsys):
    """`main --cpu --warmup` loads the checkpoint, runs one batch and
    starts serving (closed at once here)."""
    started = []

    def serve_once(self):
        self.start_background()
        started.append(post(self, jpeg_bytes(5))["predictions"])
        self.close()

    monkeypatch.setattr(GeoInferenceServer, "serve_forever", serve_once)
    port_server.main(["--checkpoint", servers["ckpt"], "--cpu", "--host",
                      "127.0.0.1", "--port", "0", "--batch_size", "2",
                      "--precision", "32", "--warmup"])
    out = capsys.readouterr().out
    assert "warmup done" in out and "serving on 127.0.0.1:" in out
    assert "cpu" in out
    assert set(started[0]) == {"coarse", "middle", "fine", "hierarchy"}


def test_module_runs_on_cuda_unless_asked_for_cpu(servers):
    """`python -m geoestimation_tpu_torch.serve` without --cpu needs CUDA."""
    out = subprocess.run(
        [sys.executable, "-m", "geoestimation_tpu_torch.serve",
         "--checkpoint", servers["ckpt"], "--port", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


@pytest.mark.parametrize("flags, item", [
    (["--precision", "8", "--feature_tta"], "TTA variants"),
    (["--feature_tta"], "TTA variants"),
    (["--feature_tta_level", "2"], "TTA variants"),
    pytest.param(["--precision", "8", "--calib_dir", "x", "--shard_batch"],
                 "Multi-process eval and training", id="flags3-Training"),
    pytest.param(["--shard_batch"], "Multi-process eval and training",
                 id="flags4-Training"),
])
def test_main_refuses_flags_not_ported(tmp_path, flags, item, request,
                                      monkeypatch, capsys):
    """--shard_batch, refused here until multi-process eval was ported:
    a --batch_size that does not split over the local cards (eight, as the
    JAX package's test devices) exits with the JAX server's message and
    code, before the checkpoint load (`test_main_shard_batch_serves` serves
    with it). The feature-TTA flags, refused here until the TTA variants
    were ported, do what the JAX server does with them: --feature_tta at
    the default --crops 1 exits with its message (the port before loading
    the checkpoint, the JAX server after); --feature_tta_level alone starts
    a device-TTA server."""
    from geoestimation_tpu.serve import server as jax_server

    jax_ckpt = request.getfixturevalue("jax_ckpt")
    if item == "Multi-process eval and training":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
        errors = []
        for main, ckpt in ((jax_server.main, jax_ckpt),
                           (port_server.main, str(tmp_path / "none"))):
            capsys.readouterr()
            with pytest.raises(SystemExit) as e:
                main(["--checkpoint", ckpt, "--batch_size", "3"] + flags)
            assert e.value.code == 2
            errors.append(capsys.readouterr().err.strip().splitlines()[-1])
        assert errors[1] == errors[0]
        assert errors[0].endswith("--shard_batch: --batch_size 3 not "
                                  "divisible by the 8 local devices")
        return
    port_ckpt = request.getfixturevalue("servers")["ckpt"]
    modes = []
    for mod in (jax_server, port_server):
        monkeypatch.setattr(mod.GeoInferenceServer, "serve_forever",
                            lambda self: modes.append(self.engine.tta_mode))
    common = ["--cpu", "--host", "127.0.0.1", "--port", "0"] + flags
    if "--feature_tta" in flags:
        message = "--feature_tta needs --crops 5 or 10"
        for main, ckpt in ((jax_server.main, jax_ckpt),
                           (port_server.main, str(tmp_path / "none"))):
            capsys.readouterr()
            with pytest.raises(SystemExit) as e:
                main(["--checkpoint", ckpt] + common)
            assert e.value.code == 2 and message in capsys.readouterr().err
        assert modes == []
    else:
        jax_server.main(["--checkpoint", jax_ckpt] + common)
        port_server.main(["--checkpoint", port_ckpt] + common)
        assert modes == ["device", "device"]


@pytest.fixture(scope="module")
def jax_ckpt(geo_parts, tmp_path_factory):
    """An orbax checkpoint of the JAX package (resnet14) for its server."""
    from geoestimation_tpu.train.checkpoint import save_single
    from geoestimation_tpu.train.init import init_model_state
    from geoestimation_tpu.utils.config import Config as JaxConfig

    root = tmp_path_factory.mktemp("jax_serve")
    config = JaxConfig()
    config.model_params.arch = "resnet14"
    config.model_params.partitionings.files = []
    for p in geo_parts:
        config.model_params.partitionings.files.append(
            str(root / f"{p.name}.csv"))
        p.to_csv(config.model_params.partitionings.files[-1])
    _, state = init_model_state(config, geo_parts, seed=0, image_size=64)
    save_single(str(root / "ckpt"), state, config=config, step=0,
                metrics={"val_loss": 1.0})
    return str(root / "ckpt")


def test_main_shard_batch_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    """`--shard_batch` without --cpu where CUDA is absent raises before the
    checkpoint load: it does not shard over the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_server.main(["--checkpoint", str(tmp_path / "none"),
                          "--shard_batch"])


def test_main_shard_batch_serves(servers, monkeypatch, capsys):
    """`main --shard_batch` on the CPU (one local device): the engine holds
    the layout, and the answer is `predict_batch`'s."""
    answers, engines = [], []

    def serve_once(self):
        self.start_background()
        answers.append(post(self, jpeg_bytes(7))["predictions"])
        engines.append(self.engine)
        self.close()

    monkeypatch.setattr(GeoInferenceServer, "serve_forever", serve_once)
    port_server.main(["--checkpoint", servers["ckpt"], "--cpu", "--host",
                      "127.0.0.1", "--port", "0", "--batch_size", "2",
                      "--shard_batch"])
    assert "sharding micro-batches over 1 local devices" in \
        capsys.readouterr().out
    engine = engines[0]
    assert engine.layout is not None and engine.layout.n_data == 1
    images, ok = port_decode.decode_batch([jpeg_bytes(7)] * 2)
    assert ok.all()
    want = engine.predict_batch(images)
    assert answers[0] == {k: {"class": int(c[0]), "lat": float(la[0]),
                              "lng": float(ln[0])}
                          for k, (c, la, ln) in want.items()}


def test_main_serves_feature_tta(servers, monkeypatch):
    """`main --feature_tta --crops 5`: the server answers with
    `predict_batch` of a feature-TTA engine on the same image."""
    answers, engines = [], []

    def serve_once(self):
        self.start_background()
        answers.append(post(self, jpeg_bytes(6))["predictions"])
        engines.append(self.engine)
        self.close()

    monkeypatch.setattr(GeoInferenceServer, "serve_forever", serve_once)
    port_server.main(["--checkpoint", servers["ckpt"], "--cpu", "--host",
                      "127.0.0.1", "--port", "0", "--batch_size", "1",
                      "--crops", "5", "--feature_tta", "--feature_tta_level",
                      "2"])
    engine = engines[0]
    assert (engine.tta_mode, engine.n_crops) == ("feature", 5)
    images, ok = port_decode.decode_batch([jpeg_bytes(6)])
    assert ok.all()
    want = engine.predict_batch(images)
    assert answers[0] == {k: {"class": int(c[0]), "lat": float(la[0]),
                              "lng": float(ln[0])}
                          for k, (c, la, ln) in want.items()}
