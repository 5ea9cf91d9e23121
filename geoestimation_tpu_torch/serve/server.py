"""Dynamic-batching inference server of the port.

The counterpart of `geoestimation_tpu/serve/server.py`: an HTTP endpoint
whose requests are micro-batched onto the card. The batcher collects
requests for up to `max_wait_ms` (or until `batch_size` arrive), pads the
group to the fixed batch by repeating real images, and runs ONE
`predict_batch` for the group, so every forward has the same shape.

Endpoints:
  POST /predict     body = JPEG bytes -> JSON {p_key: {class, lat, lng}}
  GET  /, /demo     browser demo page (serve/demo_page.py)
  GET  /healthz     liveness, the torch device the engine runs on, and the
                    partitionings
  GET  /stats       counters (requests, batches, mean batch occupancy, the
                    seconds spent in `predict_batch`, the seconds requests
                    waited in the queue, summed and the longest)

Run: python -m geoestimation_tpu_torch.serve --checkpoint DIR [--port 8500]
     [--crops 5|10 --feature_tta] [--cpu]
Runs on CUDA unless --cpu.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..classification._cli import (
    add_calib_args,
    add_feature_tta_args,
    int8_kwargs,
)
from ..utils.spans import span


class _Pending:
    __slots__ = ("image", "event", "result", "error", "enqueued")

    def __init__(self, image):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.enqueued = time.perf_counter()


class MicroBatcher:
    """Collects single-image requests into fixed-size device batches."""

    def __init__(self, predict_fn, batch_size: int = 16,
                 max_wait_ms: float = 5.0, base_size: int = 256):
        self.predict_fn = predict_fn
        self.batch_size = batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self.base_size = base_size
        self.queue: queue.Queue = queue.Queue()
        self.n_requests = 0
        self.n_batches = 0
        self.occupancy_sum = 0
        self.predict_s = 0.0   # wall time inside predict_fn
        # from a request's submit to the start of its batch's predict_fn
        self.queue_wait_s = 0.0
        self.queue_wait_max_s = 0.0
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, image_u8: np.ndarray, timeout: float = 30.0):
        """Blocking: (base, base, 3) uint8 -> {p_key: {class, lat, lng}}."""
        item = _Pending(image_u8)
        self.queue.put(item)
        if not item.event.wait(timeout):
            raise TimeoutError("prediction timed out")
        if item.error is not None:
            raise item.error
        return item.result

    def _loop(self):
        while not self._stop:
            try:
                first = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            group = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(group) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    group.append(self.queue.get(timeout=remaining))
                except queue.Empty:
                    break
            with span("serve.batch", request=self.n_batches + 1):
                self._run(group)

    def _run(self, group):
        try:
            images = np.zeros(
                (self.batch_size, self.base_size, self.base_size, 3),
                np.uint8,
            )
            for i, item in enumerate(group):
                images[i] = item.image
            # pad slots repeat real images rather than staying black: their
            # predictions are discarded, and an engine that calibrates on
            # its first batch must not see zero padding
            for i in range(len(group), self.batch_size):
                images[i] = group[i % len(group)].image
            t0 = time.perf_counter()
            waits = [t0 - item.enqueued for item in group]
            self.queue_wait_s += sum(waits)
            self.queue_wait_max_s = max(self.queue_wait_max_s, *waits)
            preds = self.predict_fn(images)
            self.predict_s += time.perf_counter() - t0
            for i, item in enumerate(group):
                item.result = {
                    key: {
                        "class": int(cls[i]),
                        "lat": float(lat[i]),
                        "lng": float(lng[i]),
                    }
                    for key, (cls, lat, lng) in preds.items()
                }
                item.event.set()
            self.n_requests += len(group)
            self.n_batches += 1
            self.occupancy_sum += len(group)
        except Exception as e:  # noqa: BLE001 - propagated to all waiters
            for item in group:
                item.error = e
                item.event.set()

    def stats(self):
        batches = max(self.n_batches, 1)
        return {
            "requests": self.n_requests,
            "batches": self.n_batches,
            "mean_occupancy": self.occupancy_sum / batches,
            "batch_size": self.batch_size,
            "predict_s": self.predict_s,
            "queue_wait_s": self.queue_wait_s,
            "queue_wait_max_s": self.queue_wait_max_s,
        }

    def close(self):
        self._stop = True
        self._thread.join()


def device_names(engine):
    """The torch devices the engine runs on (one, or each of its layout's),
    with the card's name on CUDA."""
    import torch

    names = []
    for device in engine.devices:
        if device.type == "cuda":
            index = device.index if device.index is not None else \
                torch.cuda.current_device()
            names.append(f"cuda:{index} {torch.cuda.get_device_name(index)}")
        else:
            names.append(str(device))
    return names


class GeoInferenceServer:
    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8500,
                 batch_size: int = 16, max_wait_ms: float = 5.0,
                 resize_to: int = 256, base_size: int = 256,
                 fast_decode: bool = False):
        from ..ingest import decode

        self.engine = engine
        self.batcher = MicroBatcher(
            engine.predict_batch, batch_size=batch_size,
            max_wait_ms=max_wait_ms, base_size=base_size,
        )
        self._decode = lambda blob: decode.decode_batch(
            [blob], resize_to=resize_to, base_size=base_size,
            fast_scale=fast_decode,
        )
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/demo"):
                    from .demo_page import DEMO_HTML

                    body = DEMO_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/healthz":
                    self._json(200, {
                        "status": "ok",
                        "devices": device_names(server.engine),
                        "partitionings": list(server.engine.harrays.names),
                    })
                elif self.path == "/stats":
                    self._json(200, server.batcher.stats())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/predict":
                    self._json(404, {"error": "not found"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0 or length > 64 * 1024 * 1024:
                    self._json(400, {"error": "bad Content-Length"})
                    return
                blob = self.rfile.read(length)
                images, ok = server._decode(blob)
                if not ok[0]:
                    self._json(400, {"error": "undecodable image"})
                    return
                try:
                    result = server.batcher.submit(images[0])
                except TimeoutError:
                    self._json(503, {"error": "timed out"})
                    return
                self._json(200, {"predictions": result})

        # the default listen backlog (5) resets connections under a burst of
        # clients; keep it well above any sane concurrent client count
        class _Server(ThreadingHTTPServer):
            request_queue_size = 256
            daemon_threads = True

        self.httpd = _Server((host, port), Handler)
        self.port = self.httpd.server_port

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def close(self):
        self.batcher.close()
        self.httpd.shutdown()
        self.httpd.server_close()


def build_parser():
    import argparse

    p = argparse.ArgumentParser(description="GeoEstimation inference server "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint directory (hparams.yaml + state_dict.pt)")
    p.add_argument("--hparams", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--crops", type=int, default=1, choices=[1, 5, 10])
    p.add_argument("--fast", action="store_true",
                   help="fold BatchNorm into bf16 conv weights at load")
    p.add_argument("--precision", type=int, default=16, choices=[8, 16, 32],
                   help="16=bfloat16 backbone, 32=float32, 8=int8 PTQ "
                        "serving precision (models/quant.py; calibrated on "
                        "the first batch)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of CUDA")
    p.add_argument("--warmup", action="store_true",
                   help="run one full-size batch before accepting traffic "
                        "(with --precision 8, the calibration too: on "
                        "noise, never cached, without --calib_dir)")
    p.add_argument("--fast_decode", action="store_true",
                   help="scaled DCT JPEG decode for request images (faster "
                        "on large photos; slightly different pixels)")
    add_feature_tta_args(p)
    add_calib_args(p)
    p.add_argument("--shard_batch", action="store_true",
                   help="split each micro-batch over ALL local cards "
                        "(one replica of the network on each); "
                        "--batch_size must divide evenly by the local card "
                        "count. Default: one card (run one server per card "
                        "instead for latency-bound fleets)")
    return p


def main(argv=None):
    import os

    import torch

    from ..checkpoint import load_checkpoint
    from ..eval.engine import InferenceEngine

    p = build_parser()
    args = p.parse_args(argv)
    layout = None
    if args.shard_batch:
        # validate BEFORE the (slow) checkpoint load: a bad batch size
        # should fail at startup, not after minutes of loading
        from ..parallel.mesh import default_devices, make_mesh

        devices = ([torch.device("cpu")] if args.cpu
                   else default_devices())
        n_local = len(devices)
        if args.batch_size % n_local:
            p.error(f"--shard_batch: --batch_size {args.batch_size} not "
                    f"divisible by the {n_local} local devices")
        layout = make_mesh(n_local, 1, devices=devices)
        print(f"sharding micro-batches over {n_local} local devices",
              flush=True)
    if args.feature_tta and args.crops == 1:
        p.error("--feature_tta needs --crops 5 or 10")
    config, state_dict = load_checkpoint(args.checkpoint,
                                         hparams_path=args.hparams)
    # A synthetic int8 warmup (no --calib_dir) may calibrate on noise: fit
    # to serve behind an explicit flag, but never cached, so it cannot
    # poison a later run that trusts the cache.
    synthetic_calib = (args.precision == 8 and args.warmup
                       and not args.calib_dir)
    engine = InferenceEngine(
        config, state_dict, n_crops=args.crops, fast=args.fast,
        dtype=torch.float32 if args.precision == 32 else torch.bfloat16,
        tta_mode="feature" if args.feature_tta else "device",
        feature_tta_level=args.feature_tta_level,
        fast_decode=args.fast_decode,
        search_dirs=[os.path.dirname(os.path.abspath(args.checkpoint)),
                     args.checkpoint, os.getcwd()],
        device="cpu" if args.cpu else "cuda", layout=layout,
        **int8_kwargs(args, persist=not synthetic_calib),
    )
    if args.warmup or args.calib_dir:
        t0 = time.time()
        if synthetic_calib:
            print("WARNING: int8 warmup on synthetic noise -- pass "
                  "--calib_dir with domain images for representative "
                  "activation scales (these will not be cached)", flush=True)
            batch = np.random.default_rng(0).integers(
                0, 255, (args.batch_size, 256, 256, 3), dtype=np.uint8)
        else:
            # an int8 engine calibrates from calib_dir itself; any batch
            # builds it
            batch = np.zeros((args.batch_size, 256, 256, 3), np.uint8)
        engine.predict_batch(batch)
        print(f"warmup done in {time.time() - t0:.1f}s "
              f"(calibrated={args.precision == 8}, "
              f"source={getattr(engine, 'int8_calib_source', None)})",
              flush=True)

    server = GeoInferenceServer(engine, host=args.host, port=args.port,
                                batch_size=args.batch_size,
                                max_wait_ms=args.max_wait_ms,
                                fast_decode=args.fast_decode)
    print(f"serving on {args.host}:{server.port} on "
          f"{device_names(engine)[0]} (batch={args.batch_size}, "
          f"wait={args.max_wait_ms}ms)", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
