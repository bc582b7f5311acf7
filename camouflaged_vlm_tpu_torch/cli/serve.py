"""HTTP model server for the OVCOS cascade on the GPU.

Counterpart of `camouflaged_vlm_tpu/cli/serve.py`: mounts
`camouflaged_vlm_tpu_torch.serve.InferenceEngine` (micro-batching, one CUDA
graph per batch bucket; see that module) behind a stdlib threaded HTTP
server.

Endpoints:
  POST /predict        body = raw image bytes (any PIL-decodable format).
                       Query params: mask=0 omits the mask from the response.
                       -> JSON {class, class_id, score, latency_ms,
                                mask_png_b64?}
  GET  /healthz        200 once the bucket programs are captured, 503
                       "warming" before that.
  GET  /stats          JSON batching/latency counters.
  GET  /metrics        the same counters in Prometheus text format.
  GET  /classnames     JSON list of the class split being served.

SIGTERM/SIGINT drain gracefully: the server stops accepting, queued
requests still run, then the process exits.

Usage:
  python -m camouflaged_vlm_tpu_torch.cli.serve --port 8000 \
      [--cascade-ckpt model_epoch_best.pth --clip-ckpt ViT-L-14-336px.pt \
       --text-bank TestCamoPromptsTextFeatures.pth] [--config configs/<yaml>]

The checkpoint flags (`cli/common.py`) take the reference's files; what no
file sets is random (seeded by `--seed`). `--device cuda` (the default) on
a machine without a GPU raises, and so does float32 on the card.

Several cards: run under torchrun, one process a rank, with
`--data-parallel` and `--n-model N` (`serve.py`'s mesh), e.g.

  torchrun --nproc-per-node 4 -m camouflaged_vlm_tpu_torch.cli.serve --port 8000 \
      --data-parallel --n-model 2 --buckets 2,8,32

Rank 0 listens and batches; each flush's bucket is broadcast to every rank,
which runs its rows of it on its model shard, and rank 0 gathers the
outputs. The other ranks follow until rank 0 shuts down. Every bucket must
divide over the data ranks.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence
from urllib.parse import parse_qs, urlparse

from PIL import Image

from ..config import DTYPES
from ..data.ovcamo import TEST_CLASS_NAMES
from ..factory import build_cascade
from ..parallel import check_tp_config, shard_model_
from ..serve import InferenceEngine, ServeConfig
from .common import (
    add_checkpoint_flags,
    add_mesh_flags,
    cascade_config,
    device_or_raise,
    exact_fp32_on_card,
    load_checkpoints,
    mesh_from_args,
    preproc_line,
    refuse_fp32_on_card,
)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_handler(engine: InferenceEngine, quiet: bool = False):
    class Handler(BaseHTTPRequestHandler):
        # ThreadingHTTPServer runs one thread per connection; the engine's
        # queue provides the backpressure
        protocol_version = "HTTP/1.1"
        # idle keep-alive connections drop after this, so the graceful
        # shutdown's handler-thread join (server_close) is bounded
        timeout = 30

        def _drain_body(self) -> None:
            """Read and discard the request body, so that a keep-alive
            connection stays in sync after an error response."""
            length = int(self.headers.get("Content-Length", 0) or 0)
            while length > 0:
                chunk = self.rfile.read(min(length, 1 << 20))
                if not chunk:
                    break
                length -= len(chunk)

        def log_message(self, fmt, *args):
            if not quiet:
                log("[serve] " + fmt % args)

        def _send(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload) -> None:
            self._send(code, json.dumps(payload).encode(), "application/json")

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                if engine.ready():
                    self._json(200, {"status": "ok"})
                else:
                    self._json(503, {"status": "warming"})
            elif path == "/stats":
                self._json(200, engine.stats())
            elif path == "/metrics":
                s = engine.stats()
                lines = [
                    f"cvlm_requests_total {s['requests']}",
                    f"cvlm_batches_total {s['batches']}",
                    f"cvlm_batched_images_total {s['batched_images']}",
                    f"cvlm_errors_total {s['errors']}",
                    f"cvlm_latency_ms_mean {s.get('latency_ms_mean', 0.0):.3f}",
                    f"cvlm_latency_ms_max {s['latency_ms_max']:.3f}",
                    f"cvlm_pad_fraction {s['pad_fraction']:.4f}",
                    f"cvlm_ready {int(s['ready'])}",
                ] + [
                    f'cvlm_batches_by_size_total{{size="{k}"}} {v}'
                    for k, v in sorted(s["batch_size_hist"].items())
                ]
                self._send(200, ("\n".join(lines) + "\n").encode(),
                           "text/plain; version=0.0.4")
            elif path == "/classnames":
                self._json(200, engine.classnames)
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/predict":
                self._drain_body()
                self._json(404, {"error": f"unknown path {parsed.path}"})
                return
            length = int(self.headers.get("Content-Length", 0) or 0)
            if length <= 0:
                self._json(400, {"error": "empty body; send raw image bytes"})
                return
            data = self.rfile.read(length)
            want_mask = parse_qs(parsed.query).get("mask", ["1"])[0] != "0"
            t0 = time.monotonic()
            try:
                out = engine.predict_bytes(data, want_mask=want_mask)
            except (ValueError, OSError) as e:
                self._json(400, {"error": f"undecodable image: {e}"})
                return
            except Exception as e:  # the engine failed the batch: report, keep serving
                self._json(500, {"error": f"inference failed: {e}"})
                return
            resp = {
                "class": out["class"],
                "class_id": out["class_id"],
                "score": out["score"],
                "latency_ms": round((time.monotonic() - t0) * 1e3, 2),
            }
            if want_mask:
                buf = io.BytesIO()
                Image.fromarray(out["mask"]).save(buf, format="PNG")
                resp["mask_png_b64"] = base64.b64encode(buf.getvalue()).decode()
            self._json(200, resp)

    return Handler


def serve_forever(engine: InferenceEngine, host: str, port: int, quiet: bool = False):
    """Start the HTTP server; returns (server, thread), with the engine's
    warm-up (the bucket captures) running in the background so that
    /healthz reports readiness honestly."""
    server = ThreadingHTTPServer((host, port), make_handler(engine, quiet=quiet))
    # non-daemon handler threads + block_on_close: server_close() joins the
    # handlers in flight, so a graceful shutdown never truncates a response
    server.daemon_threads = False
    threading.Thread(target=engine.warmup, daemon=True).start()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def parse_args(argv: Sequence[str] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    add_checkpoint_flags(p)
    p.add_argument("--config", default=None, help="a model yaml (instead of --tiny)")
    p.add_argument("--classnames", default=None,
                   help="comma-separated; default the OVCamo test split (61 classes)")
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke test)")
    p.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                   help="compute type (default: the yaml's, else bfloat16)")
    p.add_argument("--buckets", default="1,4,16,32",
                   help="batch sizes, ascending, one CUDA graph each")
    p.add_argument("--max-delay-ms", type=float, default=10.0)
    p.add_argument("--mask-dtype", default="uint8", choices=["uint8", "float16"],
                   help="mask transfer type; uint8 halves the device-to-host bytes "
                   "and is lossless for the 8-bit PNG response")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    add_mesh_flags(p)
    return p.parse_args(argv)


def build_engine(args: argparse.Namespace, mesh=None) -> InferenceEngine:
    """The engine the flags describe (the model built, its weights loaded,
    sharded over `mesh`'s model group)."""
    cfg = cascade_config(args.config, args.tiny, args.dtype)
    check_tp_config(cfg, mesh.n_model if mesh is not None else 1)
    refuse_fp32_on_card(args.device, cfg)
    device = mesh.device if mesh is not None else device_or_raise(args.device)
    exact_fp32_on_card(args.device, cfg)
    classnames = args.classnames.split(",") if args.classnames else list(TEST_CLASS_NAMES)
    model = build_cascade(cfg, device, args.seed)
    make_bank = load_checkpoints(model, cfg, clip_ckpt=args.clip_ckpt,
                                 maple_ckpt=args.maple_ckpt, sam_ckpt=args.sam_ckpt,
                                 cascade_ckpt=args.cascade_ckpt, seed=args.seed, log=log)
    bank = make_bank(classnames, args.text_bank)
    serve_cfg = ServeConfig(buckets=tuple(int(b) for b in args.buckets.split(",")),
                            max_delay_ms=args.max_delay_ms, mask_dtype=args.mask_dtype)
    if mesh is None:
        return InferenceEngine(model, cfg, bank, classnames, serve_cfg)
    return InferenceEngine(shard_model_(model, mesh), cfg, bank, classnames, serve_cfg, mesh=mesh)


def main(argv: Sequence[str] = None) -> None:
    args = parse_args(argv)
    mesh = mesh_from_args(args)
    engine = build_engine(args, mesh)
    if mesh is not None and not mesh.is_main:
        engine.follow()  # until rank 0 shuts down
        return
    if mesh is not None:
        log(f"[serve] mesh data={mesh.n_data} x model={mesh.n_model} ({mesh.backend})")
    log(preproc_line("serve"))
    server, _ = serve_forever(engine, args.host, args.port)
    log(f"[serve] listening on {args.host}:{args.port} (capturing buckets {args.buckets})")
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    # graceful drain: stop accepting, run out the queue, resolve the futures
    # in flight, then join the handler threads
    log("[serve] shutting down (draining queue)")
    server.shutdown()
    engine.close()
    server.server_close()
    log(f"[serve] host preprocessing: {engine.stats()['pil_fallbacks']} request(s) through PIL "
        "(containers the native decoder does not take)")


if __name__ == "__main__":
    main()
