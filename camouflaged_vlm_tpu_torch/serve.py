"""Serving: the micro-batching inference engine for the fused cascade.

Counterpart of `camouflaged_vlm_tpu/serve.py`:

- Requests are coalesced into the largest batch available within a small
  deadline window and padded to a fixed set of batch *buckets*, each of
  which runs as one program: on a card, one CUDA graph per bucket
  (`graphs.GraphedCall`), captured by `warmup()` or at a bucket's first
  batch; on the CPU, the same function called eagerly.
- The program is the whole cascade call (SAM encoder -> CLIP pass 1 ->
  edge decoder -> alpha handoff -> CLIP pass 2) with the uint8 inputs'
  normalisation, the all-ones stage-1 alpha and the mask's cast inside it;
  the class-text features are encoded once at start-up and the rel-pos
  tables attached once.
- Host preprocessing (resize to uint8) runs on the caller's thread:
  `predict_bytes` decodes and resizes natively (`data/native.py`, the C
  library with the GIL released, so concurrent request handlers do not
  serialise on it; the PIL path's bytes), as does the response mask's
  bilinear resize, unless CVLM_NATIVE_PREPROC=0; `predict_pil` runs PIL.
  The batching thread stacks a batch into pinned host memory, and on its
  own stream copies it to the bucket's static inputs, replays the graph
  and queues the outputs' copies into pinned host buffers of the batch's
  own (a replay overwrites the graph's static outputs, and the copies are
  queued before the next replay on the same stream), then records an
  event. The completion thread waits on that event, not on the device, so
  batch k+1's stacking and upload overlap batch k's compute and download
  (`max_inflight` bounds the batches between the two threads).

`InferenceEngine` is transport-agnostic (futures in, results out);
`cli/serve.py` mounts it behind a stdlib HTTP front end. A body whose
container the native decoder does not take (16-bit PNG, CMYK JPEG) goes
through PIL, as in the JAX engine, and is counted (`stats()`'s
"pil_fallbacks").

With a `mesh` (`parallel.make_mesh`; the model sharded over its model
group) every rank builds an engine. Rank 0 runs the front end and the
batcher; every other rank calls `follow()`, which runs what rank 0
broadcasts until it broadcasts the stop. A flush broadcasts the bucket and
its uint8 batch to every rank; each runs its data rows on its model shard
(its own graph per bucket, eager where its collectives cannot be captured:
tensor parallelism on gloo), and rank 0 gathers the data ranks' outputs.
Buckets the data axis does not divide are refused at construction, as in
the JAX engine.
"""

from __future__ import annotations

import dataclasses
import io
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from .data import native as _nat
from .data import native_pipeline as _npp
from .data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ONES_ALPHA_VALUE,
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
    clip_image_resized_u8,
    sam_image_resized_u8,
)
from .factory import attach_rel_cache
from .graphs import GraphedCall
from .parallel.mesh import all_gather, batch_rows, broadcast_


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Batching policy (the JAX engine's fields, defaults and checks).

    buckets: the batch sizes that run, ascending, each one program. A batch
        of n requests runs at the smallest bucket >= n, padded by repeating
        the last row (pad rows are discarded).
    max_delay_ms: how long the batching thread holds the first request of
        a batch waiting for more to coalesce. The latency/throughput knob.
    queue_capacity: backpressure bound: submit() blocks when this many
        requests are already queued.
    mask_dtype: type of the returned mask probabilities. "float16" (2
        bytes/px) by default; "uint8", round(p * 255), halves the
        device-to-host bytes again and is lossless for any 8-bit image
        output.
    max_inflight: dispatched-but-unfetched batch bound: the batching thread
        stacks and ships batch k+1 while batch k's results are still
        downloading.
    return_mask: leave the mask's cast and copy out of the program when
        False (classification-only deployments); futures then resolve to
        (None, class_id, logits). Also `bench_engine`'s mode.
    """

    buckets: Tuple[int, ...] = (1, 4, 16, 32)
    max_delay_ms: float = 10.0
    queue_capacity: int = 256
    mask_dtype: str = "float16"
    max_inflight: int = 2
    return_mask: bool = True

    def __post_init__(self):
        if not self.buckets or self.buckets != tuple(sorted(self.buckets)):
            raise ValueError(f"buckets must be a non-empty ascending tuple: {self.buckets}")
        if self.mask_dtype not in ("float16", "uint8"):
            raise ValueError(f"mask_dtype {self.mask_dtype!r}: float16 or uint8")
        if self.max_inflight < 1:
            raise ValueError(f"max_inflight {self.max_inflight} < 1")


class _Request:
    __slots__ = ("inp", "cimg", "future", "t_enqueue")

    def __init__(self, inp: np.ndarray, cimg: np.ndarray):
        self.inp = inp
        self.cimg = cimg
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()


_SENTINEL = object()
# the commands rank 0 broadcasts to the followers of a mesh
_STOP, _RUN, _CAPTURE = 0, 1, 2


class InferenceEngine:
    """Micro-batching server core around the fused cascade on its device.

    model: a built `OVCOSCascade` with its final weights (its device is the
        engine's); the engine attaches its rel cache.
    bank: the class split's prompt bank (`factory.make_bank_inputs`) on the
        model's device; classnames: the split's names.
    mesh: a `parallel.Mesh` to serve on (see the module docstring), or None.
    """

    def __init__(self, model, cfg, bank: Dict[str, torch.Tensor], classnames: Sequence[str],
                 serve_cfg: ServeConfig = ServeConfig(), mesh=None):
        if mesh is not None:
            bad = [b for b in serve_cfg.buckets if b % mesh.n_data]
            if bad:
                raise ValueError(f"buckets {bad} not divisible by the data axis "
                                 f"({mesh.n_data}): every bucket's batch must split evenly")
        self.mesh = mesh
        self.model = attach_rel_cache(model)
        self.cfg = cfg
        self.classnames = list(classnames)
        self.serve_cfg = serve_cfg
        self.device = next(model.parameters()).device
        self._cuda = self.device.type == "cuda"
        # a tensor-parallel program on gloo holds collectives no graph can capture
        self._capture = mesh is None or mesh.capturable
        # per-class text features are image-independent: encoded once
        self._text_features = model.encode_class_text_features(
            bank["prefix"], bank["suffix"], bank["eot_indices"], bank["bank_features"])
        self._consts = {k: torch.from_numpy(v).to(self.device) for k, v in (
            ("mean", IMAGENET_MEAN), ("std", IMAGENET_STD),
            ("cmean", OPENAI_CLIP_MEAN), ("cstd", OPENAI_CLIP_STD))}
        # the bucket programs; `_graph_lock` serialises their captures
        # against the batching thread's replays
        self._graphs: Dict[int, GraphedCall] = {}
        self._graph_lock = threading.Lock()
        if self._cuda:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

        self._queue: "queue.Queue" = queue.Queue(maxsize=serve_cfg.queue_capacity)
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "batches": 0,
            "batched_images": 0,  # includes pad rows
            "errors": 0,
            "batch_size_hist": {},  # real (unpadded) sizes
            "latency_ms_sum": 0.0,
            "latency_ms_max": 0.0,
            # per-bucket request latency (count/sum/max)
            "bucket_latency_ms": {},
            # predict_bytes bodies the native decoder does not take (PIL ran)
            "pil_fallbacks": 0,
        }
        self._ready = threading.Event()
        self._stop = False
        # serialises submit()'s stop-check-then-put against close()'s
        # stop-set-then-sentinel, so no request lands behind the drain
        self._submit_lock = threading.Lock()
        self._inflight: "queue.Queue" = queue.Queue(maxsize=serve_cfg.max_inflight)
        self._worker = threading.Thread(
            target=self._worker_loop, name="cvlm-serve-batcher", daemon=True)
        self._completer = threading.Thread(
            target=self._completer_loop, name="cvlm-serve-completer", daemon=True)
        self._worker.start()
        self._completer.start()

    # ---- the bucket program

    def _program(self, inp_u8: torch.Tensor, cimg_u8: torch.Tensor):
        """uint8 (B, S, S, 3), (B, C, C, 3) -> (mask (B, S, S) in mask_dtype,
        pred (B,), logits (B, N)); without return_mask (pred, logits)."""
        c, cfg = self._consts, self.cfg
        inp = (inp_u8.float() / 255.0 - c["mean"]) / c["std"]
        cimg = (cimg_u8.float() / 255.0 - c["cmean"]) / c["cstd"]
        cmask = torch.full((inp_u8.shape[0], cfg.clip_size, cfg.clip_size, 1),
                           ONES_ALPHA_VALUE, device=inp_u8.device)
        probs, pred, score = self.model.infer_cascade_with_text(
            inp, cimg, cmask, self._text_features)
        if not self.serve_cfg.return_mask:
            return pred, score
        probs = probs[..., 0]
        if self.serve_cfg.mask_dtype == "uint8":
            m = torch.round(probs * 255.0).to(torch.uint8)
        else:
            m = probs.to(torch.float16)
        return m, pred, score

    def _graph_for(self, bucket: int) -> GraphedCall:
        """The bucket's program, captured at its first use (call with
        `_graph_lock` held)."""
        g = self._graphs.get(bucket)
        if g is None:
            cfg = self.cfg
            rows = bucket // (self.mesh.n_data if self.mesh is not None else 1)
            zeros = lambda s: torch.zeros((rows, s, s, 3), dtype=torch.uint8,  # noqa: E731
                                          device=self.device)
            g = GraphedCall(self._program, zeros(cfg.inp_size), zeros(cfg.clip_size),
                            pool=self._pool if self._cuda else None, capture=self._capture)
            self._graphs[bucket] = g
        return g

    def _command(self, cmd: int, bucket: int = 0) -> None:
        """Rank 0: broadcast a command to the followers (call with
        `_graph_lock` held: the commands and their collectives keep one
        order on every rank)."""
        if self.mesh is not None:
            broadcast_(torch.tensor([cmd, bucket], dtype=torch.int64))

    def _run_bucket(self, bucket: int, inp: torch.Tensor, cimg: torch.Tensor):
        """The bucket's program on this rank's rows of the (broadcast) batch,
        then, on a data-parallel mesh, the data ranks' outputs gathered in
        rank order. Call with `_graph_lock` held."""
        program = self._graph_for(bucket)
        if self.mesh is None:
            return program(inp, cimg)
        if self.mesh.backend == "nccl":  # gloo broadcasts host memory
            inp, cimg = inp.to(self.device), cimg.to(self.device)
        outs = program(*(batch_rows(broadcast_(t), self.mesh) for t in (inp, cimg)))
        if self.mesh.n_data == 1:
            return outs
        return tuple(torch.cat(all_gather(o, self.mesh.data_group)) for o in outs)

    def follow(self) -> None:
        """A follower rank of a mesh: run rank 0's broadcast commands (the
        bucket captures, the batches) until it broadcasts the stop."""
        if self._cuda:
            torch.cuda.set_device(self.device)
        cfg = self.cfg
        while True:
            cmd, bucket = (int(v) for v in broadcast_(torch.zeros(2, dtype=torch.int64)))
            if cmd == _STOP:
                return
            with self._graph_lock:
                if cmd == _CAPTURE:
                    self._graph_for(bucket)
                    continue
                empty = lambda s: torch.empty((bucket, s, s, 3), dtype=torch.uint8)  # noqa: E731
                outs = self._run_bucket(bucket, empty(cfg.inp_size), empty(cfg.clip_size))
                if self._cuda:
                    torch.cuda.current_stream(self.device).synchronize()
                del outs

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A stacked host batch as the program's input: pinned host memory
        on a card (copied to the static inputs on the engine's stream),
        the array itself on the CPU."""
        if not self._cuda:
            return torch.from_numpy(a)
        t = torch.empty(a.shape, dtype=torch.uint8, pin_memory=True)
        t.numpy()[...] = a
        return t

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """An output of the program into host memory of this batch's own,
        queued on the current stream (the next replay overwrites `t`)."""
        if not self._cuda:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    # ---- public API

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Capture the bucket programs (a warm server answers its first
        request at steady-state latency)."""
        if self._cuda:
            torch.cuda.set_device(self.device)
        for b in buckets if buckets is not None else self.serve_cfg.buckets:
            with self._graph_lock:
                if b not in self._graphs:
                    self._command(_CAPTURE, b)
                    self._graph_for(b)
        self._ready.set()

    def ready(self) -> bool:
        return self._ready.is_set()

    def submit(self, inp_u8: np.ndarray, cimg_u8: np.ndarray) -> Future:
        """Enqueue one preprocessed image pair.

        inp_u8: (inp_size, inp_size, 3) uint8; cimg_u8: (clip_size,
        clip_size, 3) uint8. Returns a Future resolving to (mask (H, W)
        `serve_cfg.mask_dtype`, class_id int, class_logits (N,) float32).
        Blocks when queue_capacity requests are pending (backpressure).
        """
        cfg = self.cfg
        if inp_u8.shape != (cfg.inp_size, cfg.inp_size, 3) or inp_u8.dtype != np.uint8:
            raise ValueError(f"inp_u8 {inp_u8.shape} {inp_u8.dtype}")
        if cimg_u8.shape != (cfg.clip_size, cfg.clip_size, 3) or cimg_u8.dtype != np.uint8:
            raise ValueError(f"cimg_u8 {cimg_u8.shape} {cimg_u8.dtype}")
        req = _Request(np.ascontiguousarray(inp_u8), np.ascontiguousarray(cimg_u8))
        # holding the lock across the (possibly blocking) put is safe: the
        # batching thread keeps draining the queue
        with self._submit_lock:
            if self._stop:
                raise RuntimeError("engine is shut down")
            self._queue.put(req)
        return req.future

    def predict_pil(self, img: Image.Image, timeout: Optional[float] = None,
                    want_mask: bool = True) -> Dict:
        """Preprocess one PIL image, run it through the batcher, and return
        a response dict with the mask resized back to the input resolution.
        want_mask=False skips the mask's resize (classification-only
        clients)."""
        img = img.convert("RGB")
        w, h = img.size
        fut = self.submit(sam_image_resized_u8(img, self.cfg.inp_size),
                          clip_image_resized_u8(img, self.cfg.clip_size))
        return self._respond(fut, w, h, timeout, want_mask, native=False)

    def predict_bytes(self, data: bytes, timeout: Optional[float] = None,
                      want_mask: bool = True) -> Dict:
        """predict_pil on raw JPEG/PNG bytes, decoded and resized by the
        native library (the same bytes as PIL's; the response mask's resize
        native too) unless CVLM_NATIVE_PREPROC=0. A container the decoder
        does not take goes through PIL (counted); an undecodable body raises
        OSError or ValueError."""
        if _nat.enabled():
            img = _nat.decode(data, 3)
            if img is not None:
                h, w = img.shape[:2]
                fut = self.submit(_npp.sam_image_resized_u8(img, self.cfg.inp_size),
                                  _npp.clip_image_resized_u8(img, self.cfg.clip_size))
                return self._respond(fut, w, h, timeout, want_mask, native=True)
            with self._stats_lock:
                self._stats["pil_fallbacks"] += 1
        return self.predict_pil(Image.open(io.BytesIO(data)), timeout, want_mask)

    def _respond(self, fut: Future, w: int, h: int, timeout, want_mask: bool,
                 native: bool) -> Dict:
        probs, pred, score = fut.result(timeout=timeout)
        cls_id = int(pred)
        out = {
            "class_id": cls_id,
            "class": self.classnames[cls_id],
            "score": float(np.asarray(score, np.float32)[cls_id]),
        }
        if not want_mask:
            return out
        if probs is None:
            raise RuntimeError("mask requested but the engine was built with "
                               "return_mask=False (classification-only program)")
        # round (not truncate), so that the float16 path quantises to the
        # uint8 program's mask
        m8 = probs if probs.dtype == np.uint8 else np.round(
            probs.astype(np.float32) * 255).astype(np.uint8)
        if native:
            out["mask"] = _nat.resize(m8, (w, h), _nat.BILINEAR)  # (h, w) in, (h, w) out
        else:
            out["mask"] = np.asarray(Image.fromarray(m8).resize((w, h), Image.BILINEAR))
        return out

    def stats(self) -> Dict:
        with self._stats_lock:
            s = dict(self._stats)
            s["batch_size_hist"] = dict(self._stats["batch_size_hist"])
            s["bucket_latency_ms"] = {
                b: {**v, "mean": v["sum"] / v["count"]}
                for b, v in self._stats["bucket_latency_ms"].items()
            }
        if s["requests"]:
            s["latency_ms_mean"] = s["latency_ms_sum"] / s["requests"]
        s["pad_fraction"] = (
            1.0 - s["requests"] / s["batched_images"] if s["batched_images"] else 0.0)
        s["ready"] = self.ready()
        return s

    def close(self) -> None:
        """Graceful drain: everything queued before shutdown still runs (the
        sentinel rides the FIFO behind it); anything racing in after is
        rejected by submit(), never left hanging. The completion thread's
        sentinel is planted by the batching thread as it exits, behind the
        last dispatched batch, so every future resolves even if the joins
        below time out."""
        with self._submit_lock:
            self._stop = True
            self._queue.put(_SENTINEL)
        self._worker.join(timeout=60)
        self._completer.join(timeout=60)
        if not self._worker.is_alive():
            with self._graph_lock:  # the graphs and their memory pool go now
                self._command(_STOP)  # the followers of a mesh return
                self._graphs.clear()

    # ---- batching thread

    def _bucket_for(self, n: int) -> int:
        for b in self.serve_cfg.buckets:
            if b >= n:
                return b
        return self.serve_cfg.buckets[-1]

    def _worker_loop(self) -> None:
        if self._cuda:
            torch.cuda.set_device(self.device)
        max_batch = self.serve_cfg.buckets[-1]
        delay_s = self.serve_cfg.max_delay_ms / 1e3
        try:
            while True:
                first = self._queue.get()
                if first is _SENTINEL:
                    return
                batch: List[_Request] = [first]
                deadline = time.monotonic() + delay_s
                while len(batch) < max_batch:
                    remaining = deadline - time.monotonic()
                    try:
                        item = (self._queue.get(timeout=remaining) if remaining > 0
                                else self._queue.get_nowait())
                    except queue.Empty:
                        break
                    if item is _SENTINEL:
                        self._flush(batch)
                        return
                    batch.append(item)
                self._flush(batch)
        finally:
            self._inflight.put(_SENTINEL)

    def _flush(self, batch: List[_Request]) -> None:
        """Stack, ship and run one batch; the completion thread fetches."""
        n = len(batch)
        bucket = self._bucket_for(n)
        try:
            pad = [batch[-1]] * (bucket - n)
            inp = np.stack([r.inp for r in batch + pad])
            cimg = np.stack([r.cimg for r in batch + pad])
            with self._graph_lock:
                if bucket not in self._graphs:
                    self._command(_CAPTURE, bucket)
                    self._graph_for(bucket)
                self._command(_RUN, bucket)
                if self._cuda:
                    with torch.cuda.stream(self._stream):
                        outs = self._run_bucket(bucket, self._put(inp), self._put(cimg))
                        host = tuple(self._to_host(o) for o in outs)
                        done = torch.cuda.Event()
                        done.record(self._stream)
                else:
                    host, done = self._run_bucket(bucket, self._put(inp), self._put(cimg)), None
        except Exception as e:  # capture or launch failure: fail the batch, not the server
            self._fail_batch(batch, e)
            return
        # blocks when max_inflight batches already await their download
        self._inflight.put((batch, bucket, host, done))

    def _fail_batch(self, batch: List[_Request], e: Exception) -> None:
        with self._stats_lock:
            self._stats["errors"] += len(batch)
        for r in batch:
            r.future.set_exception(e)

    # ---- completion thread

    def _completer_loop(self) -> None:
        if self._cuda:
            torch.cuda.set_device(self.device)
        while True:
            item = self._inflight.get()
            if item is _SENTINEL:
                return
            batch, bucket, host, done = item
            try:
                if done is not None:
                    done.synchronize()  # this batch's copies, not the device
                if len(host) == 2:  # the return_mask=False program
                    probs = None
                    pred, score = host
                else:
                    probs, pred, score = host
                    probs = probs.numpy()
                pred = pred.numpy()
                score = score.float().numpy()
            except Exception as e:  # a device-side failure surfaces here
                self._fail_batch(batch, e)
                continue
            n = len(batch)
            now = time.monotonic()
            with self._stats_lock:
                s = self._stats
                s["requests"] += n
                s["batches"] += 1
                s["batched_images"] += bucket
                s["batch_size_hist"][n] = s["batch_size_hist"].get(n, 0) + 1
                bl = s["bucket_latency_ms"].setdefault(
                    bucket, {"count": 0, "sum": 0.0, "max": 0.0})
                for r in batch:
                    lat = (now - r.t_enqueue) * 1e3
                    s["latency_ms_sum"] += lat
                    s["latency_ms_max"] = max(s["latency_ms_max"], lat)
                    bl["count"] += 1
                    bl["sum"] += lat
                    bl["max"] = max(bl["max"], lat)
            for i, r in enumerate(batch):
                r.future.set_result(
                    (None if probs is None else probs[i], int(pred[i]), score[i]))


def bench_engine(engine: InferenceEngine, n_images: int = 128, stage_inputs: bool = True,
                 pool: int = 4, seed: int = 0) -> Dict:
    """In-process engine benchmark: the serving ceiling without the network.

    Drives the real batcher and completion threads (submit -> coalesce ->
    pad to a bucket -> the bucket's program -> pipelined fetch) with
    pre-resized uint8 inputs: no HTTP, no decode, no per-request
    preprocessing. With `stage_inputs=True` a shape-keyed device cache
    stands behind `_put`, so each bucket's input is uploaded once and every
    later batch reuses it (the static inputs are then refreshed by a
    device-to-device copy). With a `return_mask=False` engine the only
    per-batch download is the class ids and logits.

    Call `engine.warmup()` first: the captures are not part of the
    measurement. Returns {images_per_sec, elapsed_s, n_images, staged,
    return_mask, bucket_latency_ms, batch_size_hist, pad_fraction}.
    """
    cfg = engine.cfg
    rng = np.random.default_rng(seed)
    inps = [rng.integers(0, 256, (cfg.inp_size, cfg.inp_size, 3), dtype=np.uint8)
            for _ in range(pool)]
    cimgs = [rng.integers(0, 256, (cfg.clip_size, cfg.clip_size, 3), dtype=np.uint8)
             for _ in range(pool)]

    if stage_inputs:
        staged: Dict = {}
        orig_put = engine._put

        def _staged_put(a):
            key = (a.shape, str(a.dtype))
            if key not in staged:
                staged[key] = orig_put(a).to(engine.device)
            return staged[key]

        engine._put = _staged_put
    try:
        t0 = time.monotonic()
        futures = [engine.submit(inps[i % pool], cimgs[i % pool]) for i in range(n_images)]
        for f in futures:
            f.result(timeout=600)
        elapsed = time.monotonic() - t0
    finally:
        if stage_inputs:
            del engine._put  # the method again

    stats = engine.stats()
    return {
        "images_per_sec": n_images / elapsed,
        "elapsed_s": elapsed,
        "n_images": n_images,
        "staged": stage_inputs,
        "return_mask": engine.serve_cfg.return_mask,
        "bucket_latency_ms": stats["bucket_latency_ms"],
        "batch_size_hist": stats["batch_size_hist"],
        "pad_fraction": stats["pad_fraction"],
    }
