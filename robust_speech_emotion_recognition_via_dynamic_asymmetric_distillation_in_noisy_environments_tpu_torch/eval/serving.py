"""Inference serving: micro-batched, bucket-static prediction.

Request shapes snap to a fixed (batch, bucket) grid, and concurrent
requests are coalesced into full batches by a dispatcher thread
(micro-batching), so single-clip requests ride along with whatever else is
in flight.

Two entry layers:
- ``EmotionPredictor``: synchronous API over features or raw waveforms.
- ``PredictionServer``: stdlib HTTP server with ``POST /predict`` and
  ``GET /healthz``; handler threads enqueue requests, one dispatcher drains
  the queue into predictor batches.

Spans (``utils/profiling.py``, on ``time.monotonic``): ``serving.request``
(a handler thread, from ``do_POST`` to the reply written),
``serving.queue`` (from the handler's put to the dispatcher's get;
``batch``), ``serving.collect`` (the dispatcher, from a group's first get
to its close), ``serving.batch`` (one B-chunk; ``batch``) and under it
``serving.assemble`` (padding and the host-to-device copy; on the wav
path ``samples``, each clip's length, in the batch's row order) and
``serving.results`` (the reply dicts, once the probabilities are on the
host); a second ``serving.results`` spans setting a group's futures. The
rest of a batch is the forward's issue and the wait for its copy back.
"""

from __future__ import annotations

import itertools
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch.func import functional_call

from ..configs import DADConfig
from ..dad.train_step import make_eval_step
from ..models.extract import _bucket  # rounds UP past the top bucket —
# a long clip gets a bigger batch instead of silent truncation
from ..models.heads import DADHead, SSRLState
from ..utils import get_logger, profiling, resolve_device

logger = get_logger(__name__)

FRAME_BUCKETS = (64, 128, 256, 512, 1024, 2048)

_batch_ids = itertools.count(1)  # unique in the process, for the spans


class EmotionPredictor:
    """Bucket-static emotion prediction over features or waveforms.

    ``extractor`` (a ``models.extract.FeatureExtractor`` on the same device)
    is optional; with it, ``predict_wavs`` runs the full
    wav -> emotion2vec -> head path on the device.
    """

    def __init__(
        self,
        cfg: DADConfig,
        ssrl: SSRLState,
        extractor=None,
        batch_size: int = 16,
        frame_buckets: Sequence[int] = FRAME_BUCKETS,
        use_teacher: bool = False,
        wav_transfer_dtype: str = "float32",
        device: Union[str, torch.device] = "cuda",
    ):
        """``wav_transfer_dtype="int16"`` ships wav batches to the device as
        int16 PCM and rescales by 1/32768 on the device, halving the
        host->device bytes. Lossless for int16 PCM sources; float inputs
        are quantized to 1/32768 resolution."""
        if wav_transfer_dtype not in ("float32", "int16"):
            raise ValueError(f"bad wav_transfer_dtype {wav_transfer_dtype!r}")
        self.device = resolve_device(device)
        if extractor is not None and extractor.device != self.device:
            raise ValueError(
                f"extractor is on {extractor.device}, predictor on {self.device}"
            )
        self.cfg = cfg
        # head params live on the device once, not re-uploaded per call
        self.ssrl = SSRLState(
            student={k: v.to(self.device) for k, v in ssrl.student.items()},
            teacher={k: v.to(self.device) for k, v in ssrl.teacher.items()},
        )
        self.extractor = extractor
        self.batch_size = batch_size
        self.frame_buckets = tuple(frame_buckets)
        self.use_teacher = use_teacher
        self.wav_transfer_dtype = wav_transfer_dtype
        with torch.device(self.device):
            self.head = DADHead(
                cfg.input_dim, cfg.hidden_dim, cfg.num_classes, cfg.dropout_rate
            )
        self.head.eval().requires_grad_(False)
        self._eval = make_eval_step(self.head)
        self.class_names = list(cfg.class_names)  # id-sorted property
        self.requests_served = 0
        self.batches_run = 0
        self._local = threading.local()

    @property
    def _params(self):
        return self.ssrl.teacher if self.use_teacher else self.ssrl.student

    @torch.no_grad()
    def _wav_eval(self, wav: torch.Tensor, wav_mask: torch.Tensor) -> torch.Tensor:
        """wav -> logits on the device: only (B, C) leaves it."""
        if not wav.is_floating_point():
            wav = wav.float() / 32768.0  # int16 PCM transfer: rescale on device
        feats, frame_mask = self.extractor.forward_batch(wav, wav_mask)
        logits, _ = functional_call(self.head, self._params, (feats, frame_mask))
        return logits

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Runs the head for each frame bucket and the wav -> logits path for
        EVERY extractor bucket once, so the first request of a bucket pays
        no one-time cost (allocator growth, cuDNN plans, kernel build) on
        the single dispatcher thread."""
        for T in buckets or self.frame_buckets:
            feats = torch.zeros((self.batch_size, T, self.cfg.input_dim),
                                device=self.device)
            mask = torch.ones((self.batch_size, T), dtype=torch.bool,
                              device=self.device)
            preds, _ = self._eval(self._params, feats, mask)
            preds.cpu()  # host copy = sync
        if self.extractor is not None:
            for n in self.extractor.buckets:
                self.predict_wavs([np.zeros(n, np.float32)])
        # warmup traffic must not skew the /healthz serving counters
        self.requests_served = 0
        self.batches_run = 0
        logger.info("predictor warm: %d head buckets", len(self.frame_buckets))

    def predict_features(self, clips: Sequence[np.ndarray]) -> List[Dict[str, Any]]:
        """clips: list of (t, input_dim) float arrays. Returns one dict per
        clip: {label, label_id, probs}."""
        order = np.argsort([len(c) for c in clips], kind="stable")
        results: List[Optional[Dict[str, Any]]] = [None] * len(clips)

        def run(group):
            with profiling.span("serving.assemble"):
                T = _bucket(max(len(c) for c in group), self.frame_buckets)
                feats = np.zeros((self.batch_size, T, self.cfg.input_dim), np.float32)
                mask = np.ones((self.batch_size, T), bool)
                for row, c in enumerate(group):
                    t = min(len(c), T)
                    feats[row, :t] = c[:t]
                    mask[row, :t] = False
                feats = torch.from_numpy(feats).to(self.device)
                mask = torch.from_numpy(mask).to(self.device)
            _preds, logits = self._eval(self._params, feats, mask)
            return logits

        return self._predict_grouped(clips, order, results, run)

    def predict_wavs(self, wavs: Sequence[np.ndarray]) -> List[Dict[str, Any]]:
        """``wavs``: 1-D clips, float (samples in [-1, 1]) or int16 PCM.
        The batch ships to the device in ``wav_transfer_dtype``."""
        if self.extractor is None:
            raise RuntimeError(
                "no encoder loaded — pass --checkpoint to serve wav requests"
            )
        i16 = self.wav_transfer_dtype == "int16"
        clips = []
        for w in wavs:
            w = np.asarray(w)
            if w.dtype == np.int16:
                clips.append(w if i16 else w.astype(np.float32) / 32768.0)
            elif i16:
                clips.append(
                    np.clip(np.rint(np.asarray(w, np.float32) * 32768.0),
                            -32768, 32767).astype(np.int16)
                )
            else:
                clips.append(np.asarray(w, np.float32))
        order = np.argsort([len(c) for c in clips], kind="stable")
        results: List[Optional[Dict[str, Any]]] = [None] * len(clips)
        batch_dtype = np.int16 if i16 else np.float32

        def run(group):
            with profiling.span("serving.assemble", samples=tuple(len(c) for c in group)):
                T = _bucket(max(len(c) for c in group), self.extractor.buckets)
                wav = np.zeros((self.batch_size, T), batch_dtype)
                mask = np.ones((self.batch_size, T), bool)
                for row, c in enumerate(group):
                    wav[row, : len(c)] = c
                    mask[row, : len(c)] = False
                wav = torch.from_numpy(wav).to(self.device)
                mask = torch.from_numpy(mask).to(self.device)
            return self._wav_eval(wav, mask)

        return self._predict_grouped(clips, order, results, run)

    def _predict_grouped(self, clips, order, results, run_batch):
        """Shared length-sorted micro-batch loop: calls ``run_batch(group)``
        per B-chunk for logits and assembles per-clip result dicts in the
        caller's original order."""
        B = self.batch_size
        batch_of = [0] * len(clips)
        for start in range(0, len(order), B):
            idx = order[start : start + B]
            bid = next(_batch_ids)
            with profiling.span("serving.batch", batch=bid):
                logits = run_batch([clips[i] for i in idx])
                probs = torch.softmax(logits, dim=-1).cpu().numpy()
                with profiling.span("serving.results"):
                    for row, i in enumerate(idx):
                        k = int(np.argmax(probs[row]))
                        results[int(i)] = {
                            "label": self.class_names[k],
                            "label_id": k,
                            "probs": {
                                name: float(probs[row, j])
                                for j, name in enumerate(self.class_names)
                            },
                        }
                        batch_of[int(i)] = bid
            self.batches_run += 1
        self.requests_served += len(clips)
        self._local.batch_of = batch_of
        return results

    def last_batch_ids(self) -> List[int]:
        """The batch id of each clip of this thread's last predict call, in
        the caller's order (the ``batch`` of its ``serving.batch`` span)."""
        return getattr(self._local, "batch_of", [])


class _WorkItem:
    __slots__ = ("kind", "payload", "future", "t_put", "t_get")

    def __init__(self, kind: str, payload: np.ndarray):
        self.kind = kind
        self.payload = payload
        self.future: Future = Future()
        self.t_put = self.t_get = 0.0  # queue entry and exit, time.monotonic


class PredictionServer:
    """Micro-batching HTTP server around an ``EmotionPredictor``.

    POST /predict with a JSON body of one of:
      {"features": [[...frame vectors...], ...]}   one clip, (t, dim)
      {"wav": [...], "sr": 16000}                  one clip waveform (floats)
      {"pcm16": "<base64 LE int16>", "sr": 16000}  one clip, compact PCM
    Responds {"label": ..., "label_id": ..., "probs": {...}}.

    Requests from concurrent clients are coalesced: the dispatcher waits up
    to ``max_wait_ms`` to fill ``max_batch`` slots, then runs one predictor
    call for the whole group.
    """

    def __init__(
        self,
        predictor: EmotionPredictor,
        host: str = "127.0.0.1",
        port: int = 8476,
        max_batch: Optional[int] = None,
        max_wait_ms: float = 5.0,
        max_body_bytes: int = 64 << 20,
        max_wav_samples: int = 480_000,  # top extraction bucket (30 s)
        max_feature_frames: Optional[int] = None,
    ):
        """``max_wav_samples``/``max_feature_frames`` cap request length at
        ingress: a longer clip would run past the top (warmed) bucket on the
        single dispatcher thread, stalling every coalesced client behind it.
        ``max_feature_frames`` defaults to the predictor's top frame bucket."""
        if max_feature_frames is None:
            max_feature_frames = max(predictor.frame_buckets)
        self.predictor = predictor
        self.max_batch = max_batch or predictor.batch_size
        self.max_wait_ms = max_wait_ms
        self.max_body_bytes = max_body_bytes
        self.max_wav_samples = max_wav_samples
        self.max_feature_frames = max_feature_frames
        self._queue: "queue.Queue[_WorkItem]" = queue.Queue()
        self._stop = threading.Event()
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route through our logger
                logger.debug("http: " + fmt, *args)

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, server.health())
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                with profiling.span("serving.request"):
                    if self.path != "/predict":
                        self._json(404, {"error": "unknown path"})
                        return
                    try:
                        item = server._parse_request(self)
                    except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
                        self._json(400, {"error": str(e)})
                        return
                    if item is None:
                        self._json(413, {"error": "body too large"})
                        return
                    if server._stop.is_set():
                        self._json(503, {"error": "server shutting down"})
                        return
                    item.t_put = time.monotonic()
                    server._queue.put(item)
                    if server._stop.is_set():
                        # closes the put-after-final-drain race: either the
                        # dispatcher/drain completed the future first (done)
                        # or we fail it here — no client waits out the timeout
                        try:
                            item.future.set_exception(
                                RuntimeError("server shutting down")
                            )
                        except Exception:  # already completed — fine
                            pass
                    try:
                        self._json(200, item.future.result(timeout=120))
                    except Exception as e:  # noqa: BLE001 — report, don't crash
                        self._json(500, {"error": str(e)})

        class Server(ThreadingHTTPServer):
            # socketserver's default listen backlog of 5 RSTs connections
            # under bursty concurrent load (the whole point of micro-batching)
            request_queue_size = 128
            daemon_threads = True

        self._httpd = Server((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]

    def _parse_request(self, handler) -> Optional[_WorkItem]:
        """Reads and validates one /predict body at ingress, so one bad
        request cannot poison the micro-batch it coalesces into. Returns
        None for a body over the size cap."""
        n = int(handler.headers.get("Content-Length", "0"))
        if n < 0:
            # rfile.read(-1) would block on EOF forever on a keep-alive
            # socket, pinning this handler thread
            raise ValueError("bad Content-Length")
        if n > self.max_body_bytes:
            return None
        req = json.loads(handler.rfile.read(n))
        if not isinstance(req, dict):
            raise ValueError("body must be a JSON object")
        dim = self.predictor.cfg.input_dim
        if "features" in req:
            arr = np.asarray(req["features"], np.float32)
            if arr.ndim != 2 or arr.shape[0] < 1 or arr.shape[1] != dim:
                raise ValueError(f"'features' must be (t, {dim}), got {arr.shape}")
            if arr.shape[0] > self.max_feature_frames:
                raise ValueError(
                    f"'features' too long ({arr.shape[0]} > "
                    f"{self.max_feature_frames} frames)"
                )
            return _WorkItem("features", arr)
        if "wav" in req:
            arr = np.asarray(req["wav"], np.float32)
            if arr.ndim != 1 or arr.shape[0] < 1:
                raise ValueError(f"'wav' must be a 1-D sample list, got {arr.shape}")
            if arr.shape[0] > self.max_wav_samples:
                raise ValueError(
                    f"'wav' too long ({arr.shape[0]} > {self.max_wav_samples} samples)"
                )
            return _WorkItem("wav", arr)
        if "pcm16" in req:
            # base64 little-endian int16 PCM: ~9x smaller on the wire than
            # JSON floats, and rides to the device unconverted in int16 mode
            import base64

            raw = base64.b64decode(req["pcm16"], validate=True)
            if len(raw) < 2 or len(raw) % 2:
                raise ValueError(
                    "'pcm16' must be base64 of >=1 little-endian int16 samples"
                )
            if len(raw) // 2 > self.max_wav_samples:
                raise ValueError(
                    f"'pcm16' too long ({len(raw) // 2} > "
                    f"{self.max_wav_samples} samples)"
                )
            return _WorkItem("wav", np.frombuffer(raw, "<i2"))
        raise ValueError("body needs 'features', 'wav' or 'pcm16'")

    def health(self) -> Dict[str, Any]:
        return {
            "status": "ok",
            "classes": self.predictor.class_names,
            "wav_input": self.predictor.extractor is not None,
            "pcm16_input": self.predictor.extractor is not None,
            "wav_transfer_dtype": self.predictor.wav_transfer_dtype,
            "requests_served": self.predictor.requests_served,
            "batches_run": self.predictor.batches_run,
            "max_batch": self.max_batch,
        }

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            t0 = first.t_get = time.monotonic()
            group = [first]
            deadline = t0 + self.max_wait_ms / 1e3
            while len(group) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                item.t_get = time.monotonic()
                group.append(item)
            profiling.add_span("serving.collect", t0, time.monotonic())
            self._run_group(group)

    def _run_group(self, group: List[_WorkItem]) -> None:
        # wavs and features take different compute paths; split the group
        for kind in ("features", "wav"):
            items = [it for it in group if it.kind == kind]
            if not items:
                continue
            batch_of = [0] * len(items)
            try:
                if kind == "features":
                    outs = self.predictor.predict_features(
                        [it.payload for it in items]
                    )
                else:
                    outs = self.predictor.predict_wavs([it.payload for it in items])
                batch_of = self.predictor.last_batch_ids()
                with profiling.span("serving.results"):
                    for it, out in zip(items, outs):
                        # a future already failed (e.g. by shutdown's drain)
                        # must not abort delivery for the rest of the group
                        if not it.future.done():
                            it.future.set_result(out)
            except Exception as e:  # noqa: BLE001 — fail the whole group
                logger.exception("predictor batch failed")
                for it in items:
                    if not it.future.done():
                        it.future.set_exception(e)
            for it, bid in zip(items, batch_of):
                profiling.add_span("serving.queue", it.t_put, it.t_get, batch=bid)

    def _start_dispatcher(self) -> None:
        if not self._dispatcher.is_alive():
            self._dispatcher.start()
        logger.info("serving on %s:%d (max_batch=%d, wait=%.1fms)",
                    self.host, self.port, self.max_batch, self.max_wait_ms)

    def start(self) -> None:
        self._start_dispatcher()
        self._serving = True
        self._server_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._server_thread.start()

    def serve_forever(self) -> None:
        self._start_dispatcher()
        self._serving = True
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        # stop accepting first: a handler that enqueues after the drain
        # would otherwise hang its client for the full future timeout.
        # BaseServer.shutdown() blocks on an event only serve_forever sets
        # on exit — calling it before the serve loop ever started would
        # deadlock forever
        if getattr(self, "_serving", False):
            self._httpd.shutdown()
        self._stop.set()
        # fail anything still queued so blocked handler threads return
        # immediately instead of waiting out their client timeout; drain
        # twice with a grace beat to catch requests parsed mid-shutdown
        for _ in range(2):
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if not item.future.done():
                    item.future.set_exception(RuntimeError("server shutting down"))
            time.sleep(0.05)
        self._httpd.server_close()
        if self._dispatcher.is_alive():
            self._dispatcher.join(timeout=5.0)
