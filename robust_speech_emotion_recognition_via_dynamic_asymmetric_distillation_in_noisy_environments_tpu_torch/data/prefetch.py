"""Asynchronous host-side input pipeline.

:func:`prefetch` wraps any batch iterable: a daemon worker thread assembles
batch N+1 (numpy) while the device runs step N. The queue is bounded, so
host memory stays flat, and the worker stops if the consumer abandons the
iterator early (early stopping mid-epoch). An exception in the worker is
raised again in the consumer.

With ``to_device=True`` every numpy leaf of an item (a ``Batch``, or
tuples, lists and dicts of them) becomes a tensor on ``device``. On a GPU
the worker copies each leaf into pinned host memory and from there with
``non_blocking=True`` on a side CUDA stream, then records an event; the
consumer's stream waits on that event before it touches the batch, and
each device tensor is ``record_stream``-ed on the consumer's stream so its
memory is not reused while queued work still reads it. The pinned buffers
are kept until their copy's event has passed, so the worker can never
overwrite a buffer that a copy still reads.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional, TypeVar

import numpy as np
import torch

from ..utils.device import resolve_device

T = TypeVar("T")

_END = object()


class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def tree_map(fn: Callable[[Any], Any], item: Any) -> Any:
    """``fn`` over the leaves of NamedTuples, tuples, lists and dicts."""
    if isinstance(item, tuple) and hasattr(item, "_fields"):
        return type(item)(*(tree_map(fn, v) for v in item))
    if isinstance(item, (tuple, list)):
        return type(item)(tree_map(fn, v) for v in item)
    if isinstance(item, dict):
        return {k: tree_map(fn, v) for k, v in item.items()}
    return fn(item)


def _tensors(item: Any) -> list:
    out: list = []
    tree_map(lambda x: out.append(x) if isinstance(x, torch.Tensor) else None, item)
    return out


class _Transfer:
    """numpy leaves -> tensors on ``device``; f32 leaves through ``narrow``
    (cast on the host, cast back to f32 on the device)."""

    def __init__(self, device: torch.device, narrow: Optional[torch.dtype]):
        self.device = device
        self.narrow = narrow
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def _leaf(self, x: Any, pinned: list) -> Any:
        if not isinstance(x, np.ndarray):
            return x
        src = torch.from_numpy(x)
        narrow = self.narrow if x.dtype == np.float32 else None
        if self.stream is None:
            return src if narrow is None else src.to(narrow).to(torch.float32)
        host = torch.empty(src.shape, dtype=narrow or src.dtype, pin_memory=True)
        host.copy_(src)  # the cast to ``narrow`` happens here, on the host
        pinned.append(host)
        dev = host.to(self.device, non_blocking=True)
        return dev if narrow is None else dev.to(torch.float32)

    def put(self, item: Any):
        """Starts the item's copies; returns (item on the device, the event
        that ends its copies or None, the pinned buffers they read)."""
        pinned: list = []
        if self.stream is None:
            return tree_map(lambda x: self._leaf(x, pinned), item), None, pinned
        with torch.cuda.stream(self.stream):
            out = tree_map(lambda x: self._leaf(x, pinned), item)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event, pinned


class _Receiver:
    """The consumer's side: orders its stream after each item's copies and
    keeps pinned buffers alive until their copies have finished."""

    def __init__(self, device: torch.device):
        self.device = device
        self.inflight: collections.deque = collections.deque()

    def take(self, packet) -> Any:
        item, event, pinned = packet
        if event is None:
            return item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in _tensors(item):
            t.record_stream(stream)
        self.inflight.append((event, pinned))
        while self.inflight and self.inflight[0][0].query():
            self.inflight.popleft()
        return item

    def close(self) -> None:
        while self.inflight:
            event, _pinned = self.inflight.popleft()
            event.synchronize()


def prefetch(
    iterable: Iterable[T],
    depth: int = 2,
    to_device: bool = False,
    transfer_fp32_as: Optional[str] = None,
    device="cuda",
) -> Iterator[T]:
    """Yields items from ``iterable``, produced ``depth`` items ahead on a
    background thread.

    ``to_device=True`` makes every numpy leaf a tensor on ``device`` (the
    copies run on the worker thread, overlapping the device's work on the
    previous item). ``depth <= 0`` iterates synchronously and still
    transfers.

    ``transfer_fp32_as`` (e.g. ``"bfloat16"``, implies ``to_device``):
    float32 leaves are cast on the host to the narrower dtype before the
    copy and back to float32 on the device, halving host-to-device bytes.
    Opt-in: it rounds the inputs to that dtype.
    """
    transfer = receiver = None
    if to_device or transfer_fp32_as:
        narrow = None
        if transfer_fp32_as:
            narrow = getattr(torch, transfer_fp32_as, None)
            if not isinstance(narrow, torch.dtype) or not narrow.is_floating_point:
                raise ValueError(f"transfer_fp32_as={transfer_fp32_as!r} is not a float dtype")
        dev = resolve_device(device)
        transfer, receiver = _Transfer(dev, narrow), _Receiver(dev)

    if depth <= 0:
        if transfer is None:
            yield from iterable
            return
        try:
            for item in iterable:
                yield receiver.take(transfer.put(item))
        finally:
            receiver.close()
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _enqueue(item) -> bool:
        # bounded put that gives up if the consumer went away
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker():
        try:
            if transfer is not None and transfer.device.type == "cuda":
                torch.cuda.set_device(transfer.device)
            for item in iterable:
                packet = transfer.put(item) if transfer is not None else item
                if not _enqueue(packet):
                    return
        except BaseException as e:  # re-raised in the consumer
            _enqueue(_WorkerError(e))
            return
        _enqueue(_END)

    t = threading.Thread(target=_worker, daemon=True, name="dad-torch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _WorkerError):
                raise item.exc
            yield receiver.take(item) if receiver is not None else item
    finally:
        stop.set()
        if receiver is not None:
            receiver.close()
