"""Host-to-device frame staging that overlaps compute.

Port of ``zero_tig_tpu/data/prefetch.py`` (:1-208). A background thread
decodes the next frames and stages them on the device while the consumer
computes on the current ones: ``device_prefetch`` one frame at a time,
``chunk_prefetch`` K frames as one block. The semantics are the JAX
package's: a uint8 frame ships as uint8 and is normalised on the device by
one eager ``float() / 255`` (the value ``pipeline.steps`` computes from the
same bytes, bit for bit); the trailing partial group of a chunked stream
comes as per-frame ``DeviceRecord``s; an exception in the thread is raised
to the consumer.

On a CUDA device the block is copied from pinned host memory with
``non_blocking=True`` on a stream the prefetcher owns. The consumer's
current stream waits on an event recorded after the copy and the
normalise, and each tensor is marked with ``record_stream`` for the
consumer's stream, so the caching allocator does not hand its memory to a
later chunk while a kernel of the consumer still reads it. On the CPU the
same work runs without streams.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from ..core.device import resolve_device
from .datasets import FrameRecord


class DeviceRecord:
    """A frame already on the device."""

    __slots__ = ("image", "name", "path", "is_new_seq")

    def __init__(self, image, name, path, is_new_seq):
        self.image = image  # (1, H, W, 3) float tensor on the device
        self.name = name
        self.path = path
        self.is_new_seq = is_new_seq


class ChunkRecord:
    """K consecutive frames staged as one block."""

    __slots__ = ("images", "flags", "records")

    def __init__(self, images, flags, records):
        self.images = images  # (K, 1, H, W, 3) float tensor on the device
        self.flags = flags  # (K,) bool tensor on the device
        self.records = records  # the host FrameRecords, for names and paths


class _Stager:
    """Copies host arrays to ``device``, on a side stream on a card."""

    def __init__(self, device, dtype: torch.dtype):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _put(self, host: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(host))
        if self.stream is None:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _norm(self, t: torch.Tensor) -> torch.Tensor:
        # one eager normalise on the device (JAX :169-171)
        return t.to(self.dtype) / 255.0 if t.dtype == torch.uint8 else t.to(self.dtype)

    def stage(self, host_images: np.ndarray, host_flags: np.ndarray | None = None):
        """(images, flags or None, event or None): the event marks the end of
        the copies and the normalise on the prefetcher's stream."""
        if self.stream is None:
            flags = None if host_flags is None else self._put(host_flags)
            return self._norm(self._put(host_images)), flags, None
        with torch.cuda.stream(self.stream):
            images = self._norm(self._put(host_images))
            flags = None if host_flags is None else self._put(host_flags)
            event = torch.cuda.Event()
            event.record(self.stream)
        return images, flags, event

    def hand_over(self, event, *tensors: torch.Tensor | None) -> None:
        """In the consumer's thread: its stream waits for the staging, and
        the tensors' memory stays theirs until its work on them is done."""
        if event is None:
            return
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        for t in tensors:
            if t is not None:
                t.record_stream(consumer)


def _run(produce, stager: _Stager, depth: int) -> Iterator:
    """Run ``produce(put)`` in a thread, yield what it puts, in order."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    sentinel = object()
    error: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            produce(put)
        except BaseException as e:  # re-raised in the consumer
            error.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            out, event, tensors = item
            stager.hand_over(event, *tensors)
            yield out
    finally:
        stop.set()  # a consumer that stops early ends the thread at its next put
        t.join()


def _frame_item(stager: _Stager, rec: FrameRecord):
    img, _, event = stager.stage(np.asarray(rec.image)[None])
    return DeviceRecord(img, rec.name, rec.path, rec.is_new_seq), event, (img,)


def device_prefetch(
    records: Iterable[FrameRecord],
    *,
    depth: int = 2,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Iterator[DeviceRecord]:
    """The records as ``DeviceRecord``s, staged ``depth`` ahead by a thread.
    ``device`` None means the card (and raises without one)."""
    stager = _Stager(device, dtype)

    def produce(put):
        for rec in records:
            if not put(_frame_item(stager, rec)):
                return

    return _run(produce, stager, depth)


def chunk_prefetch(
    records: Iterable[FrameRecord],
    k: int,
    *,
    depth: int = 2,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Iterator[ChunkRecord | DeviceRecord]:
    """Whole chunks: the thread stacks K uint8 frames on the host, copies the
    (K, 1, H, W, 3) block to the device once and normalises it once. The
    trailing partial group comes as per-frame ``DeviceRecord``s, so callers
    take the per-frame step for it. ``k <= 1`` is ``device_prefetch``."""
    if k <= 1:
        yield from device_prefetch(records, depth=depth, device=device, dtype=dtype)
        return
    stager = _Stager(device, dtype)

    def produce(put):
        buf: list[FrameRecord] = []
        for rec in records:
            buf.append(rec)
            if len(buf) == k:
                imgs = np.stack([np.asarray(r.image) for r in buf])[:, None]
                flags = np.array([r.is_new_seq for r in buf], dtype=bool)
                images, dflags, event = stager.stage(imgs, flags)
                if not put((ChunkRecord(images, dflags, list(buf)), event, (images, dflags))):
                    return
                buf = []
        for rec in buf:  # the trailing partial group, frame by frame
            if not put(_frame_item(stager, rec)):
                return

    yield from _run(produce, stager, depth)
