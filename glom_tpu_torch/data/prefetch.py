"""Input prefetch: stage the next batches while the current step runs.

Counterpart of `glom_tpu/data/prefetch.py`. A worker thread pulls batches
from the source and, for a CUDA device, copies each into pinned host
memory. The consumer starts each batch's host-to-device copy on a side
CUDA stream one batch ahead, so the copy of batch i+1 overlaps step i, and
makes the compute stream wait on that copy's event before it hands the
batch out. For the CPU the worker's staging is all there is.

The worker's two host phases are span-covered, as glom_tpu's are:
host_prefetch_next (pulling from the source iterator) and
host_prefetch_stage (making the tensor, pinned for a CUDA device). Their
per-phase rollup "span" records go to `metrics_writer` (else to the flight
recorder) when the stream ends.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

_END = object()


def prefetch_to_device(
    data: Iterator, *, size: int = 2, device="cuda", metrics_writer=None
) -> Iterator[torch.Tensor]:
    """Wrap `data` (numpy arrays or tensors) so up to `size` batches are
    staged ahead. Exceptions from `data` reach the consumer at the failed
    batch; dropping the iterator stops the worker."""
    from glom_tpu_torch.tracing.flight import write_or_observe
    from glom_tpu_torch.tracing.spans import SpanAggregator, spanned

    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    device = torch.device(device)
    cuda = device.type == "cuda"
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    spans = SpanAggregator()

    def to_tensor(batch):
        t = torch.as_tensor(np.asarray(batch) if not torch.is_tensor(batch) else batch)
        return t.pin_memory() if cuda else t

    stage = spanned("host_prefetch_stage", aggregator=spans)(to_tensor)
    pull_next = spanned("host_prefetch_next", aggregator=spans)(lambda it: next(it, _END))

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    iter_data = iter(data)

    def worker():
        try:
            while True:
                batch = pull_next(iter_data)
                if batch is _END:
                    break
                if not put(stage(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            put((_END, e))
            return
        put((_END, None))

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    side = torch.cuda.Stream(device) if cuda else None

    def stage_next():
        """Next staged batch, its copy started on the side stream (or the
        end marker)."""
        item = q.get()
        if isinstance(item, tuple) and item[0] is _END:
            return item
        if not cuda:
            return item, None
        with torch.cuda.stream(side):
            dev = item.to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return dev, ready

    def gen():
        try:
            nxt = stage_next()
            while True:
                if nxt[0] is _END:
                    if nxt[1] is not None:
                        raise nxt[1]
                    return
                batch, ready = nxt
                nxt = stage_next()  # the next copy overlaps the consumer's step
                if ready is not None:
                    torch.cuda.current_stream(device).wait_event(ready)
                    batch.record_stream(torch.cuda.current_stream(device))
                yield batch
        finally:
            # Unblock the worker; a worker stuck inside `data` itself is a
            # daemon thread that cannot enqueue again once stop is set.
            stop.set()
            for _ in range(20):  # x 0.1 s
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.1)
                if not thread.is_alive():
                    break
            for rec in spans.records(extra={"source": "prefetch_to_device"}):
                write_or_observe(metrics_writer, rec)

    return gen()
