"""Double-buffered host→device feed for the streaming scorer: the port's
copy of ``repro/serve/feed.py``.

The feed stays ONE batch ahead of the consumer: when batch N is yielded,
batch N+1's upload has already been issued.  On a CUDA device each host
batch is copied into a pinned tensor of its own and uploaded with
``non_blocking=True`` on a side copy stream; an event recorded after the
copy is what the consumer's stream waits on before it reads the batch, so
the host never blocks on an upload.  A pinned buffer is never refilled: one
is taken per batch from PyTorch's caching host allocator, which reuses it
only after the copy that read it has completed.  On the CPU the batches
pass through as tensors that share the host arrays' memory.

The consumer side lives in ``engine.ServeEngine``: it dispatches the
scorer on batch N and only then blocks on batch N−1's result.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def device_feed(batches: Iterable[Tuple[np.ndarray, int]],
                device: DeviceLike = None,
                ) -> Iterator[Tuple[torch.Tensor, int]]:
    """(host_batch, n_valid) stream → (device_batch, n_valid) stream with
    one batch of upload prefetch.  ``device`` is ``cuda`` unless ``"cpu"``
    is asked.  A yielded CUDA batch is safe to read on the stream that is
    current when it is yielded."""
    device = resolve_device(device)
    if device.type == "cpu":
        for x, n in batches:
            yield torch.from_numpy(np.ascontiguousarray(x)), n
        return

    copy_stream = torch.cuda.Stream(device)

    def upload(x):
        pinned = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
        with torch.cuda.stream(copy_stream):
            xd = pinned.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return xd, done

    def ready(entry):
        (xd, done), n = entry
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        xd.record_stream(stream)  # allocated on the copy stream
        return xd, n

    it = iter(batches)
    try:
        x, n = next(it)
    except StopIteration:
        return
    cur = (upload(x), n)
    for x, n in it:
        nxt = (upload(x), n)   # issued before batch N is handed over
        yield ready(cur)
        cur = nxt
    yield ready(cur)
