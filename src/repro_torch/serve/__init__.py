"""Streaming anomaly-scoring engine: the port's copy of ``repro/serve``.

Layout::

    batching.py   static batch buckets: plan/pad/accumulate
    feed.py       double-buffered host→device upload (pinned memory, a
                  copy stream and events)
    engine.py     ServeEngine + self-describing checkpoints
    cli.py        python -m repro_torch.serve — train-if-missing, then serve

Quick start::

    from repro_torch.serve import ServeEngine, save_serving_checkpoint
    save_serving_checkpoint("ckpt/serve_attn", params, "attn", meta)
    eng = ServeEngine.from_checkpoint("ckpt/serve_attn")   # on cuda
    scores = eng.score(windows)              # [n] anomaly probabilities
"""
from repro_torch.serve.batching import (DEFAULT_BUCKETS, Bucketer,
                                        batches_of, bucket_for, pad_to,
                                        plan_chunks)
from repro_torch.serve.engine import (SERVE_STATS, ServeEngine, StreamReport,
                                      save_serving_checkpoint)
from repro_torch.serve.feed import device_feed

__all__ = [
    "DEFAULT_BUCKETS", "Bucketer", "batches_of", "bucket_for", "pad_to",
    "plan_chunks", "SERVE_STATS", "ServeEngine", "StreamReport",
    "save_serving_checkpoint", "device_feed",
]
