"""Streaming anomaly-scoring engine: the port's copy of
``repro/serve/engine.py``.

Load a federated checkpoint, resolve the registered
:class:`~repro_torch.models.spec.ModelSpec`, and score a continuous stream
of CAN/NetFlow windows:

* **padded bucket batching** (``serve/batching.py``) — windows are cut into
  a few static batch shapes; ``_get_scorer`` keeps one scorer per (model,
  DataMeta, bucket, route) and ``SERVE_STATS`` (a ``repro_torch.obs``
  registry view) counts misses and hits; a miss is a
  ``compile.scorer_miss`` event, and the stream and each dispatch are
  ``serve.score_stream`` / ``serve.dispatch`` spans.
* **double-buffered host→device feed** (``serve/feed.py``) — batch N+1's
  upload is issued before batch N is dispatched, and the engine blocks on
  batch N−1 only after dispatching N.  Each batch's scores come back by a
  non-blocking copy into pinned memory and an event, so waiting for N−1
  never waits for N.  (The reference donates the input buffer; PyTorch has
  no counterpart, and the feed allocates one per batch anyway.)
* **kernel routes** — the sequence detectors' ``"kernel"`` route (the
  default on every device) runs the CUDA kernels for CUDA tensors and
  their plain versions for CPU tensors; ``"ref"`` runs the plain versions.

On a route, the served scores are bitwise equal to the same scorer applied
to the same padded bucket batches: batching and feeding change no bits.
Against one unpadded ``predict_proba_routed`` call they agree to 1e-6 (a
GEMM may take another algorithm for another row count).

Per-client personalization: an optional stacked tree of personalised
parameters (leading client axis) rides the same checkpoint; ``client=i``
scores with client i's slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import DEFAULT_ROUTE
from repro_torch.models.spec import DataMeta, ModelSpec, get_model_spec
from repro_torch.obs import stats as obs_stats
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import batching, feed
from repro_torch.tree import tree_leaves, tree_map

# One scorer per (model name, DataMeta, bucket, route); registry builders
# are deterministic in the DataMeta, so engines serving the same
# architecture share one.
_SCORER_CACHE: Dict = {}
SERVE_STATS = obs_stats.STATS.counters("serve", misses=0, hits=0)


def _get_scorer(spec: ModelSpec, meta: DataMeta, bucket: int,
                route: str) -> Callable:
    """``scorer(params, x[bucket, d]) -> scores[bucket]``, the class-1
    anomaly probability, computed without autograd."""
    cache_key = (spec.name, meta, int(bucket), route)
    scorer = _SCORER_CACHE.get(cache_key)
    if scorer is None:
        SERVE_STATS["misses"] += 1
        obs_trace.event("compile.scorer_miss", model=spec.name,
                        bucket=int(bucket), route=route,
                        cache_size=len(_SCORER_CACHE))
        logits_fn = spec.logits_routed(route)

        def scorer(params, x):
            with torch.no_grad():
                return torch.softmax(logits_fn(params, x), dim=-1)[:, 1]

        _SCORER_CACHE[cache_key] = scorer
    else:
        SERVE_STATS["hits"] += 1
    return scorer


@dataclass
class StreamReport:
    """Scores plus the serving metrics (windows/s, p50/p99 per-window
    latency).  A window's latency is its batch's wall: every window in a
    batch completes when the batch does."""

    scores: np.ndarray
    n_windows: int
    n_batches: int
    wall_s: float
    batch_walls_s: List[float] = field(default_factory=list)
    batch_sizes: List[int] = field(default_factory=list)

    @property
    def windows_per_sec(self) -> float:
        return self.n_windows / self.wall_s if self.wall_s else float("inf")

    def latency_percentile(self, q: float) -> float:
        """Per-window latency percentile: batch walls weighted by the
        number of valid windows each batch carried."""
        per_window = np.repeat(np.asarray(self.batch_walls_s),
                               np.asarray(self.batch_sizes))
        return float(np.percentile(per_window, q))

    @property
    def p50_s(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p99_s(self) -> float:
        return self.latency_percentile(99.0)


class ServeEngine:
    """Streaming scorer for one trained detector (+ optional personalised
    per-client parameters) on ``device`` (``cuda`` unless ``"cpu"`` is
    asked; without a card it raises).

    ``buckets`` are the static batch shapes (``serve/batching.py``);
    ``route`` picks the score-path kernels of the sequence detectors
    (``None`` is ``"kernel"``)."""

    def __init__(self, spec: ModelSpec, meta: DataMeta, params, *,
                 buckets: Sequence[int] = batching.DEFAULT_BUCKETS,
                 route: Optional[str] = None, heads=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.spec = spec
        self.meta = meta
        to_dev = lambda t: torch.as_tensor(t, device=self.device)  # noqa: E731
        self.params = tree_map(to_dev, params)
        self.buckets = batching.normalize_buckets(buckets)
        self.route = route or DEFAULT_ROUTE
        # heads: tensors, or the host NumPy stack export_personalized gives
        self.heads = None if heads is None else tree_map(to_dev, heads)
        # resolve eagerly so an invalid route fails at construction
        spec.logits_routed(self.route)

    # -- parameters -------------------------------------------------------

    def params_for(self, client: Optional[int]):
        """Global params, or client ``i``'s personalised tree (a slice of
        the stacked heads along their leading axis)."""
        if client is None:
            return self.params
        if self.heads is None:
            raise ValueError(
                "engine has no personalized heads; pass heads=... "
                "(or save_serving_checkpoint(..., heads=...))")
        return tree_map(lambda h: h[int(client)], self.heads)

    @property
    def n_personalized(self) -> int:
        if self.heads is None:
            return 0
        return int(tree_leaves(self.heads)[0].shape[0])

    # -- scoring ----------------------------------------------------------

    def warmup(self):
        """Run every bucket's scorer once outside the serving path (on the
        card this builds and loads the kernels)."""
        d = int(np.prod(self.meta.feature_shape))
        for b in self.buckets:
            scorer = _get_scorer(self.spec, self.meta, b, self.route)
            scorer(self.params, torch.zeros(b, d, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def score(self, windows: np.ndarray,
              client: Optional[int] = None) -> np.ndarray:
        """Score an [n, d] array of flat windows in bucket-shaped batches;
        returns [n] anomaly scores in input order (padding rows dropped)."""
        return self.score_stream([np.asarray(windows)], client=client).scores

    def _to_host(self, res: torch.Tensor):
        """Start the copy of one batch's scores to the host; returns
        (host tensor, event to wait on or None)."""
        if self.device.type == "cpu":
            return res, None
        host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
        host.copy_(res, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def score_stream(self, stream: Iterable[np.ndarray],
                     client: Optional[int] = None) -> StreamReport:
        """Drain a stream of [m, d] window chunks through the pipelined
        scorer (bucket batching → double-buffered feed → dispatch-ahead
        scoring) and collect scores + timing."""
        params = self.params_for(client)
        batches = batching.batches_of(stream, self.buckets)
        with obs_trace.span("serve.score_stream", model=self.spec.name,
                            route=self.route):
            t0 = time.perf_counter()
            t_prev = t0
            pending = None
            scores: List[np.ndarray] = []
            walls: List[float] = []
            sizes: List[int] = []

            def _drain(entry, t_prev):
                host, done, n_valid = entry
                if done is not None:
                    done.synchronize()
                t_now = time.perf_counter()
                scores.append(host.numpy()[:n_valid].copy())
                walls.append(t_now - t_prev)
                sizes.append(n_valid)
                return t_now

            for xb, n_valid in feed.device_feed(batches, self.device):
                with obs_trace.span("serve.dispatch",
                                    bucket=int(xb.shape[0])):
                    scorer = _get_scorer(self.spec, self.meta, xb.shape[0],
                                         self.route)
                    res = scorer(params, xb)    # dispatch of batch N
                    entry = (*self._to_host(res), n_valid)
                if pending is not None:
                    t_prev = _drain(pending, t_prev)   # block on N-1 only
                pending = entry
            if pending is not None:
                _drain(pending, t_prev)
            wall = time.perf_counter() - t0
        out = (np.concatenate(scores) if scores
               else np.zeros((0,), np.float32))
        return StreamReport(scores=out, n_windows=int(out.shape[0]),
                            n_batches=len(walls), wall_s=wall,
                            batch_walls_s=walls, batch_sizes=sizes)

    def score_naive(self, windows: np.ndarray,
                    client: Optional[int] = None) -> StreamReport:
        """The baseline the engine exists to beat: one synchronous batch-1
        scorer call per window (no batching, no feed overlap)."""
        params = self.params_for(client)
        scorer = _get_scorer(self.spec, self.meta, 1, self.route)
        windows = np.asarray(windows)
        t0 = time.perf_counter()
        t_prev = t0
        scores, walls = [], []
        for i in range(windows.shape[0]):
            x = torch.as_tensor(windows[i:i + 1], device=self.device)
            scores.append(scorer(params, x).cpu().numpy())
            t_now = time.perf_counter()
            walls.append(t_now - t_prev)
            t_prev = t_now
        wall = time.perf_counter() - t0
        out = (np.concatenate(scores) if scores
               else np.zeros((0,), np.float32))
        return StreamReport(scores=out, n_windows=int(out.shape[0]),
                            n_batches=len(walls), wall_s=wall,
                            batch_walls_s=walls, batch_sizes=[1] * len(walls))

    # -- checkpoints ------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, path: str, *,
                        buckets: Sequence[int] = batching.DEFAULT_BUCKETS,
                        route: Optional[str] = None,
                        device: DeviceLike = None) -> "ServeEngine":
        """Rebuild an engine from a self-describing serving checkpoint
        (written by either package's ``save_serving_checkpoint``): the
        manifest carries the model name and DataMeta."""
        device = resolve_device(device)
        manifest = ckpt_lib.load_manifest(path)
        info = (manifest.get("metadata") or {}).get("serve")
        if not info:
            raise ValueError(
                f"{path} is not a serving checkpoint (no 'serve' metadata); "
                "write it with serve.engine.save_serving_checkpoint")
        meta = DataMeta(n_features=int(info["meta"]["n_features"]),
                        n_classes=int(info["meta"]["n_classes"]),
                        hidden=int(info["meta"]["hidden"]),
                        feature_shape=tuple(info["meta"]["feature_shape"]))
        spec = get_model_spec(info["model"], meta)
        gen = torch.Generator(device=device).manual_seed(0)
        template: Dict[str, Any] = {"params": spec.init(gen)}
        n_heads = int(info.get("n_personalized", 0))
        if n_heads:
            template["heads"] = tree_map(
                lambda x: x.new_zeros((n_heads,) + tuple(x.shape)),
                template["params"])
        tree = ckpt_lib.restore_pytree(path, template)
        return cls(spec, meta, tree["params"], buckets=buckets, route=route,
                   heads=tree.get("heads"), device=device)


def save_serving_checkpoint(path: str, params, model: str, meta: DataMeta,
                            heads=None, extra_metadata: Optional[dict] = None
                            ) -> str:
    """Write a self-describing serving checkpoint: the params tree (plus
    optional stacked personalised heads) with the model name and
    :class:`DataMeta` in the manifest, in the reference's format, so
    ``ServeEngine.from_checkpoint`` of either package needs only the
    path.  Restore is bitwise."""
    tree: Dict[str, Any] = {"params": params}
    info = {"model": model, "meta": meta._asdict(),
            "n_personalized": (0 if heads is None else
                               int(tree_leaves(heads)[0].shape[0]))}
    if heads is not None:
        tree["heads"] = heads
    return ckpt_lib.save_pytree(
        path, tree, {"serve": {**info, **(extra_metadata or {})}})
