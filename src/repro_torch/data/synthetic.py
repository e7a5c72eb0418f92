"""Synthetic stand-ins for the paper's datasets (generated, no download).

* ``unsw_nb15_like`` — mirrors the UNSW-NB15 schema: 42 numeric flow
  features (durations, byte/packet counts, rates, TTLs, window sizes, ...)
  drawn from per-class lognormal/gamma/normal mixtures; 10 classes (normal +
  9 attack categories: fuzzers, analysis, backdoor, dos, exploits, generic,
  recon, shellcode, worms) with the published heavy class imbalance
  (~87.5% normal traffic).
* ``road_like`` — CAN-bus windows mimicking the ROAD *correlated masquerade*
  attack: per-ID correlated signal streams; an attack replays one signal's
  dynamics on another ID with a small offset — statistically stealthy, which
  is exactly the ROAD difficulty.

Non-IID federation: Dirichlet(α) label skew + per-client feature shift, as
assumed by the paper ("non-IID data distribution across clients").

The port's copy of ``repro/data/synthetic.py``.  The NumPy generators are
the same code drawing the same NumPy generator in the same order, so a seed
gives bitwise the same arrays in both packages.  The device-side federation
(``StackedFederation``, ``stack_federation``, ``sample_round_batches``)
feeds the sweep engine; the population federation (``Population``,
``make_population``, ``sample_cohort_batches``) feeds the population
engine.  The one part the port cannot copy is the population's per-client
covariate shift, which the reference draws from ``fold_in(shift_key,
client_id)``: the port's is a stateless counter-based draw
(:func:`cohort_shift`).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs.trace import phase

UNSW_N_FEATURES = 42
UNSW_N_CLASSES = 10
UNSW_CLASS_PRIORS = np.array(
    [0.875, 0.024, 0.003, 0.002, 0.016, 0.044, 0.021, 0.010, 0.004, 0.001]
)
UNSW_CLASS_PRIORS = UNSW_CLASS_PRIORS / UNSW_CLASS_PRIORS.sum()


def unsw_nb15_like(rng: np.random.Generator, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (X [n,42] float32 standardised, y_cat [n], y_bin [n])."""
    y = rng.choice(UNSW_N_CLASSES, size=n, p=UNSW_CLASS_PRIORS)
    X = np.empty((n, UNSW_N_FEATURES), np.float64)

    # class-conditional generative structure: each class shifts a subset of
    # features (e.g. DoS inflates packet rates; recon touches many ports)
    base_mu = rng.normal(0.0, 1.0, (UNSW_N_CLASSES, UNSW_N_FEATURES)) * 0.0
    cls_shift = rng.normal(0.0, 1.2, (UNSW_N_CLASSES, UNSW_N_FEATURES))
    cls_mask = rng.random((UNSW_N_CLASSES, UNSW_N_FEATURES)) < 0.25
    cls_shift = cls_shift * cls_mask
    cls_shift[0] = 0.0  # normal traffic is the reference

    # heavy-tailed "volume" features (bytes, packets, duration): lognormal
    heavy = np.zeros(UNSW_N_FEATURES, bool)
    heavy[:12] = True
    # rate-like features: gamma
    ratef = np.zeros(UNSW_N_FEATURES, bool)
    ratef[12:22] = True

    mu = base_mu[y] + cls_shift[y]
    z = rng.normal(0.0, 1.0, (n, UNSW_N_FEATURES))
    X = mu + z
    X[:, heavy] = np.exp(0.8 * X[:, heavy])  # lognormal tails
    X[:, ratef] = np.square(X[:, ratef])  # chi2-ish rates

    # correlated flow structure (shared latent per sample)
    latent = rng.normal(0.0, 1.0, (n, 4))
    mix = rng.normal(0.0, 0.4, (4, UNSW_N_FEATURES))
    X = X + latent @ mix

    # standardise
    X = (X - X.mean(0)) / (X.std(0) + 1e-9)
    return X.astype(np.float32), y.astype(np.int32), (y > 0).astype(np.int32)


def _corr_lastaxis(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pearson correlation along the last axis (batched ``np.corrcoef``);
    0 where either side is (near-)constant."""
    ac = a - a.mean(-1, keepdims=True)
    bc = b - b.mean(-1, keepdims=True)
    sa = np.sqrt((ac * ac).mean(-1))
    sb = np.sqrt((bc * bc).mean(-1))
    denom = sa * sb
    safe = denom > 1e-18
    num = (ac * bc).mean(-1)
    return np.where(safe, num / np.where(safe, denom, 1.0), 0.0)


def _roll_lastaxis(x: np.ndarray, shift: np.ndarray) -> np.ndarray:
    """``np.roll`` along the last axis with a per-row shift (gather)."""
    window = x.shape[-1]
    idx = (np.arange(window)[None, :] - shift[:, None]) % window
    return np.take_along_axis(x, idx, axis=-1)


def road_like(
    rng: np.random.Generator,
    n: int,
    window: int = 64,
    n_signals: int = 6,
    attack_rate: float = 0.25,
    offset: float = 0.35,
    raw: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Correlated-masquerade CAN windows.

    Normal windows: n_signals AR(1) streams with a shared low-frequency
    driver (vehicle state).  Attack: one signal is replaced by a *replay* of
    another signal's dynamics plus a small constant offset — the masquerade.
    Features: per-signal (mean, std, mean |Δ|, lag-1 autocorr, corr to
    signal 0) -> 5·n_signals features.
    Returns (X, y, y) — binary labels only (matches our ROAD use).

    ``raw=True`` skips the hand-engineered statistics and returns the
    standardised window matrix itself, flattened time-major to
    ``[n, window·n_signals]`` (reshape with ``feature_shape = (window,
    n_signals)`` recovers ``[window, n_signals]``) — the input the
    window-native detectors in ``models/detectors.py`` consume.  The RNG
    draw order is identical to the feature path, so raw and feature
    datasets of one seed describe the same windows.

    Fully vectorised across windows/signals; only the AR(1) recursion
    iterates, over the ``window`` axis.
    """
    y = (rng.random(n) < attack_rate).astype(np.int32)
    t = np.arange(window)

    # shared low-frequency driver per window: sin(2π t/window · f + φ0)
    freq = rng.uniform(0.5, 2.0, n)
    phase0 = rng.uniform(0, 6.28, n)
    driver = np.sin(2 * np.pi * t[None, :] / window * freq[:, None]
                    + phase0[:, None])                       # [n, window]

    phase = rng.uniform(0, 6.28, (n, n_signals))
    gain = rng.uniform(0.5, 1.5, (n, n_signals))
    ar = rng.uniform(0.7, 0.95, (n, n_signals))
    noise = rng.normal(0, 0.15, (n, n_signals, window))

    # AR(1): x_k = ar·x_{k-1} + noise_k — sequential in k only
    x = np.zeros((n, n_signals, window))
    for k in range(1, window):
        x[:, :, k] = ar * x[:, :, k - 1] + noise[:, :, k]

    shift_d = (phase * 3).astype(np.int64).reshape(-1)
    rolled = _roll_lastaxis(
        np.repeat(driver, n_signals, axis=0), shift_d
    ).reshape(n, n_signals, window)
    sig = gain[..., None] * rolled + x

    # masquerade: victim signal <- replayed source + offset, attack rows only
    atk = np.flatnonzero(y)
    if atk.size:
        victim = rng.integers(0, n_signals, atk.size)
        # uniform ordered pair without replacement: src = victim + U[1, S)
        src = (victim + rng.integers(1, n_signals, atk.size)) % n_signals
        shift = rng.integers(1, window // 4, atk.size)
        sig[atk, victim] = _roll_lastaxis(sig[atk, src], shift) + offset

    if raw:
        feats = sig.transpose(0, 2, 1).reshape(n, -1)  # time-major flatten
        feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-9)
        return feats.astype(np.float32), y, y

    # per-signal features: mean, std, mean |Δ|, lag-1 autocorr, corr to sig 0
    mean = sig.mean(-1)
    std = sig.std(-1)
    dxm = np.abs(np.diff(sig, axis=-1)).mean(-1)
    live = std > 1e-9
    acorr = np.where(live, _corr_lastaxis(sig[..., :-1], sig[..., 1:]), 0.0)
    c0 = np.where(live, _corr_lastaxis(sig, sig[:, :1]), 0.0)
    c0[:, 0] = 1.0
    feats = np.stack([mean, std, dxm, acorr, c0], axis=-1).reshape(n, -1)
    feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-9)
    return feats.astype(np.float32), y, y


@dataclass
class FederatedData:
    """Per-client tabular data + metadata used by utility scores.

    ``feature_shape`` is the structured shape of one example (product ==
    ``n_features``): ``None``/``(n_features,)`` for tabular features,
    ``(window, n_signals)`` for raw CAN windows — window-native model
    specs (``models/spec.py``) unflatten with it while the whole data path
    keeps moving flat ``[*, n_features]`` arrays.
    """

    x: List[np.ndarray]
    y: List[np.ndarray]
    test_x: np.ndarray
    test_y: np.ndarray
    n_features: int
    n_classes: int
    feature_shape: Optional[Tuple[int, ...]] = None

    @property
    def n_clients(self) -> int:
        return len(self.x)

    def data_sizes(self) -> np.ndarray:
        return np.array([len(xi) for xi in self.x], np.float32)

    def label_entropy(self) -> np.ndarray:
        """Per-client normalised label entropy — the data-quality proxy."""
        out = []
        for yi in self.y:
            p = np.bincount(yi, minlength=self.n_classes).astype(np.float64)
            p = p / max(p.sum(), 1)
            h = -(p[p > 0] * np.log(p[p > 0])).sum()
            out.append(h / np.log(self.n_classes))
        return np.asarray(out, np.float32)


def dirichlet_partition(rng: np.random.Generator, labels: np.ndarray, n_clients: int,
                        alpha: float, min_per_client: int = 8) -> List[np.ndarray]:
    """Label-skewed non-IID split (standard Dirichlet protocol)."""
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for c, idx in enumerate(idx_by_class):
        if len(idx) == 0:
            continue
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for ci, part in enumerate(np.split(idx, cuts)):
            client_idx[ci].extend(part.tolist())
    # guarantee a minimum shard per client
    pool = [i for cl in client_idx for i in cl]
    for ci in range(n_clients):
        while len(client_idx[ci]) < min_per_client:
            client_idx[ci].append(int(rng.choice(pool)))
    return [np.asarray(sorted(c), np.int64) for c in client_idx]


def make_federated(
    seed: int,
    dataset: str = "unsw",
    n_samples: int = 20_000,
    n_clients: int = 40,
    alpha: float = 0.5,
    test_frac: float = 0.25,
    feature_shift: float = 0.15,
    label_noise_frac: float = 0.0,
    label_noise_rate: float = 0.4,
) -> FederatedData:
    """``label_noise_frac`` of the clients get ``label_noise_rate`` of their
    labels flipped — the low-data-quality clients whose exclusion is exactly
    what the paper's utility-based selection is for (random selection keeps
    sampling them; loss-seeking ACFL actively PREFERS them).

    ``dataset="road_raw"`` is the ROAD federation over *raw* window
    matrices (``road_like(raw=True)``): x stays flat for the data path,
    ``feature_shape=(window, n_signals)`` tells window-native models how to
    unflatten."""
    rng = np.random.default_rng(seed)
    feature_shape = None
    if dataset == "unsw":
        X, y_cat, y_bin = unsw_nb15_like(rng, n_samples)
        y = y_bin  # anomaly detection = binary task (paper metric: AUC-ROC)
    elif dataset == "road":
        X, y, _ = road_like(rng, n_samples)
    elif dataset == "road_raw":
        window, n_signals = 64, 6
        X, y, _ = road_like(rng, n_samples, window=window,
                            n_signals=n_signals, raw=True)
        feature_shape = (window, n_signals)
    else:
        raise ValueError(dataset)
    n_test = int(len(X) * test_frac)
    perm = rng.permutation(len(X))
    test_i, train_i = perm[:n_test], perm[n_test:]
    parts = dirichlet_partition(rng, y[train_i], n_clients, alpha)
    noisy_clients = set(
        rng.choice(n_clients, int(round(label_noise_frac * n_clients)),
                   replace=False).tolist()
    )
    xs, ys = [], []
    for ci, pi in enumerate(parts):
        gi = train_i[pi]
        shift = rng.normal(0, feature_shift, X.shape[1]).astype(np.float32)
        xs.append(X[gi] + shift)  # per-client covariate shift
        yi = y[gi].copy()
        if ci in noisy_clients:
            flip = rng.random(len(yi)) < label_noise_rate
            yi[flip] = 1 - yi[flip]  # binary labels
        ys.append(yi)
    return FederatedData(
        x=xs, y=ys, test_x=X[test_i], test_y=y[test_i],
        n_features=X.shape[1], n_classes=2, feature_shape=feature_shape,
    )


def round_batches(rng: np.random.Generator, fed: FederatedData, local_steps: int,
                  batch: int) -> Dict[str, np.ndarray]:
    """Sample per-round batches: leaves [n_clients, local_steps, batch, ...]."""
    n = fed.n_clients
    xs = np.empty((n, local_steps, batch, fed.n_features), np.float32)
    ys = np.empty((n, local_steps, batch), np.int32)
    for ci in range(n):
        idx = rng.integers(0, len(fed.x[ci]), (local_steps, batch))
        xs[ci] = fed.x[ci][idx]
        ys[ci] = fed.y[ci][idx]
    return {"x": xs, "y": ys}


# ---------------------------------------------------------------------------
# Device-side federation (for the sweep engine in train/fl_driver.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StackedFederation:
    """Ragged per-client shards padded to ``[n_clients, max_n, ...]`` on the
    device.  ``sizes`` masks the padding: batch indices are drawn in
    ``[0, sizes[i])``, so the pad rows are never read.  Labels are int64,
    torch's index type."""

    x: torch.Tensor        # [n_clients, max_n, d] f32
    y: torch.Tensor        # [n_clients, max_n] int64
    sizes: torch.Tensor    # [n_clients] int64 valid rows per client
    test_x: torch.Tensor   # [n_test, d] f32
    test_y: torch.Tensor   # [n_test] int64

    @property
    def n_clients(self) -> int:
        return self.x.shape[0]

    def shapes(self) -> Tuple:
        """Shape fingerprint (the sweep engine's runner cache key)."""
        return tuple((tuple(t.shape), str(t.dtype)) for t in
                     (self.x, self.y, self.sizes, self.test_x, self.test_y))


def stack_federation(fed: FederatedData, device=None) -> StackedFederation:
    """Pad the ragged client shards into one array set on ``device``."""
    max_n = max(len(xi) for xi in fed.x)
    xs = np.zeros((fed.n_clients, max_n, fed.n_features), np.float32)
    ys = np.zeros((fed.n_clients, max_n), np.int64)
    for ci, (xi, yi) in enumerate(zip(fed.x, fed.y)):
        xs[ci, : len(xi)] = xi
        ys[ci, : len(yi)] = yi
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return StackedFederation(
        x=t(xs), y=t(ys), sizes=t(fed.data_sizes().astype(np.int64)),
        test_x=t(fed.test_x), test_y=t(fed.test_y.astype(np.int64)))


def draw_batch_indices(gens: Sequence[torch.Generator], sizes: torch.Tensor,
                       local_steps: int, batch: int,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One round's batch rows for every lane: lane ``l`` draws uniforms
    ``u [n_clients, local_steps, batch]`` from ``gens[l]`` (into ``out[l]``
    when a ``[L, n, local_steps, batch]`` buffer is given), and client i's
    rows are ``floor(u·sizes[i])``, clamped to ``sizes[i] − 1``: uniform
    with replacement over its valid rows.  Returns ``[L, n, local_steps,
    batch]`` int64."""
    n = sizes.shape[0]
    if out is None:
        out = torch.empty(len(gens), n, local_steps, batch,
                          device=sizes.device)
    for lane, gen in zip(out, gens):
        lane.uniform_(generator=gen)
    size = sizes.reshape(n, 1, 1)
    return torch.minimum(torch.floor(out * size).long(), size - 1)


def sample_round_batches(stack: StackedFederation,
                         idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The rows ``idx [..., n_clients, local_steps, batch]`` of each client's
    shard, in one gather: leaves ``[..., n_clients, local_steps, batch,
    ...]``, as :func:`round_batches` lays them out."""
    n, max_n = stack.y.shape
    client = torch.arange(n, device=idx.device).reshape(n, 1, 1) * max_n
    rows = (idx + client).reshape(-1)
    x = stack.x.reshape(n * max_n, -1).index_select(0, rows)
    y = stack.y.reshape(-1).index_select(0, rows)
    return {"x": x.reshape(*idx.shape, -1), "y": y.reshape(idx.shape)}


# ---------------------------------------------------------------------------
# Population-scale federation: lazy client shards over a shared sample pool,
# consumed by the population engine in train/fl_driver.py
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Population:
    """A 10^5–10^6-client federation without materialised shards.

    * ``pool_x/pool_y`` — one shared sample pool (O(pool), not O(N));
    * ``member_idx [N, m] i32`` — each client's shard as rows into the pool;
    * ``member_size [N] i32`` — valid prefix per client;
    * ``data_size``/``data_quality [N] f32`` — the utility state's inputs;
    * the per-client covariate shift is drawn at batch-sampling time from
      ``(shift_seed, client_id, feature)`` (:func:`cohort_shift`), so it
      holds no ``[N, d]`` memory.

    The arrays are NumPy on the host (:func:`make_population`) or tensors
    on a device (:meth:`to`: labels become int64, torch's index type;
    ``member_idx`` stays int32).  ``shapes()`` is the runner-cache
    fingerprint.  Memory accounting lives in ``core/scale.py``."""

    pool_x: Any          # [pool, d] f32 shared sample pool (train)
    pool_y: Any          # [pool] i32
    member_idx: Any      # [n_clients, m] i32 rows into the pool
    member_size: Any     # [n_clients] i32 valid members (<= m)
    data_size: Any       # [n_clients] f32 normalised shard size
    data_quality: Any    # [n_clients] f32 label-entropy proxy
    shift_seed: int      # (seed ^ 0x5CA1E) & 0xFFFFFFFF
    test_x: Any          # [n_test, d] f32
    test_y: Any          # [n_test] i32
    feature_shift: float = 0.15
    feature_shape: Optional[Tuple[int, ...]] = None

    _ARRAYS = ("pool_x", "pool_y", "member_idx", "member_size", "data_size",
               "data_quality", "test_x", "test_y")

    @property
    def n_clients(self) -> int:
        return self.member_idx.shape[0]

    @property
    def n_features(self) -> int:
        return self.pool_x.shape[1]

    @property
    def n_classes(self) -> int:
        return 2

    @property
    def members_per_client(self) -> int:
        return self.member_idx.shape[1]

    def shapes(self) -> Tuple:
        """Shape fingerprint (the population engine's runner cache key)."""
        return (tuple((tuple(getattr(self, k).shape),
                       str(getattr(self, k).dtype)) for k in self._ARRAYS),
                self.feature_shift, self.feature_shape)

    def to(self, device) -> "Population":
        """The population's arrays on ``device``, in one copy each."""
        def put(name):
            a = torch.as_tensor(getattr(self, name), device=device)
            return a.long() if name in ("pool_y", "test_y") else a
        return dataclasses.replace(self, **{k: put(k) for k in self._ARRAYS})


def make_population(
    seed: int,
    dataset: str = "unsw",
    n_clients: int = 100_000,
    pool_samples: int = 8_000,
    members_per_client: int = 32,
    alpha: float = 0.5,
    test_frac: float = 0.25,
    feature_shift: float = 0.15,
    chunk_clients: int = 16_384,
) -> Population:
    """Generate a :class:`Population` lazily: the client axis is built in
    ``chunk_clients``-sized NumPy chunks, so peak host memory is
    O(chunk × m), never O(N × samples).

    Non-IID structure matches :func:`make_federated` in kind: per-client
    Beta(α, α) label propensity decides each client's attack share,
    membership rows are drawn from the matching class buckets of the pool,
    and the per-client covariate shift is deferred to batch sampling
    (:func:`sample_cohort_batches`)."""
    rng = np.random.default_rng(seed)
    feature_shape = None
    if dataset == "unsw":
        X, _, y = unsw_nb15_like(rng, pool_samples)
    elif dataset == "road":
        X, y, _ = road_like(rng, pool_samples)
    elif dataset == "road_raw":
        window, n_signals = 64, 6
        X, y, _ = road_like(rng, pool_samples, window=window,
                            n_signals=n_signals, raw=True)
        feature_shape = (window, n_signals)
    else:
        raise ValueError(dataset)
    n_test = int(len(X) * test_frac)
    perm = rng.permutation(len(X))
    test_i, train_i = perm[:n_test], perm[n_test:]
    Xtr, ytr = X[train_i], y[train_i]

    buckets = [np.flatnonzero(ytr == c) for c in (0, 1)]
    if any(len(b) == 0 for b in buckets):
        raise ValueError("pool has an empty class — enlarge pool_samples")

    m = int(members_per_client)
    member_size = rng.integers(max(m // 2, 1), m + 1,
                               n_clients).astype(np.int32)
    member_idx = np.empty((n_clients, m), np.int32)
    quality = np.empty((n_clients,), np.float32)
    for lo in range(0, n_clients, chunk_clients):
        hi = min(lo + chunk_clients, n_clients)
        c = hi - lo
        p1 = rng.beta(alpha, alpha, c)                    # binary Dirichlet
        n1 = rng.binomial(m, p1)
        cols = np.arange(m)[None, :]
        is1 = cols < n1[:, None]                          # [c, m] class plan
        rows = np.where(
            is1,
            buckets[1][rng.integers(0, len(buckets[1]), (c, m))],
            buckets[0][rng.integers(0, len(buckets[0]), (c, m))],
        )
        # shuffle within each row so the member_size prefix stays a fair
        # mix of the client's classes
        order = rng.random((c, m)).argsort(axis=1)
        rows = np.take_along_axis(rows, order, axis=1)
        member_idx[lo:hi] = rows
        lab = ytr[rows]                                   # [c, m]
        valid = cols < member_size[lo:hi][:, None]
        p = (lab * valid).sum(1) / np.maximum(member_size[lo:hi], 1)
        p = np.clip(p, 1e-9, 1 - 1e-9)
        quality[lo:hi] = -(p * np.log(p) + (1 - p) * np.log(1 - p)) / np.log(2)

    sizes = member_size.astype(np.float32)
    return Population(
        pool_x=Xtr,
        pool_y=ytr.astype(np.int32),
        member_idx=member_idx,
        member_size=member_size,
        data_size=sizes / sizes.mean(),
        data_quality=quality,
        shift_seed=(int(seed) ^ 0x5CA1E) & 0xFFFFFFFF,
        test_x=X[test_i],
        test_y=y[test_i].astype(np.int32),
        feature_shift=float(feature_shift),
        feature_shape=feature_shape,
    )


_MASK32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x·c mod 2^32`` for ``x`` in [0, 2^32) (an int64 tensor or a Python
    int) and a 32-bit constant, in two 16-bit halves of ``c`` so that no
    product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash32(x):
    """A 32-bit integer finaliser (xor-shift-multiply, constants of
    Wellons' ``lowbias32``) on values in [0, 2^32): int64 tensors or Python
    ints, with the same result."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def cohort_shift(shift_seed: int, client_idx: torch.Tensor, d: int,
                 scale: float) -> torch.Tensor:
    """The covariate shift of the clients ``client_idx [...]``:
    ``scale · z [..., d]`` with ``z`` standard normal, a pure function of
    ``(shift_seed, client_id, feature)``.  A counter-based draw: two 24-bit
    uniforms a (client, feature) from a hash of the three integers, then
    Box–Muller.  The same client gets the same shift in every round and
    every lane, and nothing of size ``[N, d]`` is ever held."""
    dev = client_idx.device
    key = _hash32(int(shift_seed) & _MASK32)   # on the host: no copy
    client = _hash32((client_idx.long() & _MASK32) ^ key)[..., None]
    feature = torch.arange(d, device=dev) * 2

    def uniform(counter):      # (0, 1], 24 bits
        h = _hash32(client ^ counter)
        return ((h >> 8) + 1).float() * (1.0 / (1 << 24))

    u1, u2 = uniform(feature), uniform(feature + 1)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return scale * z


def _index_rows(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return t.index_select(0, ids)


def sample_cohort_batches(pop: Population, cohort_idx: torch.Tensor,
                          local_steps: int, batch: int,
                          u: Optional[torch.Tensor] = None,
                          batch_idx: Optional[torch.Tensor] = None,
                          shift: Optional[torch.Tensor] = None,
                          member_rows=None) -> Dict[str, torch.Tensor]:
    """The cohort gather: batches of the selected clients only, leaves
    ``[L, k_max, local_steps, batch, ...]``, whatever the population's size.

    Cohort slot ``(l, s)`` is client ``cohort_idx[l, s]``; its sample rows
    are ``floor(u · size)`` (``u [L, k_max, local_steps, batch]`` uniforms
    from the lane's generator, ``size`` its valid members, clamped to
    ``size − 1``) into its membership row, and its covariate shift is
    :func:`cohort_shift`'s.  ``batch_idx`` (member positions) and ``shift``
    (``[L, k_max, d]``) override the drawn ones, as the parity tests feed
    the reference's.  ``member_rows(t, ids)`` reads the membership rows
    and sizes of clients ``ids`` (``index_select`` by default; the
    population engine's client shards read them from their owners)."""
    if member_rows is None:
        member_rows = _index_rows
    with phase("sample_cohort_batches"):
        lanes, k = cohort_idx.shape
        mem = member_rows(pop.member_idx, cohort_idx.reshape(-1))
        if batch_idx is None:
            size = torch.clamp(member_rows(
                pop.member_size, cohort_idx.reshape(-1)).long(), min=1)
            size = size.reshape(lanes, k, 1, 1)
            batch_idx = torch.minimum(torch.floor(u * size).long(), size - 1)
        rows = torch.gather(mem.long(), 1,
                            batch_idx.reshape(lanes * k, -1)).reshape(-1)
        d = pop.pool_x.shape[1]
        if shift is None:
            shift = cohort_shift(pop.shift_seed, cohort_idx, d,
                                 pop.feature_shift)
        x = pop.pool_x.index_select(0, rows).reshape(
            lanes, k, local_steps, batch, d) + shift[:, :, None, None]
        y = pop.pool_y.index_select(0, rows).reshape(lanes, k, local_steps,
                                                     batch)
        return {"x": x, "y": y}
