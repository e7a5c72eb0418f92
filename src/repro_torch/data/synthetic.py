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

The port's copy of the NumPy half of ``repro/data/synthetic.py``: the same
code draws the same NumPy generator in the same order, so a seed gives
bitwise the same arrays in both packages.  The device-side samplers and the
population federation of the reference are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

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
