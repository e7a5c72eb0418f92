"""Window-native detectors on raw ROAD CAN windows: the port's copy of
``repro/models/detectors.py`` (``cnn``, ``rglru``, ``ssm``, ``attn``).

All read ``make_federated(dataset="road_raw")`` windows, flat on the wire
and unflattened through ``DataMeta.feature_shape`` to ``[window,
signals]``:

* ``cnn`` — a 1-D CNN over the window axis (signals are channels): two
  conv stages (kernel 5, the second at stride 2, ``"SAME"`` padding as
  JAX pads it) + mean/max pooling over time.  Weights stay in the
  reference's ``[k, in, out]`` layout and are permuted at use.
* ``rglru`` — the RG-LRU block (``models/rglru.py``) over an embedding of
  the signals, residual, mean+last pooling.  Its recurrence runs on
  ``kernels.ops.rglru_scan`` (``"kernel"``: the CUDA kernel on the card,
  its sequential plain version on the CPU) or on the log-depth plain scan
  of ``models/rglru.py`` (``"ref"``): the same recurrence by different
  parallel decompositions, equal to about 1e-6.
* ``ssm`` — a Mamba-2 detector (``models/ssm.py``): embed the signals, one
  ``ssd_block`` mixer, residual, mean+last+max pooling; the score path
  averages two circular time-rolls of the window.  Its inter-chunk
  recurrence runs on ``kernels.ops.rglru_scan`` (``"kernel"``) or the
  plain ``rglru_scan_ref`` (``"ref"``), bitwise equal.
* ``attn`` — one causal self-attention block over the window, then a
  learned-query read-out that is a one-token decode against the window's
  KV: ``kernels.ops.flash_attention`` + ``flash_decode`` (``"kernel"``) or
  the plain ``kernels/ref.py`` versions (``"ref"``).

The kernels have no backward, so ``loss`` always differentiates the
``"ref"`` math (single view for ``ssm``).  Params are plain f32 dicts in
the reference's layout, drawn from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import spec as spec_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import fan_in_init, normal_init
from repro_torch.models.sharding import split_meta


def _require_windowed(meta: spec_lib.DataMeta, name: str):
    if not meta.windowed:
        raise ValueError(
            f"model {name!r} is window-native: it needs a structured "
            f"feature_shape like (window, n_signals) — got "
            f"{meta.feature_shape}; build the federation with "
            "dataset='road_raw' (data/synthetic.make_federated)")


def _unflatten(x: torch.Tensor, meta: spec_lib.DataMeta) -> torch.Tensor:
    return x.reshape(tuple(x.shape[:-1]) + tuple(meta.feature_shape))


def _dense(gen: torch.Generator, a: int, b: int) -> dict:
    return {"w": fan_in_init(gen, (a, b)),
            "b": torch.zeros(b, device=gen.device)}


# ---------------------------------------------------------------------------
# 1-D CNN over CAN windows
# ---------------------------------------------------------------------------


def _same_pad(n: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of JAX's ``"SAME"``: ``ceil(n / stride)``
    outputs, the odd element of the padding after (stride 2, kernel 5 over
    64 steps: 1 before, 2 after)."""
    out = -(-n // stride)
    pad = max((out - 1) * stride + k - n, 0)
    return pad // 2, pad - pad // 2


def _conv_same(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               stride: int) -> torch.Tensor:
    """``lax.conv_general_dilated(h, w, (stride,), "SAME")`` in the
    reference's ("NWC", "WIO", "NWC") layout, + b.  h: [b, window, in];
    w: [k, in, out]."""
    x = F.pad(h.transpose(1, 2), _same_pad(h.shape[1], w.shape[0], stride))
    y = F.conv1d(x, w.permute(2, 1, 0), stride=stride)
    return y.transpose(1, 2) + b


def _build_cnn(meta: spec_lib.DataMeta) -> spec_lib.ModelSpec:
    _require_windowed(meta, "cnn")
    n_signals = meta.feature_shape[-1]
    c1 = max(8, meta.hidden // 4)
    c2 = max(16, meta.hidden // 2)
    kw = 5

    def init(gen: torch.Generator):
        conv = lambda cin, cout: {  # noqa: E731
            "w": fan_in_init(gen, (kw, cin, cout), fan_in=kw * cin),
            "b": torch.zeros(cout, device=gen.device)}
        return {"c1": conv(n_signals, c1), "c2": conv(c1, c2),
                "head": _dense(gen, 2 * c2, meta.n_classes)}

    def logits(params, x):
        h = _unflatten(x, meta)                        # [b, window, signals]
        h = torch.relu(_conv_same(h, params["c1"]["w"], params["c1"]["b"], 1))
        h = torch.relu(_conv_same(h, params["c2"]["w"], params["c2"]["b"], 2))
        pooled = torch.cat([h.mean(dim=1), h.amax(dim=1)], dim=-1)
        return pooled @ params["head"]["w"] + params["head"]["b"]

    def loss(params, batch):
        return spec_lib.cross_entropy(logits(params, batch["x"]), batch["y"])

    return spec_lib.ModelSpec(name="cnn", init=init, loss=loss, logits=logits)


# ---------------------------------------------------------------------------
# RG-LRU recurrent detector
# ---------------------------------------------------------------------------


class _RecCfg(NamedTuple):
    """The config fields ``models/rglru.py`` reads."""

    d_model: int
    lru_width: int
    conv_width: int
    dtype: str = "float32"


def _build_rglru(meta: spec_lib.DataMeta) -> spec_lib.ModelSpec:
    _require_windowed(meta, "rglru")
    n_signals = meta.feature_shape[-1]
    d = max(8, meta.hidden // 4)
    cfg = _RecCfg(d_model=d, lru_width=d, conv_width=4)

    def init(gen: torch.Generator):
        return {"embed": _dense(gen, n_signals, d),
                "rec": split_meta(rglru_lib.init_rglru(gen, cfg))[0],
                "head": _dense(gen, 2 * d, meta.n_classes)}

    def make_logits(impl: str):
        def logits(params, x):
            h = _unflatten(x, meta)                    # [b, window, signals]
            h = h @ params["embed"]["w"] + params["embed"]["b"]
            rec, _ = rglru_lib.rglru_block(params["rec"], h, cfg, impl=impl)
            h = h + rec                                # residual
            pooled = torch.cat([h.mean(dim=1), h[:, -1]], dim=-1)
            return pooled @ params["head"]["w"] + params["head"]["b"]

        return logits

    variants = {"kernel": make_logits("flash"), "ref": make_logits("ref")}
    ref_logits = variants["ref"]

    def loss(params, batch):
        return spec_lib.cross_entropy(ref_logits(params, batch["x"]),
                                      batch["y"])

    return spec_lib.ModelSpec(name="rglru", init=init, loss=loss,
                              logits=variants[kops.DEFAULT_ROUTE],
                              route_variants=variants)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) detector
# ---------------------------------------------------------------------------


class _SsmCfg(NamedTuple):
    """The config fields ``models/ssm.py`` reads."""

    d_model: int
    ssm_expand: int
    ssm_heads: int
    ssm_head_dim: int
    ssm_state: int
    ssm_chunk: int
    conv_width: int
    norm_eps: float
    dtype: str = "float32"


def _ssd_scan_fn(route: str):
    """The inter-chunk recurrence of one score route: the same sequential
    f32 scan ``s = dec·s + st``, through the kernel or the plain version."""
    if route == "kernel":
        return ssm_lib.chunk_scan_via(kops.rglru_scan)
    if route == "ref":
        return ssm_lib.chunk_scan_via(kref.rglru_scan_ref)
    raise KeyError(route)


def _build_ssm(meta: spec_lib.DataMeta) -> spec_lib.ModelSpec:
    _require_windowed(meta, "ssm")
    window, n_signals = meta.feature_shape[0], meta.feature_shape[-1]
    d = max(16, meta.hidden // 4)
    # several chunks, so the inter-chunk recurrence carries state
    chunk = next(c for c in (16, 8, 4, 2, 1) if window % c == 0)
    cfg = _SsmCfg(d_model=d, ssm_expand=2, ssm_heads=2, ssm_head_dim=d,
                  ssm_state=16, ssm_chunk=chunk, conv_width=4, norm_eps=1e-6)
    # the score path averages the logits of circular time-rolls of the
    # window (stationary signals: a rolled window is a second view)
    tta_rolls = (0, window // 2) if window >= 2 else (0,)

    def init(gen: torch.Generator):
        embed = _dense(gen, n_signals, d)
        mix = split_meta(ssm_lib.init_ssd(gen, cfg))[0]
        # small-dt init (dt ≈ 0.12): heads start with 8–60-step memory
        mix["dt_bias"] = torch.full_like(mix["dt_bias"], -2.0)
        return {"embed": embed, "mix": mix,
                "head": _dense(gen, 3 * d, meta.n_classes)}

    def make_one_view(route: str):
        scan_fn = _ssd_scan_fn(route)

        def one_view(params, hw):
            h = hw @ params["embed"]["w"] + params["embed"]["b"]
            y, _ = ssm_lib.ssd_block(params["mix"], h, cfg, scan_fn=scan_fn)
            h = h + y
            pooled = torch.cat([h.mean(dim=1), h[:, -1], h.amax(dim=1)],
                               dim=-1)
            return pooled @ params["head"]["w"] + params["head"]["b"]

        return one_view

    def make_logits(route: str):
        one_view = make_one_view(route)

        def logits(params, x):
            hw = _unflatten(x, meta)
            views = [one_view(params, torch.roll(hw, r, dims=1) if r else hw)
                     for r in tta_rolls]
            return sum(views) / len(views)

        return logits

    variants = {"kernel": make_logits("kernel"), "ref": make_logits("ref")}
    ref_one_view = make_one_view("ref")

    def loss(params, batch):
        return spec_lib.cross_entropy(
            ref_one_view(params, _unflatten(batch["x"], meta)), batch["y"])

    def param_axes():
        # the SSD block's ParamMeta axes: its wide "mlp" dims (the fused
        # in_proj, the conv channels, out_proj's rows) are what
        # RULES_MODEL_SCALE splits over the client axis
        mix = split_meta(ssm_lib.init_ssd(torch.Generator().manual_seed(0),
                                          cfg))[1]
        return {"embed": {"w": (None, "embed"), "b": ("embed",)},
                "mix": mix, "head": {"w": (None, None), "b": (None,)}}

    return spec_lib.ModelSpec(name="ssm", init=init, loss=loss,
                              logits=variants[kops.DEFAULT_ROUTE],
                              route_variants=variants,
                              param_axes=param_axes)


# ---------------------------------------------------------------------------
# Causal-attention detector (the serving engine's sequence hot path)
# ---------------------------------------------------------------------------

_ATTN_HEADS = 2


def _attn_primitives(route: str):
    """(attention, decode) of one score route."""
    if route == "kernel":
        return (lambda q, k, v: kops.flash_attention(q, k, v, causal=True),
                kops.flash_decode)
    if route == "ref":
        return (lambda q, k, v: kref.flash_attention_ref(q, k, v,
                                                         causal=True),
                kref.flash_decode_ref)
    raise KeyError(route)


def _build_attn(meta: spec_lib.DataMeta) -> spec_lib.ModelSpec:
    _require_windowed(meta, "attn")
    window, n_signals = meta.feature_shape[0], meta.feature_shape[-1]
    h = _ATTN_HEADS
    d = max(16, (meta.hidden // 4 // (2 * h)) * 2 * h)
    dh = d // h

    def init(gen: torch.Generator):
        lin = lambda a, b: fan_in_init(gen, (a, b))  # noqa: E731
        return {
            "embed": _dense(gen, n_signals, d),
            "pos": normal_init(gen, (window, d), 0.02),
            "wq": lin(d, d), "wk": lin(d, d), "wv": lin(d, d),
            "wo": lin(d, d),
            # read-out: a learned query decoding against the window's KV
            "rq": normal_init(gen, (h, dh), 0.5),
            "rkv": {"wk": lin(d, d), "wv": lin(d, d)},
            "head": _dense(gen, 2 * d, meta.n_classes),
        }

    def make_logits(route: str):
        attention, decode = _attn_primitives(route)

        def logits(params, x):
            hseq = _unflatten(x, meta)
            b = hseq.shape[0]
            hseq = hseq @ params["embed"]["w"] + params["embed"]["b"]
            hseq = hseq + params["pos"]
            q = (hseq @ params["wq"]).reshape(b, window, h, dh)
            k = (hseq @ params["wk"]).reshape(b, window, h, dh)
            v = (hseq @ params["wv"]).reshape(b, window, h, dh)
            o = attention(q, k, v).reshape(b, window, d)
            hseq = hseq + o @ params["wo"]
            k2 = (hseq @ params["rkv"]["wk"]).reshape(b, window, h, dh)
            v2 = (hseq @ params["rkv"]["wv"]).reshape(b, window, h, dh)
            qr = params["rq"].expand(b, h, dh)
            length = torch.full((b,), window, dtype=torch.int32,
                                device=hseq.device)
            ro = decode(qr, k2, v2, length).reshape(b, d)
            pooled = torch.cat([ro, hseq.mean(dim=1)], dim=-1)
            return pooled @ params["head"]["w"] + params["head"]["b"]

        return logits

    variants = {"kernel": make_logits("kernel"), "ref": make_logits("ref")}
    ref_logits = variants["ref"]

    def loss(params, batch):
        return spec_lib.cross_entropy(ref_logits(params, batch["x"]),
                                      batch["y"])

    def param_axes():
        qkv = ("embed", "heads")
        return {
            "embed": {"w": (None, "embed"), "b": ("embed",)},
            "pos": (None, "embed"),
            "wq": qkv, "wk": qkv, "wv": qkv, "wo": ("heads", "embed"),
            "rq": ("heads", None),
            "rkv": {"wk": qkv, "wv": qkv},
            "head": {"w": (None, None), "b": (None,)},
        }

    return spec_lib.ModelSpec(name="attn", init=init, loss=loss,
                              logits=variants[kops.DEFAULT_ROUTE],
                              route_variants=variants,
                              param_axes=param_axes)


spec_lib.register_model("cnn", _build_cnn)
spec_lib.register_model("rglru", _build_rglru)
spec_lib.register_model("ssm", _build_ssm)
spec_lib.register_model("attn", _build_attn)
