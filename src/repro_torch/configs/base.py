"""Configuration: the port's copy of ``repro/configs/base.py``.

Two halves.  The language-model half: ``ModelConfig`` (the architecture
description every assigned family shares), ``ShapeConfig`` and
``INPUT_SHAPES``, and the registry (``ARCH_IDS``, ``ARCH_ALIASES``,
``get_arch``, ``get_shape``, ``all_pairs``); an architecture module lives
in ``repro_torch/configs/<id>.py`` with ``config()`` and
``smoke_config()``.  ``MeshConfig`` names the production meshes the
step bundles (``launch/steps.py``) and the dry-run lay a step across;
``RunConfig`` bundles one run's model, shape, mesh and FL settings.

The federated-learning half: ``FLConfig``, ``FLParams``,
``RUNTIME_FIELDS``, ``fl_params``, ``fl_static`` and the sweep engine's
``params_lanes``.  Field names, defaults and the static/runtime split are
the reference's, so one config reads the same in both packages.  STATIC
fields shape the code path (plan, strategy, booleans); RUNTIME fields are
the scalar knobs the round step reads from an :class:`FLParams` argument.
A field of an ``FLParams`` is a Python float (one run) or a ``[L]`` f32
tensor with one value per lane of a sweep (``params_lanes``).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description covering every assigned family."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # None = full causal attention
    mrope_sections: Optional[Tuple[int, int, int]] = None  # VLM M-RoPE (t,h,w)

    # --- MoE ---
    n_experts: int = 0  # experts a layer holds: the first of the router's
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # the router's width, the experts a layer routes over (0 -> n_experts);
    # a layer that holds fewer is one card's share under expert parallelism
    router_experts: int = 0

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_expand: int = 2
    conv_width: int = 4

    # --- hybrid (RecurrentGemma / Griffin) ---
    # pattern of block kinds, tiled (with truncation) to n_layers
    block_pattern: Optional[Tuple[str, ...]] = None
    lru_width: int = 0  # RG-LRU recurrent width (0 -> d_model)

    # --- encoder-decoder (audio) ---
    enc_layers: int = 0  # 0 => decoder-only
    enc_seq: int = 1024  # stub frontend: number of frame embeddings

    # --- multimodal frontend stubs ---
    frontend: str = "none"  # none | vision | audio
    frontend_tokens: int = 0  # patch/frame embeddings prepended to the prompt

    # --- misc ---
    act: str = "swiglu"  # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    long_context_variant: Optional[str] = None  # e.g. "swa-4096" for long_500k
    source: str = ""  # citation for the spec

    def __post_init__(self):
        if self.router_experts and not (
                0 < self.n_experts <= self.router_experts):
            raise ValueError(f"{self.n_experts} experts held of the "
                             f"router's {self.router_experts}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_router_experts(self) -> int:
        return self.router_experts or self.n_experts

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def pattern(self) -> Tuple[str, ...]:
        """Per-layer block kinds of length n_layers: ``block_pattern``
        tiled, else the family's default."""
        if self.block_pattern:
            reps = -(-self.n_layers // len(self.block_pattern))
            return (self.block_pattern * reps)[: self.n_layers]
        if self.family == "ssm":
            return ("ssd",) * self.n_layers
        if self.family == "moe":
            return ("moe",) * self.n_layers
        return ("attn",) * self.n_layers

    def segments(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """pattern() as (super-block, repeats) segments: the repeating unit,
        then the trailing remainder as its own segment.  Each segment's
        params are stacked along a leading "layers" axis."""
        pat = self.pattern()
        if self.block_pattern:
            unit = self.block_pattern
            n_full = self.n_layers // len(unit)
            segs = []
            if n_full:
                segs.append((tuple(unit), n_full))
            rem = self.n_layers - n_full * len(unit)
            if rem:
                segs.append((tuple(pat[-rem:]), 1))
            return tuple(segs)
        return (((pat[0],), self.n_layers),)

    def supports_long_context(self) -> bool:
        if self.family in ("ssm", "hybrid"):
            return True
        return self.long_context_variant is not None

    def param_count(self) -> int:
        """Approximate parameter count (reported, not load-bearing)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        mlp_mult = 3 if self.act in ("swiglu", "geglu") else 2
        mlp = mlp_mult * d * dff
        per_layer = 0
        for kind in self.pattern():
            if kind == "attn":
                per_layer += attn + mlp
            elif kind == "moe":
                per_layer += (attn + self.n_experts * mlp
                              + d * self.resolved_router_experts)
            elif kind == "ssd":
                din = self.ssm_expand * d
                per_layer += d * (2 * din + 2 * self.ssm_state) + din * d
            elif kind == "rec":
                w = self.lru_width or d
                per_layer += 2 * d * w + w * d + 3 * w + mlp
        emb = v * d * (1 if self.tie_embeddings else 2)
        enc = self.enc_layers * (attn + mlp) if self.enc_layers else 0
        return per_layer + emb + enc

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts; of a
        layer that holds a share of them, that share of the
        ``experts_per_token``, on average)."""
        if self.family != "moe":
            return self.param_count()
        d, dff = self.d_model, self.d_ff
        mlp_mult = 3 if self.act in ("swiglu", "geglu") else 2
        full = self.param_count()
        expert = mlp_mult * d * dff
        unused = (self.n_experts * expert
                  - self.experts_per_token * expert * self.n_experts
                  // self.resolved_router_experts)
        n_moe_layers = sum(1 for k in self.pattern() if k == "moe")
        return full - n_moe_layers * unused


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "phi3p5_moe_42b",
    "llama4_maverick_400b",
    "recurrentgemma_9b",
    "mamba2_130m",
    "seamless_m4t_large_v2",
    "mistral_large_123b",
    "qwen2_vl_72b",
    "qwen2p5_32b",
    "granite_3_8b",
    "phi3_mini_3p8b",
)

# user-facing aliases (--arch accepts either)
ARCH_ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi3p5_moe_42b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-130m": "mamba2_130m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mistral-large-123b": "mistral_large_123b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "qwen2.5-32b": "qwen2p5_32b",
    "granite-3-8b": "granite_3_8b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "paper-mlp": "paper_mlp",
}

def get_arch(arch: str, smoke: bool = False) -> ModelConfig:
    """Load ``config()`` (or ``smoke_config()``) from
    repro_torch.configs.<arch>."""
    arch = ARCH_ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke_config() if smoke else mod.config()


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


def all_pairs() -> Sequence[Tuple[str, str]]:
    """Every assigned (architecture x input shape) combination (40)."""
    return [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]


# ---------------------------------------------------------------------------
# Federated-learning configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FLConfig:
    """Hyper-parameters of Algorithm 1 and its substrate."""

    # detector architecture (STATIC): a name in models/spec.py's registry
    model: str = "mlp"
    n_clients: int = 40
    clients_per_round: int = 8          # K (initial value when adaptive)
    adaptive_k: bool = True
    k_min: int = 2
    k_max: int = 0                      # 0 -> n_clients
    rounds: int = 200
    local_epochs: int = 5
    local_batch: int = 64
    local_lr: float = 0.05
    selection: str = "adaptive_utility"  # see core/selection.py registry
    # utility score weights
    alpha: float = 1.0                  # accuracy weight in F(S_t)
    gamma: float = 0.1                  # cost weight in F(S_t)
    utility_ema: float = 0.5
    explore_noise: float = 0.05         # selection temperature (Gumbel scale)
    avail_prob: float = 0.95            # per-client per-round availability
    k_tol: float = 1e-3                 # adaptive-K plateau tolerance
    k_patience: float = 3.0             # adaptive-K plateau patience (rounds)
    coherence_scoring: bool = True      # cos(Δ_i, Δ_agg) data-quality signal
    # --- differential privacy ---
    dp_enabled: bool = True
    dp_epsilon: float = 8.0
    dp_delta: float = 1e-5
    dp_clip: float = 1.0
    dp_mode: str = "clipped"            # "paper" (fixed sigma, no clip) | "clipped"
    dp_sigma: float = 0.01              # used in "paper" mode
    # scheduled budget accounting (STATIC dp_scheduled): the sweep engine's
    # in-loop accountant and noise schedules; run_fl_legacy rejects it, as
    # the reference's run_fl_legacy does
    dp_scheduled: bool = False
    dp_budget: float = 50.0
    dp_sched: float = 0.0
    dp_sched_rate: float = 0.3
    dp_stall_tol: float = 1e-3
    # --- fault tolerance ---
    fault_tolerance: bool = True        # STATIC checkpoint-recovery gate
    failure_prob: float = 0.05          # marginal per-client per-round rate
    fault_process: float = 0.0          # 0 iid | 1 markov | 2 weibull | 3 straggler
    fault_burst: float = 3.0            # markov: expected outage length (rounds)
    straggler_slow: float = 4.0         # straggler: round-time stretch factor
    fault_util_w: float = 0.0           # utility penalty on the failure EMA
    weibull_scale: float = 600.0        # lambda (seconds; cost model)
    weibull_shape: float = 1.2          # k (cost model AND lifetime process)
    recovery_time: float = 30.0         # t_r (seconds)
    checkpoint_every: int = 0           # rounds; 0 -> derive from Weibull model
    # --- server ---
    server_opt: str = "sgd"             # sgd | fedavgm | fedadam
    server_lr: float = 1.0
    # --- execution plan (core/plans.py registry) ---
    plan: str = "client_parallel"
    serial_clients_in_step: int = 4
    local_steps_in_step: int = 1
    async_buffer: float = 0.0
    async_staleness_pow: float = 0.5
    hier_comm_frac: float = 0.3
    hierarchy_edges: int = 4

    def __post_init__(self):
        from repro_torch.core.plans import validate_plan
        validate_plan(self)


class FLParams(NamedTuple):
    """The RUNTIME half of :class:`FLConfig`: the values the round step
    reads instead of closing over them, each a Python float or a ``[L]``
    f32 tensor of per-lane values."""

    local_lr: float = 0.05
    server_lr: float = 1.0
    dp_epsilon: float = 8.0
    dp_sigma: float = 0.01
    dp_clip: float = 1.0
    dp_budget: float = 50.0
    dp_sched: float = 0.0
    dp_sched_rate: float = 0.3
    dp_stall_tol: float = 1e-3
    failure_prob: float = 0.05
    fault_process: float = 0.0
    fault_burst: float = 3.0
    straggler_slow: float = 4.0
    fault_util_w: float = 0.0
    weibull_shape: float = 1.2
    recovery_time: float = 30.0
    avail_prob: float = 0.95
    explore_noise: float = 0.05
    k_tol: float = 1e-3
    k_patience: float = 3.0
    async_buffer: float = 0.0
    async_staleness_pow: float = 0.5
    hier_comm_frac: float = 0.3
    # derived from the plan name (core/plans.py), not an FLConfig field
    plan_code: float = 0.0


RUNTIME_FIELDS = tuple(f for f in FLParams._fields if f != "plan_code")


def as_f32(value, like: torch.Tensor) -> torch.Tensor:
    """An :class:`FLParams` field as f32 on ``like``'s device: a lane tensor
    as it is, a float filled in (no host-to-device copy)."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def fl_params(fl: FLConfig) -> FLParams:
    """The runtime knobs of ``fl``; ``plan_code`` comes from the plan name."""
    from repro_torch.core.plans import plan_code
    return FLParams(plan_code=plan_code(fl.plan),
                    **{f: getattr(fl, f) for f in RUNTIME_FIELDS})


def fl_static(fl: FLConfig) -> FLConfig:
    """The STATIC part of ``fl``: runtime fields reset to their defaults and
    the plan name canonicalised to its program family."""
    from repro_torch.core.plans import plan_family
    defaults = {f: FLConfig.__dataclass_fields__[f].default
                for f in RUNTIME_FIELDS}
    return dataclasses.replace(fl, plan=plan_family(fl.plan), **defaults)


def params_lanes(cells: Sequence[FLConfig], n_seeds: int,
                 device=None) -> FLParams:
    """Every cell's runtime params as ``[len(cells)·n_seeds]`` f32 lanes on
    ``device``, cell-major (lane = cell_index · n_seeds + seed_index), as
    the reference's ``_params_lanes`` stacks them."""
    per_cell = [fl_params(c) for c in cells]
    return FLParams(*(
        torch.tensor([getattr(p, f) for p in per_cell], dtype=torch.float32,
                     device=device).repeat_interleave(n_seeds)
        for f in FLParams._fields))


# ---------------------------------------------------------------------------
# Mesh / run configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    """A production mesh: 16 × 16 ("data", "model"), or two of them under a
    leading "pod" axis (2 × 16 × 16, 512 ranks)."""

    multi_pod: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    fl: FLConfig = field(default_factory=FLConfig)
    # remat policy for the layer stack: "full" | "dots" | "none"
    remat: str = "full"
    # microbatches for gradient accumulation inside train_step
    grad_accum: int = 1
    attention_impl: str = "ref"  # ref | flash (the flash_attention kernel)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
