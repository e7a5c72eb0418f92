"""Population-scale memory accounting and auto-chunking: the port's copy
of ``repro/core/scale.py``, formulas unchanged.

The population engine (``train/fl_driver.run_fl_population``) keeps every
per-client quantity as an ``[n_clients]`` (or ``[n_clients, m]``) array:
the lazy membership table of the
:class:`~repro_torch.data.synthetic.Population`, the
:class:`~repro_torch.core.selection.UtilityState` /
:class:`~repro_torch.fault.process.FaultState` carries, and the transient
score/noise buffers cohort selection allocates each round.  This module is
the budget those arrays are held to, so tests can assert it against the
real tensors' bytes and the driver can derive an auto-chunking policy.
Budgets are per card: one H100 holds :data:`DEVICE_MEMORY_BYTES`.

Accounting (bytes, per lane unless noted):

* **Resident population data** (:func:`population_data_bytes`) — the
  membership table ``member_idx [N, m] i32`` + per-client scalars
  (``member_size`` i32, ``data_size``/``data_quality`` f32): shared by
  every lane.
* **Per-lane carries** (:func:`population_carry_bytes`) — the 11
  ``UtilityState`` + 2 ``FaultState`` f32 ``[N]`` vectors that ride the
  round scan.
* **Selection transients** (:func:`selection_transient_bytes`) — the f32
  ``[N]``-shaped temporaries one cohort-selection pass materialises
  (scores, availability-masked scores, exploration noise, availability)
  — the only term chunking shrinks: with ``c`` chunks the working set is
  ``⌈N/c⌉``-shaped.
* **Cohort batches** (:func:`cohort_batch_bytes`) — the gathered
  ``[k_max, steps, batch, d]`` training data; independent of N, which is
  what makes the whole plan sublinear.

Not counted (the reference's formulas, kept unchanged, predate them):
the port's own per-round buffers.  Per lane and client, by shape:
:class:`~repro_torch.core.rounds.CohortDraws`' population vectors, 48 B
(``avail_u`` and ``sel_noise`` f32, ``fault_u [4]`` f32, ``fault_steps
[3]`` int64), 96 MB at 10^6 clients × 2 lanes; the stable sort of
:func:`~repro_torch.core.selection.cohort_topk`, 12 B (f32 keys, int64
indices), 24 MB there; and the eager ``[L, N]`` temporaries of the
utility and failure steps, 8 MB each there.  So a budget given to
:func:`auto_chunks` is not a bound on the card's peak: ``chip_smoke.py``
phase 14 prints the peak beside these terms.

Policy (:func:`auto_chunks`): chunk the SELECTION scan — never the
carries, which must persist across rounds regardless — so its transient
working set fits the per-device budget left after the resident arrays.
Chunked and unchunked selection are bitwise identical
(:func:`repro_torch.core.selection.cohort_topk`), so the policy is pure
memory shaping, not semantics.
"""
from __future__ import annotations

import math

# Per-client f32 vectors carried across rounds: 11 UtilityState fields
# (core/selection.py) + 2 FaultState fields (fault/process.py).  A test
# pins these against the port's NamedTuples so the accounting cannot rot.
UTILITY_STATE_FIELDS = 11
FAULT_STATE_FIELDS = 2
CARRY_FIELDS = UTILITY_STATE_FIELDS + FAULT_STATE_FIELDS

# f32 [N]-shaped temporaries one unchunked cohort-selection pass holds
# live at once: scores, availability-masked scores, exploration noise,
# availability mask.
SELECTION_BUFFERS = 4

_F32 = 4
_I32 = 4

# One H100's device memory (80 GB), the budget a single card offers.
DEVICE_MEMORY_BYTES = 80 * 10**9


def population_data_bytes(n_clients: int, members_per_client: int) -> int:
    """Resident bytes of a Population's per-client arrays (pool excluded —
    it is O(pool) and shared, not O(N)): ``member_idx [N, m] i32`` +
    ``member_size [N] i32`` + ``data_size``/``data_quality [N] f32``."""
    return n_clients * (members_per_client * _I32 + _I32 + 2 * _F32)


def population_carry_bytes(n_clients: int) -> int:
    """Per-lane scan-carry bytes of the per-client state vectors."""
    return n_clients * CARRY_FIELDS * _F32


def selection_transient_bytes(n_clients: int, chunks: int = 1) -> int:
    """Peak f32 transient bytes of one cohort-selection pass with the
    score scan split into ``chunks`` pieces."""
    per_chunk = -(-n_clients // max(int(chunks), 1))
    return SELECTION_BUFFERS * per_chunk * _F32


def plan_transient_buffers(plan: str) -> int:
    """Extra per-round [n] f32 transients a registered execution plan adds
    on top of the selection pass, read off the core/plans registry: plans
    flagged ``fault_arrivals`` (buffered_async) materialise an arrival-score
    and an arrival-rank vector to order updates.  Memory accounting routes
    through the registry so a new plan extends the budget model by
    registering, not by editing this module."""
    from repro_torch.core.plans import get_plan  # lazy: scale stays light
    return 2 if get_plan(plan).fault_arrivals else 0


def cohort_batch_bytes(k_max: int, local_steps: int, batch: int,
                       n_features: int) -> int:
    """Bytes of one round's gathered cohort batches (x f32 + y i32) —
    the term that does NOT grow with N."""
    return k_max * local_steps * batch * (n_features * _F32 + _I32)


# Replicated model-parameter budget (bytes, per lane).  A detector whose
# parameter bytes stay under this replicates on every device; above it the
# reference shards the model over a multi-device client axis.  The port
# runs on one card, where the reference never shards either, so here it is
# accounting only.  The builtin zoo is ≤ ~100 KiB.
MODEL_REPLICATED_MAX_BYTES = 4 << 20


def model_needs_sharding(param_bytes: int,
                         max_bytes: int | None = None) -> bool:
    """True when a model's replicated parameter footprint exceeds the
    replicated-size budget and its parameters should shard via the
    ``ModelSpec.param_axes`` hook."""
    budget = MODEL_REPLICATED_MAX_BYTES if max_bytes is None else max_bytes
    return param_bytes > budget


def population_resident_bytes(n_clients: int, members_per_client: int,
                              n_lanes: int = 1, model_bytes: int = 0) -> int:
    """Everything that must stay resident per device (data shared across
    lanes + one carry per lane + one model replica per lane — pass the
    spec's ``param_bytes()`` as ``model_bytes``; 0 budgets the population
    state alone)."""
    return (population_data_bytes(n_clients, members_per_client)
            + n_lanes * population_carry_bytes(n_clients)
            + n_lanes * model_bytes)


def auto_chunks(n_clients: int, budget_bytes: int,
                members_per_client: int, n_lanes: int = 1,
                model_bytes: int = 0) -> int:
    """Selection-chunk count that fits ``budget_bytes`` per device.

    The resident arrays (membership + carries + model replicas) are
    irreducible — if they alone overflow the budget this raises, because
    no chunking policy can fix a population whose *state* does not fit
    (shard the client axis over more devices instead).  Otherwise the
    selection transients are chunked into whatever budget remains,
    floored at one chunk.
    """
    resident = population_resident_bytes(n_clients, members_per_client,
                                         n_lanes, model_bytes)
    if resident >= budget_bytes:
        raise ValueError(
            f"population resident state ({resident} B) exceeds the "
            f"per-device budget ({budget_bytes} B): {n_clients} clients x "
            f"{members_per_client} members x {n_lanes} lanes cannot fit "
            "regardless of chunking — shard the client axis over more "
            "devices or shrink the population")
    free = budget_bytes - resident
    transient = selection_transient_bytes(n_clients, 1)
    return max(1, math.ceil(transient / max(free, 1)))
