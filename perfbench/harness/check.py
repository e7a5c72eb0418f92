"""The numbers that decide ``correct``, each against the limit in
``limits/<cell>.json``.

Training (the rounds the set-up ran through the window's own call and
feed, the reference following the same rounds from the same weights,
data, variates and noise):

- ``loss1``: the first round's relative gap of the live slots' mean
  last-step loss, or of the sum of their first-step losses;
- ``update_norm1``: the largest relative gap of a first-round slot's
  pre-clip update norm (the norm the DP clip reads);
- ``grad1``: the server's first gradient, ‖w1 − w0‖ of each leaf; and
  ``change``: ‖w_R − w0‖ of each leaf after the last round followed.
  Each by the worst leaf: |program − reference| over the larger of the
  reference's norm of that leaf and of the median leaf.  A leaf whose
  reference first gradient is under a thousandth of the median leaf's
  is left out of both.  Both are the DP noise's, which the two sides
  share: they see a state left unchanged, not the clean aggregate;
- ``agg1``: the first round's aggregated clean update, the gap between
  the program's stored weights after round 1 and the reference's, over
  the reference's own distance from the noise alone
  (``reference/fl.py``): the wrong slot, weights or noise draw, or the
  clean updates left out;
- ``update_scale``: the largest, over the rounds followed, of |ratio − 1|
  of the clean aggregate's size in the program's weights (each round
  from the program's own previous weights) and in the reference's: a
  clip skipped where it binds (round 2 on, where update norms exceed the
  clip), or the updates summed and not averaged.

- ``route_gap`` (a MoE only): the widest gap, over every token, layer,
  step and choice of the first round, by which the reference's router
  logit for the expert the program chose lies below the reference's
  k-th largest router logit at that token.  Set-up records the
  program's expert choices of the first round (``harness/fl.py``) and
  the reference follows them (``reference/lm.py`` ``Route``), so that a
  near-tie the bf16 program routes the other way does not send the two
  sides' tokens to different experts; this number checks those choices:
  0 where the program routes as the f32 reference would, about one
  rounding of a logit at a near-tie, the whole gap between experts where
  a choice is wrong, and inf where the choices do not cover the batch.
  Later rounds follow no choice of the program: the reference routes
  them by its own argmax.  There the DP noise has made the router all
  noise (σ ≈ 0.97 an element against its 1/sqrt(d) draw), its logits
  some hundreds and its softmax saturated, and the bf16 and f32 hidden
  states lie apart by far more than a rounding: sound runs put about 60 %
  of their choices under the reference's k-th logit, as a wrong routing
  would, so no number can check them, and a reference that followed them
  would compute from choices nothing checked.  A routing fault that
  first shows after the first round is left to ``update_scale`` and
  ``change``, which it need not fail.

The losses and update norms of the later rounds are printed beside them
(``train_detail``) and not compared: after the first round the DP noise
(σ ≈ 0.97 an element at ε 50, clip 10) dominates every weight, and the
model it leaves saturates its softmaxes, so a rounding moves those
readings by tens of percent in sound runs and in the control alike.

Prefill: ``logit_gap``, the widest gap, over every request served in the
window, by which the served token's reference logit lies below the
reference's best logit for that prompt.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

SMALL_LEAF = 1e-3


def _rel(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def worst_leaf(prog: Sequence[float], ref: Sequence[float],
               keep: Sequence[bool]) -> float:
    kept = [(p, r) for p, r, k in zip(prog, ref, keep) if k]
    if not kept:
        return math.inf
    med = statistics.median(r for _, r in kept)
    gaps = [abs(p - r) / max(r, med, 1e-30) if math.isfinite(p) else math.inf
            for p, r in kept]
    return max(gaps)


def leaves_kept(ref_grad1: Sequence[float]) -> List[bool]:
    med = statistics.median(ref_grad1)
    return [g >= SMALL_LEAF * med for g in ref_grad1]


def train_numbers(prog: dict, ref: dict, name: str) -> Dict[str, float]:
    """``prog``'s numbers against ``ref``, which judged ``prog``'s states
    under ``name`` (of a MoE, following ``prog``'s expert choices)."""
    loss = max(_rel(prog["global_loss"][0], ref["global_loss"][0]),
               _rel(prog["pre_sum"][0], ref["pre_sum"][0]))
    norm = max(_rel(p, q) for p, q in zip(prog["norms"][0], ref["norms"][0]))
    keep = leaves_kept(ref["change1"])
    judged = ref["judged"][name]
    out = {"loss1": loss, "update_norm1": norm,
           "grad1": worst_leaf(prog["change1"], ref["change1"], keep),
           "change": worst_leaf(prog["change"], ref["change"], keep),
           "agg1": judged["agg1"],
           "update_scale": max(abs(x - 1.0) for x in judged["scale"])}
    if "route_gap" in ref:
        out["route_gap"] = ref["route_gap"]
    return out


def train_detail(prog: dict, ref: dict, name: str) -> dict:
    """Each round's relative gaps (the loss, the first-step sum, every
    slot's update norm, the clean aggregate's size) and, of a MoE, the
    first round's replayed choices below the k-th logit and all replayed,
    for the record beside the numbers."""
    return {"scale": ref["judged"][name]["scale"],
            **({"route_flips": ref["route_flips"]}
               if "route_flips" in ref else {}),
            "loss": [_rel(p, q) for p, q in zip(prog["global_loss"],
                                                 ref["global_loss"])],
            "pre_sum": [_rel(p, q) for p, q in zip(prog["pre_sum"],
                                                    ref["pre_sum"])],
            "update_norm": [[_rel(p, q) for p, q in zip(pr, rr)]
                            for pr, rr in zip(prog["norms"], ref["norms"])],
            "ref_norms": ref["norms"], "ref_loss": ref["global_loss"]}


def logit_gap(served, ref_logits) -> float:
    """``served`` [N] token ids; ``ref_logits`` [N, V] f32 of the same
    prompts."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served.long()[:, None])[:, 0]
    gap = float((best - got).max())
    return gap if math.isfinite(gap) else math.inf


def with_limits(numbers: Dict[str, float], limits: dict) -> Dict[str, tuple]:
    missing = set(numbers) ^ set(limits["numbers"])
    if missing:
        raise KeyError(f"numbers and limits differ: {sorted(missing)}")
    return {k: (v, float(limits["numbers"][k]["limit"]))
            for k, v in numbers.items()}
