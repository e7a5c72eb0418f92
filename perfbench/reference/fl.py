"""The plain reference of one federated round of Algorithm 1 on an LM,
as the traffic's ``fl`` settings state it, in float32 with TF32 off and
the parameters stored in the configuration's dtype.

A round: K = ``slots`` client slots in turn, slot j training on the
round's batch j.  The adaptive K controller's K caps the live slots (it
starts at ``clients_per_round``, grows by max(1, K/4) after ``k_patience``
rounds without a loss under best·(1 − k_tol), shrinks by one on a loss
under best·(1 − 10·k_tol) once a best exists, and stays in [k_min,
clients]).  A slot fails when its uniform is under ``failure_prob``; at
its failure step its work is cut back to the last checkpoint, every
``ckpt_every_steps`` steps, and a slot left with no step adds nothing.
Each local step is SGD at ``local_lr`` from the f32 gradient of the loss
at the stored parameters, the new parameters rounded once to their
storage dtype.  The slot's update (local − global, f32) is clipped to
L2 norm ``dp_clip`` over the whole model and σ·n added, σ = clip ·
sqrt(2 ln(1.25/δ))/ε, n the slot's standard normal draw of P elements in
leaf order; the live slots' updates are averaged and added to the
stored parameters (server SGD at rate 1), rounded once.

The noise is the only draw the reference shares with the program: slot
j of round r takes the (r·K + j)-th ``normal_`` of P f32 elements from a
generator seeded with the run's noise seed, on the same kind of device.
Of a MoE it may also take the program's expert choices of the first
round (``replay``, keyed ``(slot, step, layer)``): every step of every
slot runs, as in the program, and each MoE layer follows the program's
choices with its own f32 gates (``lm.Route``); later rounds route by the
reference's own argmax (``harness/check.py`` says why).

Judging another run's server updates: at σ ≈ 0.97 an element the noise
is all of a weight's change, while a clipped update moves an element by
some 1e-4.  What the clean aggregate changes is where the stored weights
round: in bf16 it tips an element to the next value with a chance of
|Δ|/ulp.  So with ŵ_r = round(w_{r−1} + the live slots' mean noise), the
state the noise alone gives from the same start, ‖w_r − ŵ_r‖² is about
Σ ulp·|Δ| over the elements: the size of the clean aggregate as the
stored weights see it; and ‖w_1 − w_1^ref‖² from the shared start w_0
the size of the gap between two clean aggregates.  In float32, where |Δ|
is far above the ulp, both are the squared norms themselves.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from perfbench.reference import lm
from perfbench.reference.layout import Leaf, block_kind


def sigma(f: dict) -> float:
    return f["dp_clip"] * math.sqrt(2.0 * math.log(1.25 / f["dp_delta"])) \
        / f["dp_epsilon"]


CHUNK = 1 << 26


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖² in f64, ``CHUNK`` elements at a time."""
    a, b = a.reshape(-1), b.reshape(-1)
    return sum(float(((a[i:i + CHUNK].double() - b[i:i + CHUNK].double())
                      ** 2).sum()) for i in range(0, a.numel(), CHUNK))


def leaf_norms(a: Dict[Tuple, torch.Tensor], b: Dict[Tuple, torch.Tensor],
               order: List[Tuple]) -> List[float]:
    """‖a − b‖ of every leaf, in ``order``, accumulated in f64."""
    return [math.sqrt(sq_dist(a[k], b[k])) for k in order]


def _update_k(k, best, plateau, loss, f, n_clients):
    improved = loss < best * (1.0 - f["k_tol"])
    plateau = 0.0 if improved else plateau + 1.0
    grow = plateau >= f["k_patience"]
    if grow:
        k = k + max(0.25 * k, 1.0)
    strong = math.isfinite(best) and loss < best * (1.0 - 10.0 * f["k_tol"])
    if strong and not grow:
        k = k - 1.0
    k = min(max(k, float(f["k_min"])), float(n_clients))
    return k, min(best, loss), 0.0 if grow else plateau


FAULTS = (None, "half_batch", "no_clip", "noise_only", "route_shift")


def _ratio(a: float, b: float, both_nought: float) -> float:
    """a / b, and ``both_nought`` where both are 0 (a round with no live
    slot moves neither side)."""
    if b > 0.0:
        return a / b
    return both_nought if a == 0.0 else math.inf


def run_rounds(m: dict, f: dict, leaves: List[Leaf],
               weights: Dict[Tuple, torch.Tensor], batch: Callable,
               variates: Callable, noise_seed: int, rounds: int,
               precision: str = "f32", fault: Optional[str] = None,
               keep: bool = False,
               judge: Optional[Dict[str, List[dict]]] = None,
               replay: Optional[Dict[Tuple, list]] = None,
               record: bool = False) -> dict:
    """Follow ``rounds`` rounds from ``weights`` ({path: stored tensor},
    left unchanged).  ``batch(r)`` gives round r's ``(tokens, labels)``
    ``[K, steps, B, S]``; ``variates(r)`` its ``fail_u [K]`` and
    ``fail_step [K]``.  ``fault`` plants one: ``half_batch``, each step's
    loss over the first half of its batch rows only; ``no_clip``, the
    update noised unclipped; ``noise_only``, the clean updates left out
    of the aggregate; ``route_shift`` (a MoE), each token's last expert
    choice moved to its next-best.  ``replay`` maps ``(slot, step,
    layer)`` of the first round to a MoE layer's expert choices to follow
    (another run's, ``[B, S]`` each); with ``record``, ``route`` holds
    this run's own first-round choices in the same form.  Returns per
    round the live slots' mean last-step loss (``global_loss``), the sum
    of their first-step losses (``pre_sum``), each slot's pre-clip update
    norm (``norms``) and failure (``failed``), and every leaf's ‖w − w0‖ after the first round
    (``change1``) and the last (``change``).  With ``keep``, also the
    stored parameters after each round, on the host (``states``).
    ``judge`` maps a name to another run's ``states``; ``judged[name]``
    then holds ``agg1``, ‖w_1 − w_1^ref‖² over ‖w_1^ref − ŵ_1^ref‖², and
    ``scale``, each round's ‖w_r − ŵ_r‖² (ŵ_r from that run's own
    w_{r−1}) over the reference's (see the module's docstring).  Of a
    MoE, also the first round's ``route_gap``, the widest route gap of
    its steps (``lm.Route``), and ``route_flips``, its replayed choices
    below their token's k-th router logit and all its replayed
    choices."""
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    judge = judge or {}
    moe = block_kind(m) == "moe"
    lm.no_tf32()
    mm = lm.make_mm(precision)
    order = [x.path for x in leaves]
    device = weights[order[0]].device
    n_params = sum(weights[k].numel() for k in order)
    slots, steps = f["slots"], f["local_steps"]
    sig = sigma(f)
    clip = math.inf if fault == "no_clip" else f["dp_clip"]
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    w = {k: weights[k].clone() for k in order}
    k_ctl, best, plateau = float(f["clients_per_round"]), math.inf, 0.0
    out = {"global_loss": [], "pre_sum": [], "norms": [], "failed": [],
           "states": [], "judged": {name: {"agg1": math.nan, "scale": []}
                                    for name in judge}}
    if moe:
        out.update(route={}, route_gap=0.0, route_flips=[0, 0])
    for r in range(rounds):
        tokens, labels = batch(r)
        var = variates(r)
        k_eff = min(k_ctl, float(slots))
        kept = []  # each slot's (trained weights, live, clip scale)
        n_live, posts, pres, norms, failed = 0, [], [], [], []
        for j in range(slots):
            fail = float(var["fail_u"][j]) < f["failure_prob"]
            c = max(int(f["ckpt_every_steps"]), 1)
            eff = (int(var["fail_step"][j]) // c) * c if fail else steps
            local = {k: w[k].clone() for k in order}
            losses = []
            for s in range(steps):
                tok, lab = tokens[j, s], labels[j, s]
                if fault == "half_batch":
                    tok, lab = tok[:tok.shape[0] // 2], lab[:lab.shape[0] // 2]
                p32 = lm.f32_leaves(local)
                route = None
                if moe:
                    route = lm.Route(None if replay is None or r > 0 else [
                        replay[(j, s, i)] for i in range(m["n_layers"])],
                        shift=fault == "route_shift")
                loss = lm.loss(p32, m, tok, lab, mm, route)
                if route is not None and r == 0:
                    out["route_gap"] = max(out["route_gap"], route.gap)
                    out["route_flips"][0] += route.flips
                    out["route_flips"][1] += route.choices
                    if record:
                        out["route"].update(
                            {(j, s, i): [c.cpu() for c in taken]
                             for i, taken in enumerate(route.taken)})
                grads = torch.autograd.grad(loss, [p32[k] for k in order])
                losses.append(float(loss.detach()))
                if s < eff:
                    for k, g in zip(order, grads):
                        local[k] = (p32[k].detach() - f["local_lr"] * g).to(
                            local[k].dtype)
                del p32, grads, loss
            norm = math.sqrt(sum(sq_dist(local[k], w[k]) for k in order))
            live = j < k_eff and eff > 0
            kept.append((local if live else None, live,
                          min(1.0, clip / max(norm, 1e-12))))
            del local
            n_live += int(live)
            posts.append(losses[-1] * live)
            pres.append(losses[0] * live)
            norms.append(norm)
            failed.append(fail)
        # The slots' noise, drawn in slot order once all have trained (the
        # draws are the generator's alone), and their clipped updates.
        clean = {k: torch.zeros(w[k].shape, device=device) for k in order}
        noise_sum = {k: torch.zeros(w[k].shape, device=device) for k in order}
        for j in range(slots):
            local, live, scale = kept[j]
            kept[j] = None
            noise = torch.empty(n_params, device=device).normal_(generator=gen)
            off = 0
            for k in order:
                size = w[k].numel()
                if live:
                    if fault != "noise_only":
                        clean[k] += (local[k].float() - w[k].float()) * scale
                    noise_sum[k] += sig * noise[off:off + size].view(w[k].shape)
                off += size
            del local, noise
        denom = max(float(n_live), 1e-9)
        s_ref, s_other = 0.0, dict.fromkeys(judge, 0.0)
        gap1 = dict.fromkeys(judge, 0.0)
        for k in order:
            alone = noise_sum.pop(k).div_(denom)
            new = (w[k].float() + (clean.pop(k).div_(denom) + alone)).to(
                w[k].dtype)
            s_ref += sq_dist(new, (w[k].float() + alone).to(w[k].dtype))
            for name, states in judge.items():
                prev = weights[k] if r == 0 else states[r - 1][k].to(device)
                got = states[r][k].to(device)
                s_other[name] += sq_dist(
                    got, (prev.float() + alone).to(w[k].dtype))
                if r == 0:
                    gap1[name] += sq_dist(got, new)
                del prev, got
            w[k] = new
            del alone
        for name, j in out["judged"].items():
            j["scale"].append(_ratio(s_other[name], s_ref, 1.0))
            if r == 0:
                j["agg1"] = _ratio(gap1[name], s_ref, 0.0)
        if keep:
            out["states"].append({k: w[k].cpu() for k in order})
        global_loss = sum(posts) / max(float(n_live), 1.0)
        k_ctl, best, plateau = _update_k(k_ctl, best, plateau, global_loss,
                                         f, f["clients"])
        out["global_loss"].append(global_loss)
        out["pre_sum"].append(sum(pres))
        out["norms"].append(norms)
        out["failed"].append(failed)
        if r == 0:
            out["change1"] = leaf_norms(w, weights, order)
    out["change"] = leaf_norms(w, weights, order)
    return out
