"""The one generator of every traffic mix: it reads a mix's parameters
(``traffic/<name>.json``) and makes its inputs from the run's seed, on the
device, before the measured window.

Two kinds of mix:

- ``fl_rounds``: federated rounds.  A pool of ``pool_rounds`` rounds of
  client data (tokens and next-token labels ``[K, local_steps, batch,
  seq]``) and ``variate_rounds`` rounds of the round's random variates
  (availability and selection uniforms, the slots' failure uniforms and
  failure steps); round r takes pool entry r mod the pool's size.
- ``prefill_closed``: batches of ``batch`` prompts, one after another,
  the prompt length cycling through ``lengths``; ``pool_batches``
  batches of each length, batch i taking length i mod len(lengths) and
  pool entry (i // len(lengths)) mod ``pool_batches``.

Token ids follow ``tokens``: ``{"dist": "zipf", "exponent": a}`` draws id
i with weight 1/(i + 1)^a, ``{"dist": "uniform"}`` every id alike.  Every
seed gives the same sizes; only the values differ.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from perfbench.reference.layout import sub_seed


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def token_ids(spec: dict, vocab: int, shape, gen: torch.Generator) -> torch.Tensor:
    """int32 ids of ``shape`` in [0, vocab)."""
    n = 1
    for s in shape:
        n *= s
    dev = gen.device
    if spec["dist"] == "uniform":
        ids = torch.randint(0, vocab, (n,), generator=gen, device=dev)
    elif spec["dist"] == "zipf":
        w = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64,
                               device=dev) ** spec["exponent"]
        ids = torch.multinomial(w.float(), n, replacement=True, generator=gen)
    else:
        raise ValueError(f"token dist {spec['dist']!r}")
    return ids.to(torch.int32).reshape(shape)


class FlPool(NamedTuple):
    tokens: torch.Tensor      # [pool_rounds, K, steps, B, S] int32
    labels: torch.Tensor
    avail_u: torch.Tensor     # [variate_rounds, n] f32
    sel_noise: torch.Tensor   # [variate_rounds, n] f32, standard Gumbel
    fail_u: torch.Tensor      # [variate_rounds, K] f32
    fail_step: torch.Tensor   # [variate_rounds, K] int64

    def batch(self, r: int) -> Dict[str, torch.Tensor]:
        i = r % self.tokens.shape[0]
        return {"tokens": self.tokens[i], "labels": self.labels[i]}

    def variates(self, r: int) -> Dict[str, torch.Tensor]:
        i = r % self.avail_u.shape[0]
        return {"avail_u": self.avail_u[i], "sel_noise": self.sel_noise[i],
                "fail_u": self.fail_u[i], "fail_step": self.fail_step[i]}


def fl_pool(t: dict, vocab: int, seed: int, device) -> FlPool:
    f = t["fl"]
    k, steps = f["slots"], f["local_steps"]
    gen = generator(seed, "data", device)
    ids = token_ids(t["tokens"], vocab,
                    (t["pool_rounds"], k, steps, t["batch"], t["seq"] + 1), gen)
    var = generator(seed, "variates", device)
    nv, n = t["variate_rounds"], f["clients"]
    avail = torch.rand(nv, n, generator=var, device=device)
    u = torch.rand(nv, n, generator=var, device=device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    fail_u = torch.rand(nv, k, generator=var, device=device)
    fail_step = torch.randint(0, steps, (nv, k), generator=var, device=device)
    return FlPool(ids[..., :-1].contiguous(), ids[..., 1:].contiguous(),
                  avail, gumbel, fail_u, fail_step)


def tokens_per_round(t: dict) -> int:
    f = t["fl"]
    return f["slots"] * f["local_steps"] * t["batch"] * t["seq"]


class PromptPool(NamedTuple):
    lengths: tuple
    prompts: Dict[int, torch.Tensor]  # length -> [pool_batches, B, L] int32

    def batch(self, i: int):
        """(length, pool entry, prompts [B, L]) of the window's batch i."""
        n = len(self.lengths)
        length = self.lengths[i % n]
        j = (i // n) % self.prompts[length].shape[0]
        return length, j, self.prompts[length][j]


def prompt_pool(t: dict, vocab: int, seed: int, device) -> PromptPool:
    gen = generator(seed, "prompts", device)
    prompts = {length: token_ids(t["tokens"], vocab,
                                 (t["pool_batches"], t["batch"], length), gen)
               for length in t["lengths"]}
    return PromptPool(tuple(t["lengths"]), prompts)
