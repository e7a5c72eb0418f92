"""CLI: batched greedy (or sampled) decode serving on an assigned
architecture: the port's copy of ``repro/launch/serve.py``.

PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma_9b \\
    --full [--batch 4 --prompt-len 16 --new-tokens 32] [--device cpu]

Without ``--full`` it serves the architecture's smoke config.  The default
architecture is ``mamba2_130m``, as the reference's.  It runs on the card
unless given ``--device cpu``.  Prompts and sampling draw from a
``torch.Generator`` seeded by ``--seed`` + 1 (the params from ``--seed``).

At ``--full`` four architectures' bf16 weights need several cards whole,
as the reference's pod does, and run out of memory on one 80 GB card:
mistral-large-123b (245 GB), llama4-maverick-400b (789 GB), qwen2-vl-72b
(145 GB) and phi3.5-moe (84 GB).  Cut them in depth
(``dataclasses.replace(config(), n_layers=...)``) to serve them on one.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, build


def prefill_scan(model: Model, params, prompts: torch.Tensor, caches, *,
                 window: Optional[int] = None):
    """Prompt prefill as the decode step run over the prompt positions in
    order (the reference's ``lax.scan`` of ``decode_step``): the same math
    as a one-token-at-a-time loop, so the logits and caches are bitwise the
    loop's.  The caches are written in place.  Returns
    ``(last_logits [B,1,V], caches)``."""
    logits = None
    for t in range(prompts.shape[1]):
        logits, caches = model.decode_step(params, prompts[:, t:t + 1],
                                           caches, t, window=window)
    return logits, caches


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, params, prompts: torch.Tensor, new_tokens: int, *,
             window: Optional[int] = None, temperature: float = 0.0,
             gen: Optional[torch.Generator] = None) -> dict:
    """Prefill ``prompts [B,P]`` with :func:`prefill_scan`, then decode
    ``new_tokens`` tokens (argmax at temperature 0, else sampled from
    ``gen``).  Returns the tokens ``[B,new_tokens]``, the prefill's last
    logits, the caches and the host walls of both phases (seconds, each
    ending in a synchronise on a card)."""
    cfg, device = model.cfg, prompts.device
    b, p = prompts.shape
    caches = model.init_cache(b, p + new_tokens, params=params, window=window)

    def sample(lg):
        lg = lg[:, 0, :cfg.vocab_size]
        if temperature <= 0:
            return torch.argmax(lg, dim=-1)[:, None]
        probs = torch.softmax(lg / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    _sync(device)
    t0 = time.perf_counter()
    last, caches = prefill_scan(model, params, prompts, caches, window=window)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    toks = []
    t0 = time.perf_counter()
    tok = sample(last)
    for t in range(p, p + new_tokens):
        toks.append(tok)
        logits, caches = model.decode_step(params, tok, caches, t,
                                           window=window)
        tok = sample(logits)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(toks, dim=1), "prefill_logits": last,
            "caches": caches, "prefill_s": t_prefill, "decode_s": t_decode}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="mamba2_130m")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=not args.full)
    model = build(cfg)
    window = cfg.sliding_window
    print(f"== serving {cfg.name} (window={window}) on {device} ==")

    with torch.inference_mode():
        params = model.init(args.seed, device=device)
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        prompts = torch.randint(0, cfg.vocab_size,
                                (args.batch, args.prompt_len),
                                generator=gen, device=device)
        out = generate(model, params, prompts, args.new_tokens,
                       window=window, temperature=args.temperature, gen=gen)
    out["tok_per_s"] = args.batch * args.new_tokens / out["decode_s"]
    print(f"  prefill {args.prompt_len} tokens: {out['prefill_s']:.2f}s; "
          f"decode {args.new_tokens} tokens: {out['decode_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s)")
    for i in range(min(args.batch, 2)):
        print(f"  request {i}: {out['tokens'][i, :16].tolist()} ...")
    return out


if __name__ == "__main__":
    main()
