"""CLI: federated LM training on an assigned architecture — the port's copy
of ``repro/launch/train.py``.

Runs real FL rounds (Algorithm 1 — selection + DP + fault tolerance) of the
``client_serial`` plan (``core/rounds.py`` ``make_serial_round``) over the
architecture's smoke config, or its full published config with ``--full``.

PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_8b \\
    --rounds 3 [--full] [--seq 64] [--batch 2] [--dp] [--device cpu]

The reference's flags and printed lines, plus ``--device``: the card
unless ``cpu`` is asked, raising without one.  Params come from a
``torch.Generator`` seeded by ``--seed`` and the round state's generator
from ``--seed`` + 1; tokens from the NumPy streams of ``data/tokens.py``,
and the stub frontend embeddings of a VLM or an encoder-decoder from
NumPy too (:func:`round_batches`, :func:`eval_batch`), all bitwise the
reference's.  :func:`train` runs a :class:`ModelConfig` that its caller
built; :func:`main` returns its record.

Every architecture trains at its smoke config on the CPU or one card.  At
``--full`` the weights alone of four need several cards, as the
reference's pod does: mistral-large-123b (245 GB in bf16),
llama4-maverick-400b (789 GB), qwen2-vl-72b (145 GB) and phi3.5-moe (84
GB).  The serial round holds ~16–18 bytes a parameter at its peak
(phi3.5-moe cut to 2 layers: 48.7 GB for 2.86 B parameters on an H100):
seamless-m4t-large-v2 (1.6 B) and mamba2-130m train whole on one 80 GB
card, granite-3-8b, qwen2.5-32b and recurrentgemma-9b need several too,
and phi3-mini-3.8b (~65 GB by that ratio) is not measured.  Where one
card runs out of memory, cut the model in depth
(``dataclasses.replace(config(), n_layers=...)``) and call :func:`train`.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, FLConfig, ModelConfig, get_arch
from repro_torch.core import rounds as rounds_lib
from repro_torch.data.tokens import lm_eval_batch, lm_round_batches
from repro_torch.device import resolve_device
from repro_torch.models.model import build


def _tensors(data: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in data.items()}


def has_frontend(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` takes ``batch["frontend"]``: an encoder-decoder's
    frames, or a frontend's stub tokens (a VLM's patches)."""
    return cfg.enc_layers > 0 or (cfg.frontend != "none"
                                  and bool(cfg.frontend_tokens))


def _frontend_len(cfg: ModelConfig) -> int:
    return cfg.enc_seq if cfg.enc_layers else cfg.frontend_tokens


def round_batches(cfg: ModelConfig, fl: FLConfig, batch: int, seq: int,
                  seed: int) -> dict:
    """One round's data as NumPy arrays, the reference CLI's
    ``_round_batches``: tokens and labels ``[K, local_steps, batch, seq]``
    and, where :func:`has_frontend`, ``frontend`` ``[K, local_steps,
    batch, n, d_model]`` f32 normals from ``default_rng(seed)``."""
    k, steps = fl.serial_clients_in_step, fl.local_steps_in_step
    data = lm_round_batches(cfg.vocab_size, k, steps, batch, seq, seed)
    if has_frontend(cfg):
        data["frontend"] = np.random.default_rng(seed).normal(
            0, 1, (k, steps, batch, _frontend_len(cfg),
                   cfg.d_model)).astype(np.float32)
    return data


def eval_batch(cfg: ModelConfig, batch: int, seq: int, seed: int) -> dict:
    """The eval batch as NumPy arrays, the reference CLI's
    ``_eval_batch``: tokens and labels from ``seed`` + 999 and, where
    :func:`has_frontend`, ``frontend`` ``[batch, n, d_model]`` f32 normals
    from ``default_rng(0)`` whatever the seed, as the reference draws
    them."""
    data = lm_eval_batch(cfg.vocab_size, batch, seq, seed + 999)
    if has_frontend(cfg):
        data["frontend"] = np.random.default_rng(0).normal(
            0, 1, (batch, _frontend_len(cfg), cfg.d_model)).astype(
            np.float32)
    return data


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_fl_config(clients: int = 8, clients_per_step: int = 2,
                    local_steps: int = 1, lr: float = 0.005,
                    dp: bool = False) -> FLConfig:
    """The CLI's :class:`FLConfig`: clipped DP at ε 50 and clip 10 when
    ``dp``, i.i.d. failures at 0.05, ``clients_per_step`` slots a round."""
    return FLConfig(
        n_clients=clients, clients_per_round=clients_per_step,
        local_lr=lr, dp_enabled=dp, dp_mode="clipped",
        dp_epsilon=50.0, dp_clip=10.0, failure_prob=0.05,
        serial_clients_in_step=clients_per_step,
        local_steps_in_step=local_steps,
    )


def train(cfg: ModelConfig, *, rounds: int = 3, clients: int = 8,
          clients_per_step: int = 2, local_steps: int = 1, batch: int = 2,
          seq: int = 64, lr: float = 0.005, dp: bool = False, seed: int = 0,
          device=None) -> dict:
    """Federated training of ``cfg`` on ``device`` (``cuda`` unless
    ``"cpu"`` is asked), printing the reference's lines.  Returns the
    eval losses, each round's metrics and host wall (seconds, ending in a
    synchronise on a card), and the model, ``FLConfig``, round step and
    final state."""
    device = resolve_device(device)
    model = build(cfg)
    print(f"== {cfg.name} ({cfg.param_count()/1e6:.1f}M params, "
          f"family={cfg.family}) on {device} ==")

    fl = train_fl_config(clients, clients_per_step, local_steps, lr, dp)
    state = rounds_lib.init_serial_state(
        model.init(seed, device=device), fl,
        torch.Generator(device=device).manual_seed(seed + 1),
        n_clients=clients)
    step = rounds_lib.make_serial_round(
        lambda p, b: model.loss(p, b, remat="none"), fl, clients,
        device=device)

    eval_b = _tensors(eval_batch(cfg, batch, seq, seed), device)

    def ev(p) -> float:
        with torch.no_grad():
            return float(model.loss(p, eval_b, remat="none"))

    out = {"initial_eval_loss": ev(state.params), "rounds": []}
    print(f"  initial eval loss: {out['initial_eval_loss']:.4f}")
    for r in range(rounds):
        data = _tensors(round_batches(cfg, fl, batch, seq, seed * 100 + r),
                        device)
        _sync(device)
        t0 = time.perf_counter()
        state, m = step(state, data)
        _sync(device)
        wall = time.perf_counter() - t0
        row = {"local_loss": float(m.global_loss),
               "k": float(m.k_effective),
               "failures": int(m.failed.sum()), "wall_s": wall}
        out["rounds"].append(row)
        print(f"  round {r}: local_loss={row['local_loss']:.4f} "
              f"K={row['k']:.0f} failures={row['failures']} ({wall:.1f}s)")
    out["final_eval_loss"] = ev(state.params)
    print(f"  final eval loss: {out['final_eval_loss']:.4f}")
    out.update(model=model, fl=fl, step=step, state=state)
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite_3_8b")
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--clients-per-step", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.005)
    ap.add_argument("--dp", action="store_true",
                    help="enable DP noise (off by default here: per-element "
                         "noise swamps reduced smoke models)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return train(get_arch(args.arch, smoke=not args.full),
                 rounds=args.rounds, clients=args.clients,
                 clients_per_step=args.clients_per_step,
                 local_steps=args.local_steps, batch=args.batch,
                 seq=args.seq, lr=args.lr, dp=args.dp, seed=args.seed,
                 device=device)


if __name__ == "__main__":
    main()
