"""The paper's own detector model + FL hyper-parameters (Section V-A).

A tabular feed-forward anomaly detector trained with 40 clients, 200
communication rounds x 5 local epochs, ε ∈ [0.1, 10].
"""
from dataclasses import dataclass

from repro_torch.configs.base import FLConfig


@dataclass(frozen=True)
class PaperMLPConfig:
    name: str = "paper-mlp"
    hidden: int = 128
    n_classes: int = 2


def config() -> PaperMLPConfig:
    return PaperMLPConfig()


def smoke_config() -> PaperMLPConfig:
    return PaperMLPConfig(name="paper-mlp-smoke", hidden=32)


def paper_fl_config(n_clients: int = 40, rounds: int = 200) -> FLConfig:
    """The experimental FL setup of Section V-A."""
    return FLConfig(
        n_clients=n_clients,
        clients_per_round=8,
        adaptive_k=True,
        rounds=rounds,
        local_epochs=5,
        local_batch=64,
        local_lr=0.05,
        selection="adaptive_utility",
        dp_enabled=True,
        dp_epsilon=8.0,
        dp_delta=1e-5,
        dp_clip=1.0,
        fault_tolerance=True,
        failure_prob=0.05,
    )
