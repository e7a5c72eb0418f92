"""Fault-tolerance subsystem (paper §IV): one namespace for both halves,
as the reference's ``repro.fault``.

* the **checkpoint cost model** and Weibull fitting — host-side analysis
  in ``repro_torch.core.fault`` (the paper's C(t_c), the renewal variant,
  the t_c* search, the MLE fit);
* the **failure-scenario engine** — per-round failure processes (i.i.d. /
  Markov-bursty / Weibull-lifetime / straggler) selected by the runtime
  lane code ``FLConfig.fault_process`` (``repro_torch.fault.process``).
"""
from repro_torch.core.fault import (checkpoint_cost, fit_weibull,
                                    optimal_checkpoint_interval,
                                    recovery_overhead, weibull_failure_prob)
from repro_torch.fault.process import (PROCESSES, FaultState, arrival_score,
                                       fault_step, iid_fail_times,
                                       init_fault_state, process_code)

__all__ = [
    "PROCESSES", "FaultState", "arrival_score",
    "checkpoint_cost", "fault_step", "fit_weibull", "iid_fail_times",
    "init_fault_state", "optimal_checkpoint_interval", "process_code",
    "recovery_overhead", "weibull_failure_prob",
]
