"""Privacy accounting: the port's counterpart of the reference package's
privacy subpackage, exporting the same names.

* :mod:`repro_torch.privacy.accountant` — Rényi-DP accounting for the
  subsampled Gaussian mechanism: host-side f64 composition and
  calibration, and the in-loop :class:`AccountantState` carried through
  the sweep engine's round loop.
* :mod:`repro_torch.privacy.schedule` — budget schedulers (uniform /
  linear / adaptive) selected by a runtime lane code, and the
  stall-driven adaptive controller updated on eval boundaries.
"""
from repro_torch.privacy.accountant import (  # noqa: F401
    ORDERS, AccountantState, RdpAccountant, accountant_step,
    accounted_epsilon, compose_epsilon, composed_epsilon_rt,
    epsilon_from_state, init_accountant_state, noise_multiplier_for_budget,
    noise_multiplier_for_budget_rt, rdp_gaussian, rdp_increment,
    rdp_subsampled_gaussian, rdp_to_dp)
from repro_torch.privacy.schedule import (  # noqa: F401
    BOOST_FLOOR, SCHEDULES, SchedulerState, init_scheduler, schedule_code,
    scheduled_multiplier, scheduler_update)
