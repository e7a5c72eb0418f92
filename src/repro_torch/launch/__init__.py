"""Counterpart of the reference package's launch subpackage: ``serve``
(``prefill_scan`` and the batched decode CLI), ``fl_train`` (the paper's
FL CLI over ``run_fl``), ``train`` (federated LM training over the
``client_serial`` plan) and ``steps`` (the execution-profile policy)."""
