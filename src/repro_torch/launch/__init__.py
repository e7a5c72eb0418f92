"""Counterpart of the reference package's launch subpackage: ``serve``
(``prefill_scan`` and the batched decode CLI) and ``fl_train`` (the
paper's FL CLI over ``run_fl``)."""
