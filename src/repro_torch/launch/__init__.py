"""Counterpart of the reference package's launch subpackage: ``serve``
(``prefill_scan`` and the batched decode CLI)."""
