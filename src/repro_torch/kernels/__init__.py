"""Counterpart of the reference package's kernels subpackage."""
