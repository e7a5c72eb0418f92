"""Counterpart of the reference package's fault subpackage."""
