"""Counterpart of the reference package's train subpackage."""
