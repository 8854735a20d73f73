"""Observability of the ported training path."""
