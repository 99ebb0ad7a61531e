"""Logging and per-read tracing (host)."""
