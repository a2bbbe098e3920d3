"""Observability for the port: only the shared clock so far (tracing and
metrics are ROADMAP queue 1 item 13)."""
