"""Utilities: profiling/tracing, heartbeat/failure detection."""
