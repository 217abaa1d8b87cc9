"""Cross-cutting utilities (tracing, timing)."""
