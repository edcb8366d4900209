"""Run-time counters."""
