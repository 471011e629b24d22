"""Benchmark scripts: `python -m benchmarks.<name>` from the repo root."""
