"""Benchmark orchestration: config, experiments, evaluation, reports."""
