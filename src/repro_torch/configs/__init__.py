"""Workload configurations (published widths of the paper's datasets)."""
