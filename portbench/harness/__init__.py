"""The benchmark's harness: cells, traces, counts and comparisons."""
