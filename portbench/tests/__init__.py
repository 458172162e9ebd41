"""Tests of the benchmark (CPU, and ``cuda``-marked ones for the card)."""
