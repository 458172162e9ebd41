"""The general code of the benchmark: resolving a cell by name, drawing
weights and prompts from the seed, the closed-loop window, the reduction
of a profiler trace, and the comparison that decides ``correct``."""
