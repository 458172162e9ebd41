"""The benchmark of ``repro_torch`` (the PyTorch and CUDA port).

``portbench/run.py`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line.  What belongs to one configuration, traffic mix,
per-layer metric, plain reference or cell's limits is a file of its own,
found by the name ``BENCHMARK.json`` gives it:

    configs/<config>.json      sizes as run, source, departures, weight draws
    traffic/<traffic>.json     the parameters the one generator reads
    metrics/<metric>.py        ``read(run)``: one per-layer metric, or None
    reference/<family>.py      the plain float32 forward and its step FLOPs
    limits/<cell>.json         the limits of the comparison that decides
                               ``correct``, with the readings they came from

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package.
"""
