"""Analysis layer of the port: the card's roofline model, the measured
cost model and tuning cache behind dispatch, and the operation census
(counterparts of ``repro.analysis``'s ``roofline``, ``autotune`` and
``hlo``)."""
from repro_torch.analysis import autotune, op_census, roofline

__all__ = ["autotune", "op_census", "roofline"]
