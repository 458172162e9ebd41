"""Model zoo of the port: dense GQA transformers, MoE (GQA or MLA
attention), RWKV-6 and the Mamba-2 hybrid.

Counterpart of ``repro.models``; ``loss_fn`` and ``init_params_abstract``
come with the training slice (ROADMAP A.12b).
"""
from repro_torch.models.model import (init_params, forward, init_decode_state,
                                      decode_step, DecodeState)
