"""Model zoo of the port: dense GQA transformers, MoE (GQA or MLA
attention), RWKV-6 and the Mamba-2 hybrid.

Counterpart of ``repro.models``.
"""
from repro_torch.models.model import (init_params, init_params_abstract,
                                      forward, loss_fn, init_decode_state,
                                      decode_step, DecodeState)
