"""Model zoo of the port: dense GQA transformers and RWKV-6.

Counterpart of ``repro.models`` for the families the port serves so far;
``loss_fn`` and ``init_params_abstract`` come with the training slice, MoE,
MLA and Mamba-2 with theirs (ROADMAP A.12).
"""
from repro_torch.models.model import (init_params, forward, init_decode_state,
                                      decode_step, DecodeState)
