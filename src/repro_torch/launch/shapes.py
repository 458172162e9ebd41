"""Assigned input-shape cells and ``input_specs`` (tensors on ``meta``).

Counterpart of ``repro/launch/shapes.py``.  Four shapes per LM arch:
  train_4k     seq 4096,   global_batch 256   -> train_step
  prefill_32k  seq 32768,  global_batch 32    -> prefill_step
  decode_32k   kv 32768,   global_batch 128   -> serve (decode) step
  long_500k    kv 524288,  global_batch 1     -> serve step, SSM/hybrid only

Skips:
  * long_500k for pure full-attention archs (quadratic prefill);
  * decode_32k / long_500k for encoder-only (hubert).

``input_specs`` gives tensors on the ``meta`` device (shape and type, no
storage) where the reference gives ``jax.ShapeDtypeStruct``s; token ids
are int32, as there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def skip_reason(cfg: ArchConfig, shape: str) -> Optional[str]:
    cell = SHAPES[shape]
    if cell.kind == "decode" and not cfg.has_decoder:
        return "encoder-only arch: no autoregressive decode step"
    if shape == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention arch: long_500k requires sub-quadratic "
                "context (run for SSM/hybrid only per assignment)")
    return None


def runnable_cells(cfg: ArchConfig):
    return [s for s in SHAPES if skip_reason(cfg, s) is None]


def input_specs(cfg: ArchConfig, shape: str) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of this cell: token ids
    (B, S) int32, or (B, S, d) embeddings in the config's type for a stub
    frontend; labels (B, S) int32 for training; one new token a sequence
    for decode."""
    cell = SHAPES[shape]
    B, S = cell.global_batch, cell.seq_len
    tok_dtype = torch.int32

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if cfg.embedding_frontend == "stub_embeddings":
        def tokens(b, s):
            return meta((b, s, cfg.d_model), getattr(torch, cfg.dtype))
    else:
        def tokens(b, s):
            return meta((b, s), tok_dtype)

    if cell.kind == "train":
        return {"inputs": tokens(B, S), "labels": meta((B, S), tok_dtype)}
    if cell.kind == "prefill":
        return {"inputs": tokens(B, S)}
    # decode: one new token against a KV/state cache of length S
    return {"tokens": tokens(B, 1)}


def tokens_per_step(cfg: ArchConfig, shape: str) -> int:
    cell = SHAPES[shape]
    if cell.kind == "train":
        return cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return cell.global_batch * cell.seq_len
    return cell.global_batch      # decode: 1 token per sequence
