"""Continuous-batching serving engine (vLLM-style scheduling).

Counterpart of ``repro/runtime/serving.py``, reproducing the JAX engine
token for token:

  * a **slot-based KV cache**: the decode batch is a fixed-capacity tensor
    batch of ``num_slots`` rows; requests claim and release slots;
  * **continuous batching**: finished requests release their slot at once
    and queued requests are admitted without stopping decode;
  * **chunked prefill**: prompts enter through the decode path one token a
    tick (the full-prompt prefill is ``make_prefill_step``);
  * per-request state (queued → prefill → decode → done) and scheduler
    metrics (steps, tokens, slot occupancy).

The batch shape never changes, so a request's tokens do not depend on what
else is in the batch.  Like the reference, every tick writes all slots at
one shared index, ``max`` of the active slots' positions: a request
admitted into a released slot mid-run starts at that index and its
attention also sees the previous occupant's cache rows below it.  The
port keeps this behaviour (ROADMAP §C) rather than change the result.

The engine runs on its parameters' device; ``decode_step`` returns new
cache tensors each tick and ``_merge_slot``, mapped over the cache pytree
(a tuple, or the hybrid's dict of tuples), keeps the inactive slots'
previous contents, as the reference's jitted step does.  Like the
reference, a slot handed to a new request keeps its previous occupant's
recurrent state (RWKV, Mamba) and cache rows (KV, MLA latent).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as mdl


@dataclasses.dataclass
class Request:
    """One LM decode request and its scheduling lifecycle state."""
    uid: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int
    state: str = "queued"           # queued|prefill|decode|done
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    prefill_pos: int = 0
    enqueue_t: float = 0.0
    finish_t: float = 0.0


class ContinuousBatchingEngine:
    """Fixed-slot continuous batching over ``decode_step``, on the device
    of ``params`` (the port's ``init_params`` puts them on ``cuda`` unless
    told otherwise)."""

    def __init__(self, cfg: ArchConfig, params, num_slots: int = 8,
                 max_len: int = 256, eos_token: Optional[int] = None):
        if not cfg.has_decoder:
            raise ValueError(f"{cfg.name} is encoder-only")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["tok"].device
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos = eos_token
        self.state = mdl.init_decode_state(cfg, num_slots, max_len,
                                           device=self.device)
        # per-slot write position (the shared DecodeState.index is re-derived
        # from these every tick)
        self.slot_pos = np.zeros(num_slots, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self.queue: "collections.deque[Request]" = collections.deque()
        self.done: List[Request] = []
        self._uid = 0
        self.metrics = {"steps": 0, "tokens": 0, "occupancy_sum": 0.0}

    def _step(self, state, tokens, slot_mask):
        """decode_step, then frozen slots keep their previous caches."""
        with torch.no_grad():
            logits, new_state = mdl.decode_step(self.params, self.cfg,
                                                state, tokens)
            merged = pytree.tree_map(
                lambda n, o: _merge_slot(n, o, slot_mask),
                new_state.caches, state.caches)
        return logits, mdl.DecodeState(caches=merged, index=new_state.index)

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        """Enqueue a prompt; returns the request uid."""
        req = Request(uid=self._uid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens,
                      enqueue_t=time.perf_counter())
        self._uid += 1
        self.queue.append(req)
        return req.uid

    def _admit(self):
        for slot in range(self.num_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.popleft()
                req.state = "prefill"
                req.slot = slot
                req.prefill_pos = 0
                self.slot_pos[slot] = 0
                self.slot_req[slot] = req

    # -- one engine tick -----------------------------------------------------

    def step(self):
        """One batched decode step across all active slots."""
        self._admit()
        active = [r for r in self.slot_req if r is not None]
        if not active:
            return False

        tokens = np.zeros((self.num_slots, 1), np.int32)
        mask = np.zeros((self.num_slots,), bool)
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            mask[slot] = True
            if req.state == "prefill":
                tokens[slot, 0] = req.prompt[req.prefill_pos]
            else:
                tokens[slot, 0] = req.generated[-1]

        # one shared write index for the batch: the largest active position
        idx = int(np.max(self.slot_pos[mask])) if mask.any() else 0
        state = mdl.DecodeState(caches=self.state.caches, index=idx)
        logits, self.state = self._step(
            state, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(mask).to(self.device))
        next_tok = logits[:, -1].argmax(dim=-1).cpu().numpy()

        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.slot_pos[slot] += 1
            if req.state == "prefill":
                req.prefill_pos += 1
                if req.prefill_pos >= len(req.prompt):
                    req.state = "decode"
                    req.generated.append(int(next_tok[slot]))
            else:
                req.generated.append(int(next_tok[slot]))
            full = len(req.generated) >= req.max_new_tokens
            eos = self.eos is not None and req.generated and \
                req.generated[-1] == self.eos
            over = self.slot_pos[slot] >= self.max_len - 1
            if req.state == "decode" and (full or eos or over):
                req.state = "done"
                req.finish_t = time.perf_counter()
                self.done.append(req)
                self.slot_req[slot] = None       # release immediately

        self.metrics["steps"] += 1
        self.metrics["tokens"] += int(mask.sum())
        self.metrics["occupancy_sum"] += float(mask.mean())
        return True

    def run_until_drained(self, max_steps: int = 10000):
        """Step until queue and slots drain; returns finished requests."""
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.done

    @property
    def occupancy(self) -> float:
        """Mean fraction of decode slots active per step."""
        if self.metrics["steps"] == 0:
            return 0.0
        return self.metrics["occupancy_sum"] / self.metrics["steps"]


def _merge_slot(new, old, slot_mask):
    """Select per slot between updated and previous cache entries.

    Cache leaves are stacked (L, B, ...) (the hybrid's shared-attention
    caches (n_shared, B, ...)): the slot axis is axis 1.  Leaves of fewer
    than two dimensions pass through."""
    if new.ndim < 2:
        return new
    shape = [1] * new.ndim
    shape[1] = slot_mask.shape[0]
    return torch.where(slot_mask.reshape(shape), new, old)
