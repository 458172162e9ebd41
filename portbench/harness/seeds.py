"""Independent streams drawn from one ``--seed`` (any whole number,
negative or past 64 bits too): each purpose names a tag, and the stream's
seed is a hash of the seed and the tag."""
from __future__ import annotations

import hashlib
import random

import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for the stream ``tag``."""
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def host_rng(seed: int, tag: str) -> random.Random:
    """A host-side generator for the stream ``tag``."""
    return random.Random(derive(seed, tag))
