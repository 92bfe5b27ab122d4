"""Caption helpers the prompt builder needs (own copy of the parts of
dcr_tpu/data/captions.py that sampling reads)."""

from __future__ import annotations

import numpy as np

IMAGENETTE_CLASSES = (
    "tench", "English springer", "cassette player", "chain saw", "church",
    "French horn", "garbage truck", "gas pump", "golf ball", "parachute",
)


def insert_rand_word(sentence: str, word: str, rng: np.random.Generator) -> str:
    """Insert `word` at a random position (reference datasets.py:154-159)."""
    words = sentence.split(" ")
    pos = int(rng.integers(0, len(words) + 1))
    words.insert(pos, word)
    return " ".join(words)
