"""Caption assignment per conditioning regime + train-time caption mitigations.

Own copy of ``dcr_tpu/data/captions.py`` (the reference's caption logic,
datasets.py:100-142), with every random choice drawn from an explicit
per-sample ``np.random.Generator``, so a caption is a pure function of
(spec, sample, rng state) and agrees with the JAX package's bit for bit.

Conditioning regimes (diff_train.py:90-96):
  nolevel               constant prompt ("An image")
  classlevel            "An image of {classname}"
  instancelevel_blip    per-image BLIP caption list (json), first entry
  instancelevel_ogcap   per-image original caption (json)
  instancelevel_random  caption stored as a token-id list, decoded via tokenizer

Under dup_image, duplicated samples (weight > 1) draw a random caption from
the image's list instead of the first (datasets.py:133-139).

Train-time mitigations (datasets.py:100-125, arXiv:2305.20086 §5):
  allcaps      always sample a random caption from the image's list
  randrepl     with prob p replace the whole caption by 4 random tokens, decoded
  randwordadd  with prob p insert 2 random-token words at random positions
  wordrepeat   with prob p re-insert 2 words already present at random positions
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

import numpy as np

from dcr_tpu_torch.data.tokenizer import TokenizerBase

# Imagenette class names (reference datasets.py:25-29)
IMAGENETTE_CLASSES = (
    "tench", "English springer", "cassette player", "chain saw", "church",
    "French horn", "garbage truck", "gas pump", "golf ball", "parachute",
)
IMAGENETTE_2CLASS = ("church", "garbage truck")


def get_classnames(dataset_path: str) -> tuple[str, ...]:
    if "imagenette_2class" in str(dataset_path):
        return IMAGENETTE_2CLASS
    return IMAGENETTE_CLASSES


def insert_rand_word(sentence: str, word: str, rng: np.random.Generator) -> str:
    """Insert `word` at a random position (reference datasets.py:154-159)."""
    words = sentence.split(" ")
    pos = int(rng.integers(0, len(words) + 1))
    words.insert(pos, word)
    return " ".join(words)


@dataclass(frozen=True)
class CaptionSpec:
    class_prompt: str                      # conditioning regime
    duplication: str = "nodup"
    instance_prompt: str = "An image"      # nolevel text
    trainspecial: Optional[str] = None     # mitigation or None/"none"
    trainspecial_prob: float = 0.1
    rand_token_high: int = 49400           # reference uses randint(49400)


def _mitigated_caption(spec: CaptionSpec, special: str, caps: Sequence[str],
                       tokenizer: TokenizerBase, rng: np.random.Generator) -> str:
    if special == "allcaps":
        return str(caps[int(rng.integers(0, len(caps)))])
    caption = str(caps[0])
    if float(rng.uniform()) > spec.trainspecial_prob:
        return caption
    if special == "randrepl":
        ids = [int(i) for i in rng.integers(0, spec.rand_token_high, size=4)]
        return tokenizer.decode(ids)
    if special == "randwordadd":
        for _ in range(2):
            word = tokenizer.decode([int(rng.integers(0, spec.rand_token_high))])
            caption = insert_rand_word(caption, word, rng)
        return caption
    if special == "wordrepeat":
        words = caption.split(" ")
        for _ in range(2):
            word = str(words[int(rng.integers(0, len(words)))])
            caption = insert_rand_word(caption, word, rng)
        return caption
    raise ValueError(f"unknown trainspecial {special!r}")


def assign_caption(spec: CaptionSpec, *, path: str, label: int,
                   classnames: Sequence[str],
                   prompts: Optional[Mapping[str, Sequence[str]]],
                   sampling_weight: float,
                   tokenizer: TokenizerBase,
                   rng: np.random.Generator) -> str:
    """Produce the training caption for one sample (pure given rng state)."""
    special = spec.trainspecial if spec.trainspecial not in (None, "none") else None
    if special is not None:
        return _mitigated_caption(spec, special, prompts[path], tokenizer, rng)
    if spec.class_prompt == "nolevel":
        return spec.instance_prompt
    if spec.class_prompt == "classlevel":
        return f"An image of {classnames[label]}"
    if spec.class_prompt in ("instancelevel_blip", "instancelevel_random",
                             "instancelevel_ogcap"):
        caps = prompts[path]
        if spec.duplication == "dup_image" and sampling_weight > 1:
            caption = str(caps[int(rng.integers(0, len(caps)))])
        else:
            caption = str(caps[0])
        if spec.class_prompt == "instancelevel_random":
            # stored as a literal token-id list; decode through the tokenizer
            # (reference datasets.py:140-142)
            ids = ast.literal_eval(caption) if isinstance(caption, str) else caption
            caption = tokenizer.decode([int(i) for i in ids])
        return caption
    raise ValueError(f"unknown class_prompt {spec.class_prompt!r}")
