"""Prompt-list construction per conditioning style + inference-time augmentations.

Own copy of dcr_tpu/sampling/prompts.py: the same seeded streams give the
same prompt lists, bit for bit.

Behavioral port of diff_inference.py:121-176 and the shared prompt_augmentation
helper (diff_inference.py:14-30 == sd_mitigation.py:14-30 — deduplicated here):

- nolevel: the constant prompt, repeated
- classlevel: seeded choice over the Imagenette class templates
- instancelevel_blip / instancelevel_ogcap: seeded choice over first captions
  from the caption json
- instancelevel_random: same, then token-id literal decoded via the tokenizer
- augmentations (mitigations): rand_numb_add / rand_word_add / rand_word_repeat,
  each inserting `repeat_num` tokens at random positions
"""

from __future__ import annotations

import ast
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from dcr_tpu_torch.core.rng import host_python_rng
from dcr_tpu_torch.data.captions import IMAGENETTE_CLASSES, insert_rand_word
from dcr_tpu_torch.data.tokenizer import TokenizerBase


def prompt_augmentation(prompt: str, aug_style: str, *, tokenizer: TokenizerBase,
                        rng: np.random.Generator, repeat_num: int = 2,
                        rand_token_high: int = 49400) -> str:
    if aug_style == "rand_numb_add":
        for _ in range(repeat_num):
            prompt = insert_rand_word(prompt, str(int(rng.integers(0, 100000))), rng)
    elif aug_style == "rand_word_add":
        for _ in range(repeat_num):
            word = tokenizer.decode([int(rng.integers(0, rand_token_high))])
            prompt = insert_rand_word(prompt, word, rng)
    elif aug_style == "rand_word_repeat":
        words = prompt.split(" ")
        for _ in range(repeat_num):
            word = str(words[int(rng.integers(0, len(words)))])
            prompt = insert_rand_word(prompt, word, rng)
    else:
        raise ValueError(f"unknown prompt augmentation {aug_style!r}")
    return prompt


def sample_caption_prompts(caption_lists: Sequence[Sequence[str]], style: str,
                           count: int, *, seed: int,
                           tokenizer: TokenizerBase,
                           stream: str = "prompt_list") -> list[str]:
    """`count` seeded draws over the FIRST caption of each image's caption
    list (reference semantics: choicelist = [x[0] for x in prompts.values()],
    diff_train.py:462-463); instancelevel_random entries are token-id
    literals decoded through the tokenizer. Shared by the inference prompt
    builder and the in-training sample-grid hook."""
    choicelist = [str(caps[0]) for caps in caption_lists if caps]
    if not choicelist:
        raise ValueError("no captions to sample prompts from")
    rng = host_python_rng(seed, stream)
    # draws are WITH replacement (reference np.random.choice), so count may
    # exceed the table size
    picks = [choicelist[int(i)]
             for i in rng.integers(0, len(choicelist), size=count)]
    if style == "instancelevel_random":
        picks = [tokenizer.decode([int(t) for t in ast.literal_eval(p)])
                 for p in picks]
    return picks


def build_prompt_list(style: str, count: int, *, seed: int,
                      tokenizer: TokenizerBase,
                      instance_prompt: str = "An image",
                      classnames: Sequence[str] = IMAGENETTE_CLASSES,
                      caption_json: Optional[str | Path] = None,
                      rand_augs: Optional[str] = None,
                      rand_aug_repeats: int = 2) -> list[str]:
    rng = host_python_rng(seed, "prompt_list")
    if style == "nolevel":
        prompts = [instance_prompt] * count
    elif style == "classlevel":
        prompts = [f"An image of {classnames[i]}"
                   for i in rng.integers(0, len(classnames), size=count)]
    elif style in ("instancelevel_blip", "instancelevel_random", "instancelevel_ogcap"):
        if caption_json is None:
            raise ValueError(f"{style} needs a caption_json")
        table = json.loads(Path(caption_json).read_text())
        # fresh "prompt_list" stream == the draw sequence this branch always
        # used (rng above is untouched before this point)
        prompts = sample_caption_prompts(list(table.values()), style, count,
                                         seed=seed, tokenizer=tokenizer)
    else:
        raise ValueError(f"unknown conditioning style {style!r}")

    if rand_augs and rand_augs != "none":
        if style != "instancelevel_blip":
            # reference invariant (diff_inference.py:241-242)
            raise ValueError("prompt augmentations require instancelevel_blip prompts")
        aug_rng = host_python_rng(seed, "prompt_augs")
        prompts = [prompt_augmentation(p, rand_augs, tokenizer=tokenizer,
                                       rng=aug_rng, repeat_num=rand_aug_repeats)
                   for p in prompts]
    return prompts


def save_prompts(prompts: Sequence[str], savepath: str | Path) -> Path:
    """prompts.txt next to generations/ (reference diff_inference.py:179-181);
    eval's SynthDataset reads it back."""
    path = Path(savepath) / "prompts.txt"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(f"{p}\n" for p in prompts))
    return path
