"""Prompt rendering: (instruction, input, target) pattern -> chat text
(counterpart of ``aki_tpu/data/sft/templatizer.py``: the same texts).

Behavioral spec (``templates/templatizer.py:22-85``), single- and
multi-example:

    {SYSTEM_MESSAGE_ROLE} {instruction}
    <|user|>
    <image>
    {input}<|end|>
    <|assistant|>
    {target}

Randomness (pattern choice) takes an injectable ``random.Random`` so data
order is reproducible per (epoch, rank, worker) — the reference uses the
global ``random`` module seeded by the loader.
"""

from __future__ import annotations

import random as _random

from .templates import AI, END, HUMAN, IMAGE_PROMPT, SYSTEM_MESSAGE_ROLE, Template


def join(items, sep):
    return sep.join([i for i in items if i])


def templatize_single(pattern, ex, image_prompt=None):
    inputs = pattern[1].format(**ex)
    targets = pattern[2].format(**ex)
    if image_prompt is not None:
        inputs = inputs + END
    else:
        inputs = HUMAN + inputs + END
    targets = AI + targets
    return "\n".join([inputs, targets])


def templatize(pattern, examples, image_prompt=IMAGE_PROMPT):
    instruction = join([SYSTEM_MESSAGE_ROLE, pattern[0]], " ")
    inputs_targets = [
        templatize_single(pattern, ex, image_prompt=image_prompt)
        for ex in examples
    ]
    return join([instruction, image_prompt, *inputs_targets], "\n")


class Templatizer:
    @classmethod
    def from_names(cls, template_name: str, dataset_name: str,
                   rng: _random.Random | None = None):
        patterns = Template.get(template_name).get_pattern(dataset_name)
        if patterns is None:
            return None
        return cls(patterns, rng=rng)

    def __init__(self, patterns, defaults=None, rng: _random.Random | None = None):
        self.patterns = patterns
        self.defaults = defaults or {}
        self.rng = rng or _random

    def __call__(self, examples, image_prompt=IMAGE_PROMPT):
        if self.defaults:
            examples = [self.defaults | ex for ex in examples]
        pattern = self.rng.choice(self.patterns)
        return templatize(pattern, examples, image_prompt=image_prompt)
