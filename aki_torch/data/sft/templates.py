"""Chat template constants and per-task prompt patterns (counterpart of
``aki_tpu/data/sft/templates.py``, which the port does not import).

These strings are *behavioral constants* of the trained AKI checkpoint —
they must match the reference byte-for-byte or tokenization (and therefore
eval accuracy) drifts.  Source: the active (uncommented) patterns of
``train/sft_data_utils/templates/templates.py`` (Phi-3.5 chat format:
``<|system|>...<|end|>``, ``<|user|>\n``, ``<|assistant|>\n``).
"""

from __future__ import annotations

SYSTEM_BASE = "A chat between a curious user and an artificial intelligence assistant."
SYSTEM_DETAIL = (
    "The assistant gives helpful, detailed, and polite answers to the user's questions."
)
SYSTEM_MESSAGE = SYSTEM_BASE + " " + SYSTEM_DETAIL
SYSTEM_MESSAGE_ROLE = "<|system|>" + "\n" + SYSTEM_MESSAGE + "<|end|>"

IMAGE = "<image>"
END = "<|end|>"
HUMAN = "<|user|>\n"
AI = "<|assistant|>\n"

ROLE_PATTERNS = {
    "human": f"\n{HUMAN}",
    "user": f"\n{HUMAN}",
    "\n[|Human|] ": f"\n{HUMAN}",
    "gpt": f"\n{AI}",
    "\n[|Assistant|] ": f"\n{AI}",
}
MEDIA_TOKENS = {"image": [IMAGE]}

IGNORE_INDEX = -100

IMAGE_PROMPT = HUMAN + IMAGE

# (instruction, input, target) triples per task pattern — active patterns
# only (templates.py:44-111).
PATTERN_DICT: dict[str, list[tuple[str, str, str]]] = {
    "captioning": [("[NO_PROMPT]", "", "{caption}")],
    "vqa": [
        ("", "Answer the question using a single word or phrase. {question}",
         "{answer}"),
    ],
    "gqa": [
        ("", "Answer the question using a single word or phrase. {question}",
         "{answer}"),
    ],
    "vqa-o": [
        ("", "Answer with the option's letter from the given choices directly."
             " {question}\nOptions:\n{option}\n", "{answer}"),
    ],
    "scienceqa": [
        ("", "Answer with the option's letter from the given choices directly."
             " {question}\nContext: {context}\nOptions:\n{option}\n",
         "{answer}"),
    ],
    "loc": [
        ("", "Provide a short description for this region. {bbox}", "{phrase}"),
    ],
    "vsr": [
        ("", "Answer the question using a single word or phrase."
             " {question_interro} Please answer yes or no.", "{answer}"),
    ],
    "kvqa": [
        ("", "Answer the question using a single word or phrase. {question}",
         "{answer}"),
    ],
    "refcoco": [
        ("", "Provide a short description for this region. {bbox}", "{phrase}"),
    ],
    "refcocop": [
        ("", "Provide a short description for this region. {bbox}", "{phrase}"),
    ],
    "refcocog": [
        ("", "Provide a short description for this region. {bbox}", "{phrase}"),
    ],
    # evaluation prompts
    "mme": [("", "Answer the question using a single word or phrase. {question}", "")],
    "mmb": [("", "Answer with the option's letter from the given choices directly."
                 " {question}", "")],
    "eval-vqa": [("", "Answer the question using a single word or phrase."
                      " {question}", "")],
    "eval-sqa": [
        ("", "Answer with the option's letter from the given choices directly."
             " {question}\nContext: {context}\nThere are several options:\n{option}\n",
         "")
    ],
    "eval-refexploc": [
        ("", "Provide the bounding box coordinate of the region this sentence"
             " describes. {phrase}", "")
    ],
    "eval-vsr": [
        ("", "Answer the question using a single word or phrase."
             " {question_interro} Please answer yes or no.", "")
    ],
}

PATTERN_MAP = {
    "vqa": ["vqa", "vgqa", "ocrvqa", "okvqa"],
    "vqa-o": ["aokvqa"],
    "vsr": ["vsr"],
    "kvqa": ["kvqa"],
    "loc": ["vg", "refexploc"],
    "captioning": ["coyo100m", "blip", "textcaps"],
}


class Template:
    """Named pattern registry (templates.py:149-180)."""

    _registry: dict[str, "Template"] = {}

    def __init__(self, pattern_dict, pattern_map):
        self.pattern_dict = pattern_dict
        self.data2pattern = {
            dset: pat for pat, dsets in pattern_map.items() for dset in dsets
        }

    def get_pattern(self, dset_name: str):
        if dset_name in self.data2pattern:
            return self.pattern_dict[self.data2pattern[dset_name]]
        return self.pattern_dict.get(dset_name)

    @classmethod
    def register(cls, name, pattern_dict, pattern_map):
        cls._registry[name] = cls(pattern_dict, pattern_map)

    @classmethod
    def get(cls, name) -> "Template":
        return cls._registry[str(name)]


Template.register("default", PATTERN_DICT, PATTERN_MAP)
