"""Tokenizers (counterpart of ``aki_tpu/data/tokenizer.py``, which the port
does not import).

The reference loads the Phi-3.5 SentencePiece tokenizer with
``use_fast=False``, ensures bos/eos, adds ``<pad>`` if missing, then
registers ``<image>`` and ``<|endofchunk|>`` as additional special tokens
(``src/factory.py:98-123, 140-150``). :class:`HFTokenizer` mirrors that and
imports ``transformers`` only when it is built, so importing this module
needs neither ``transformers`` nor ``sentencepiece``. :class:`HashTokenizer`
is a dependency-free stand-in with the same interface and special-token
layout, id for id and string for string the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re

MEDIA_TOKEN = "<image>"
END_OF_CHUNK_TOKEN = "<|endofchunk|>"
ASSISTANT_TOKEN = "<|assistant|>"
USER_TOKEN = "<|user|>"
SYSTEM_TOKEN = "<|system|>"
END_TOKEN = "<|end|>"
PAD_TOKEN = "<pad>"
BOS_TOKEN = "<s>"
EOS_TOKEN = "</s>"


@dataclasses.dataclass
class TokenizerInfo:
    vocab_size: int            # includes framework tokens
    initial_len: int           # vocab before <image>/<|endofchunk|>
    pad_id: int
    bos_id: int
    eos_id: int
    media_id: int
    end_of_chunk_id: int
    assistant_id: int
    user_id: int
    system_id: int
    end_id: int


class HFTokenizer:
    """Wraps a local HF tokenizer directory (SentencePiece slow tokenizer,
    ``use_fast=False`` like the reference factory; ``use_fast=True`` is the
    fallback for environments without sentencepiece — same id layout, the
    fast backend handles added specials identically)."""

    def __init__(self, path: str, use_fast: bool = False):
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(path, use_fast=use_fast,
                                            local_files_only=True)
        # reference guarantees (factory.py:107-109, 118-123): a DEDICATED
        # pad token is added when pad is missing OR aliases eos — Phi-3.5's
        # tokenizer_config sets pad == eos == <|endoftext|>, and the
        # released checkpoint was trained with the extra <pad> row
        # (pad_id=32011, initial_tokenizer_len=32012). Only checking `is
        # None` would shift the whole decoupled-vocab layout by one.
        if tok.pad_token is None or tok.pad_token == tok.eos_token:
            tok.add_special_tokens({"pad_token": PAD_TOKEN})
        initial_len = len(tok)
        tok.add_special_tokens(
            {"additional_special_tokens": [MEDIA_TOKEN, END_OF_CHUNK_TOKEN]}
        )
        self.tok = tok
        self._initial_len = initial_len

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = self.tok.encode(text, add_special_tokens=False)
        if add_bos:
            ids = [self.tok.bos_token_id] + ids
        return ids

    def decode(self, ids) -> str:
        return self.tok.decode(ids, skip_special_tokens=True)

    def token_id(self, token: str) -> int:
        return self.tok.convert_tokens_to_ids(token)

    @property
    def info(self) -> TokenizerInfo:
        t = self.tok
        return TokenizerInfo(
            vocab_size=len(t),
            initial_len=self._initial_len,
            pad_id=t.pad_token_id,
            bos_id=t.bos_token_id,
            eos_id=t.eos_token_id,
            media_id=self.token_id(MEDIA_TOKEN),
            end_of_chunk_id=self.token_id(END_OF_CHUNK_TOKEN),
            assistant_id=self.token_id(ASSISTANT_TOKEN),
            user_id=self.token_id(USER_TOKEN),
            system_id=self.token_id(SYSTEM_TOKEN),
            end_id=self.token_id(END_TOKEN),
        )


class HashTokenizer:
    """Deterministic whitespace+hash tokenizer with the real special-token
    layout. NOT a language tokenizer — a fixture with the same interface."""

    SPECIALS = [
        PAD_TOKEN, BOS_TOKEN, EOS_TOKEN, SYSTEM_TOKEN, USER_TOKEN,
        ASSISTANT_TOKEN, END_TOKEN,
    ]

    def __init__(self, vocab_size: int = 512):
        assert vocab_size > len(self.SPECIALS) + 16
        self._special = {s: i for i, s in enumerate(self.SPECIALS)}
        self._initial_len = vocab_size - 2
        self._media_id = self._initial_len
        self._eoc_id = self._initial_len + 1
        self.vocab_size = vocab_size

    def _word_id(self, w: str) -> int:
        lo = len(self.SPECIALS)
        hi = self._initial_len
        h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
        return lo + (h % (hi - lo))

    # Special tokens split even without surrounding whitespace, like a real
    # SentencePiece tokenizer with added special tokens ("<image>cap" must
    # tokenize to [media, cap] — the reference templates have no spaces,
    # data.py:80-82, 185-195).
    _SPECIAL_RE = re.compile(
        "(" + "|".join(re.escape(t) for t in
                       [MEDIA_TOKEN, END_OF_CHUNK_TOKEN, ASSISTANT_TOKEN,
                        USER_TOKEN, SYSTEM_TOKEN, END_TOKEN, PAD_TOKEN,
                        BOS_TOKEN, EOS_TOKEN]) + ")"
    )

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = [self._special[BOS_TOKEN]] if add_bos else []
        for piece in self._SPECIAL_RE.split(text):
            if not piece:
                continue
            if piece == MEDIA_TOKEN:
                ids.append(self._media_id)
            elif piece == END_OF_CHUNK_TOKEN:
                ids.append(self._eoc_id)
            elif piece in self._special:
                ids.append(self._special[piece])
            else:
                for chunk in piece.replace("\n", " \\n ").split(" "):
                    if chunk:
                        ids.append(self._word_id(chunk))
        return ids

    def decode(self, ids) -> str:
        inv = {v: k for k, v in self._special.items()}
        out = []
        for i in ids:
            i = int(i)
            if i == self._media_id:
                out.append(MEDIA_TOKEN)
            elif i == self._eoc_id:
                out.append(END_OF_CHUNK_TOKEN)
            else:
                out.append(inv.get(i, f"<{i}>"))
        return " ".join(out)

    def token_id(self, token: str) -> int:
        if token == MEDIA_TOKEN:
            return self._media_id
        if token == END_OF_CHUNK_TOKEN:
            return self._eoc_id
        return self._special[token]

    @property
    def info(self) -> TokenizerInfo:
        return TokenizerInfo(
            vocab_size=self.vocab_size,
            initial_len=self._initial_len,
            pad_id=self._special[PAD_TOKEN],
            bos_id=self._special[BOS_TOKEN],
            eos_id=self._special[EOS_TOKEN],
            media_id=self._media_id,
            end_of_chunk_id=self._eoc_id,
            assistant_id=self._special[ASSISTANT_TOKEN],
            user_id=self._special[USER_TOKEN],
            system_id=self._special[SYSTEM_TOKEN],
            end_id=self._special[END_TOKEN],
        )


def train_encode(tokenizer, text: str, max_length: int) -> list[int]:
    """``[bos] + body + [eos]`` with HF's truncate-then-add-specials
    semantics.

    The reference factory sets ``add_bos_token = add_eos_token = True``
    (factory.py:108-110), so every *training* tokenization (paired,
    interleaved, SFT) brackets the text with bos/eos, and HF truncation
    reserves room for both specials (body truncated to max_length - 2).
    Eval/demo paths use ``add_special_tokens=False`` instead
    (eval_cv_bench/eval.py:81, local_demo.py:69) — no bos, no eos.
    """
    body = tokenizer.encode(text)
    body = body[: max_length - 2]
    return [tokenizer.info.bos_id] + body + [tokenizer.info.eos_id]


def load_tokenizer(path: str | None = None, vocab_size: int = 512):
    """HF tokenizer when a local path is given, hash fixture otherwise."""
    if path:
        return HFTokenizer(path)
    return HashTokenizer(vocab_size)
