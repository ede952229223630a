"""The port's host-side data helpers against the JAX package's: the hash
tokenizer (ids, decode, info), the HF adapter on a small trained tokenizer,
image preprocessing (byte-equal arrays), the chat templates (byte-equal
strings) and ``config_for_tokenizer`` (field-equal)."""

import dataclasses
import io
import json

import numpy as np
import pytest

from aki_tpu.data import images as jax_images
from aki_tpu.data import tokenizer as jax_tok
from aki_tpu.data.sft import templates as jax_templates
from aki_tpu.infer import eval_cv_bench as jax_cv
from aki_tpu.infer import eval_yorn as jax_yorn
from aki_tpu.models import configs as jax_configs
from aki_torch.data import images, tokenizer
from aki_torch.data.sft import templates
from aki_torch.models import configs

PROMPTS = {
    "chat": f"<s> <|system|>\n{jax_templates.SYSTEM_MESSAGE}<|end|>\n<|user|>\n<image>\n"
            "What is in this image?<|end|>\n<|assistant|>\n",
    "cv_bench": jax_cv.render_prompt("Which object is closer to the camera?",
                                     ["the lamp", "the chair", "(C) the sofa"]),
    "yes_no": jax_yorn.render_prompt("Is there a dog in the image? Please answer yes or no."),
    "specials_without_spaces": "<s><image>cap<|endofchunk|></s><pad>x\ny  z",
}


@pytest.mark.parametrize("name", list(PROMPTS))
def test_hash_tokenizer_matches_jax(name):
    text = PROMPTS[name]
    want, got = jax_tok.HashTokenizer(), tokenizer.HashTokenizer()
    for add_bos in (False, True):
        assert got.encode(text, add_bos) == want.encode(text, add_bos)
    ids = want.encode(text) + [3, 500, 511, 510]
    assert got.decode(ids) == want.decode(ids)
    assert got.decode(np.asarray(ids, np.int64)) == want.decode(ids)
    assert dataclasses.asdict(got.info) == dataclasses.asdict(want.info)
    assert tokenizer.train_encode(got, text, 24) == jax_tok.train_encode(want, text, 24)
    for tok in tokenizer.HashTokenizer.SPECIALS + [tokenizer.MEDIA_TOKEN,
                                                   tokenizer.END_OF_CHUNK_TOKEN]:
        assert got.token_id(tok) == want.token_id(tok)


def test_load_tokenizer_and_constants():
    assert isinstance(tokenizer.load_tokenizer(None), tokenizer.HashTokenizer)
    assert tokenizer.load_tokenizer(None, 1024).vocab_size == 1024
    for name in ("MEDIA_TOKEN", "END_OF_CHUNK_TOKEN", "ASSISTANT_TOKEN", "USER_TOKEN",
                 "SYSTEM_TOKEN", "END_TOKEN", "PAD_TOKEN", "BOS_TOKEN", "EOS_TOKEN"):
        assert getattr(tokenizer, name) == getattr(jax_tok, name)


@pytest.fixture(scope="module")
def hf_tok_dir(tmp_path_factory):
    """A small byte-level BPE with Phi-3-style specials, saved HF-style
    (the fast backend: sentencepiece is not installed here)."""
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    d = tmp_path_factory.mktemp("hf_tok")
    tk = Tokenizer(models.BPE(unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    trainer = trainers.BpeTrainer(vocab_size=300, special_tokens=[
        "<unk>", "<s>", "</s>", "<|system|>", "<|user|>", "<|assistant|>", "<|end|>"])
    tk.train_from_iterator(["Answer with the option's letter from the given choices.",
                            "What is in this image? a cat on a mat"] * 8, trainer)
    tk.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>",
        "eos_token": "</s>", "unk_token": "<unk>"}))
    return str(d)


def test_hf_tokenizer_matches_jax(hf_tok_dir):
    want = jax_tok.HFTokenizer(hf_tok_dir, use_fast=True)
    got = tokenizer.HFTokenizer(hf_tok_dir, use_fast=True)
    assert dataclasses.asdict(got.info) == dataclasses.asdict(want.info)
    for text in PROMPTS.values():
        ids = got.encode(text, add_bos=True)
        assert ids == want.encode(text, add_bos=True)
        assert got.decode(ids) == want.decode(ids)


def _png(seed: int, size=(53, 41)):
    from PIL import Image

    rng = np.random.RandomState(seed)
    img = Image.fromarray(rng.randint(0, 256, size[::-1] + (3,), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["plain", "hflip", "random_resized_crop"])
def test_preprocess_matches_jax_bytewise(mode):
    data = _png(3)
    kw = {"plain": {}, "hflip": dict(hflip=True),
          "random_resized_crop": dict(hflip=True, random_resized_crop=True)}[mode]
    for seed in range(4):
        want = jax_images.preprocess(jax_images.decode_image(data), 28,
                                     rng=np.random.RandomState(seed), **kw)
        got = images.preprocess(images.decode_image(data), 28,
                                rng=np.random.RandomState(seed), **kw)
        assert got.dtype == want.dtype == np.float32 and got.shape == (28, 28, 3)
        assert got.tobytes() == want.tobytes()
    img = images.decode_image(_png(4, (9, 700)))   # the crop's center-crop fallback
    assert (images.preprocess(img, 16, np.random.RandomState(0), random_resized_crop=True)
            .tobytes() == jax_images.preprocess(jax_images.decode_image(_png(4, (9, 700))), 16,
                                                np.random.RandomState(0),
                                                random_resized_crop=True).tobytes())
    assert images.zero_image(28).tobytes() == jax_images.zero_image(28).tobytes()
    assert images.to_array(img).tobytes() == jax_images.to_array(img).tobytes()


def test_templates_are_byte_equal():
    for name in ("SYSTEM_BASE", "SYSTEM_DETAIL", "SYSTEM_MESSAGE", "SYSTEM_MESSAGE_ROLE",
                 "IMAGE", "END", "HUMAN", "AI", "ROLE_PATTERNS", "MEDIA_TOKENS",
                 "IGNORE_INDEX", "IMAGE_PROMPT", "PATTERN_DICT", "PATTERN_MAP"):
        assert getattr(templates, name) == getattr(jax_templates, name), name
    assert set(templates.Template._registry) == set(jax_templates.Template._registry)
    for name, want in jax_templates.Template._registry.items():
        got = templates.Template.get(name)
        assert got.pattern_dict == want.pattern_dict
        assert got.data2pattern == want.data2pattern
        for dset in list(want.data2pattern) + list(want.pattern_dict) + ["unknown"]:
            assert got.get_pattern(dset) == want.get_pattern(dset)


@pytest.mark.parametrize("geometry", ["aki_4b", "aki_tiny"])
def test_config_for_tokenizer_matches_jax(geometry):
    info = jax_tok.HashTokenizer().info
    base_j = getattr(jax_configs, geometry)(*([info.vocab_size] if geometry == "aki_tiny"
                                              else []))
    base = getattr(configs, geometry)(*([info.vocab_size] if geometry == "aki_tiny" else []))
    want = jax_configs.config_for_tokenizer(base_j, info)
    got = configs.config_for_tokenizer(base, tokenizer.HashTokenizer().info)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.output_vocab == want.output_vocab == info.vocab_size
