"""The port's config loader and training data layer against ``aki_tpu``'s on
the same synthetic files (made from a numpy seed): configs as equal dicts,
shard sample streams equal key for key and byte for byte in the same order
(native indexer and ``tarfile``), caption, interleaved and SFT batches
byte-equal through the multi-worker loader, and every SFT parser's records
equal. Shards come from the JAX tests' shard writers and from
``aki_torch.data.synthetic``."""

import random

import numpy as np
import pytest

from aki_tpu.configs import loader as jax_loader
from aki_tpu.data import interleaved as jax_interleaved
from aki_tpu.data import loader as jax_data_loader
from aki_tpu.data import native_tar as jax_native_tar
from aki_tpu.data import pretrain as jax_pretrain
from aki_tpu.data import tar_reader as jax_tar_reader
from aki_tpu.data.sft import parsers as jax_parsers
from aki_tpu.data.sft import pipeline as jax_sft
from aki_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from aki_torch.configs import loader
from aki_torch.data import interleaved, native_tar, pretrain, synthetic, tar_reader
from aki_torch.data import loader as data_loader
from aki_torch.data.sft import parsers
from aki_torch.data.sft import pipeline as sft
from aki_torch.data.tokenizer import HashTokenizer

from .test_pretrain_data import make_shard

OVERRIDES = {
    "pretrain": ["root=/x/y", "training.total_steps=7", "datasets.mmc4.type=interleaved",
                 "datasets.mmc4.shards=${root}/mmc4-{0..3}.tar", "mesh.fsdp=1",
                 "training.extra=[1, 2.5, null]"],
    "sft": ["root=/d", "training_config.max_length=64", "datasets.vqa.weight=2",
            "training_config.sampling_weights=[1, 2]"],
}


@pytest.mark.parametrize("name", ["pretrain", "sft"])
@pytest.mark.parametrize("with_overrides", [False, True])
def test_shipped_configs_equal_jax(name, with_overrides):
    ovs = OVERRIDES[name] if with_overrides else None
    want = jax_loader.load_config(f"aki_tpu/configs/{name}.yaml", ovs)
    got = loader.load_config(f"aki_torch/configs/{name}.yaml", ovs)
    assert got == want
    assert loader.load_config(f"aki_tpu/configs/{name}.yaml", ovs) == want
    if name == "sft":
        assert len(got.datasets) == 11 and got.datasets.vg.data_cfg.image_metadata_path \
            == f"{got.root}/vg/image_data.json"


def test_config_defaults_self_and_interpolation(tmp_path):
    (tmp_path / "grp").mkdir()
    (tmp_path / "grp" / "a.yaml").write_text("x: {p: '${root}/a', n: '${num}'}\nroot: /frag\n")
    (tmp_path / "base.yaml").write_text("num: 3\nlist: ['${root}', 2]\n")
    (tmp_path / "main.yaml").write_text(
        "defaults:\n  - base\n  - grp: a\n  - _self_\nroot: /r\ny: {z: '${x.p}/b'}\n")
    ovs = ["num=4", "new.deep.k=v", "x.q=${num}"]
    want = jax_loader.load_config(tmp_path / "main.yaml", ovs)
    got = loader.load_config(tmp_path / "main.yaml", ovs)
    assert got == want
    # one pass: a reference to a value that itself holds a reference stays
    # half resolved, in both packages
    assert got.x.n == 4 and got.y.z == "${root}/a/b" and got.get_path("new.deep.k") == "v"


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    paths = []
    for i in range(4):
        p = d / f"shard-{i:04d}.tar"
        make_shard(p, 5 + i, prefix=f"k{i}_")
        paths.append(str(p))
    tail = d / "tail.tar"
    make_shard(tail, 4, prefix="t", broken_tail=True)
    cut = d / "cut.tar"
    make_shard(cut, 6, prefix="c")
    cut.write_bytes(cut.read_bytes()[: cut.stat().st_size // 2])
    (d / "sizes.json").write_text('{"shard-0000.tar": 5, "shard-0001.tar": 6}')
    return paths, [str(tail), str(cut), f"pipe:cat {paths[0]}"]


STREAMS = [
    dict(shuffle_buffer=1),
    dict(shuffle_buffer=7, epoch=1, seed=3),
    dict(rank=1, world=2, worker=1, num_workers=2, shuffle_buffer=1),
    dict(rank=0, world=2, worker=0, num_workers=3, shuffle_buffer=3, seed=5),
    dict(resampled=True, epoch=2, shuffle_buffer=4),
    dict(shuffle_shards=False, shuffle_buffer=1),
]


@pytest.mark.parametrize("reader", ["native", "tarfile"])
def test_sample_streams_equal_jax(shards, monkeypatch, reader):
    if reader == "tarfile":
        monkeypatch.setattr(native_tar, "native_available", lambda: False)
        monkeypatch.setattr(jax_native_tar, "native_available", lambda: False)
    else:
        assert native_tar.reader() == "native"
    good, odd = shards
    for kw in STREAMS:
        for files in (good, good + odd):
            want = list(jax_tar_reader.shard_sample_stream(files, **kw))
            got = list(tar_reader.shard_sample_stream(files, **kw))
            assert got == want, kw
            assert got or kw.get("rank")
    for path in odd:
        assert list(tar_reader.iter_tar_samples(path)) == list(
            jax_tar_reader.iter_tar_samples(path))
    pattern = good[0].replace("shard-0000", "shard-{0000..0003}")
    assert tar_reader.expand_shards(pattern) == jax_tar_reader.expand_shards(pattern) == good
    assert tar_reader.dataset_size(pattern) == jax_tar_reader.dataset_size(pattern) == 11


def assert_batches_equal(got, want, fields):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in fields:
            a, b = getattr(g, f), getattr(w, f)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape, f
                assert a.tobytes() == b.tobytes(), f
            else:
                assert a == b, f


FIELDS = ("input_ids", "attn_valid", "labels", "images", "loss_weight")


def loaded(make_loader, batches_fn, cfg, tok, workers, epoch=0):
    def mk(w, n):
        return batches_fn(cfg, tok, epoch=epoch, worker=w, num_workers=n)
    return list(make_loader(mk, num_workers=workers))


@pytest.mark.parametrize("workers", [1, 2])
def test_caption_batches_equal_jax(shards, workers):
    good, odd = shards
    kw = dict(shards=good + odd[:2], batch_size=3, max_text_len=9, image_size=28,
              shuffle_buffer=5, seed=2, loss_multiplier=0.5)
    for extra in ({}, {"num_samples": 7}):
        want = loaded(jax_data_loader.make_loader, jax_pretrain.batches,
                      jax_pretrain.PretrainConfig(**kw, **extra), JaxHashTokenizer(), workers, 1)
        got = loaded(data_loader.make_loader, pretrain.batches,
                     pretrain.PretrainConfig(**kw, **extra), HashTokenizer(), workers, 1)
        assert_batches_equal(got, want, FIELDS)
    for name, raw in (("blip3_kale", b" a cat "), ("blip3_grounding_50m", b"[['a dog ', 1]]"),
                      ("blip3_ocr_200m", b'[0, {"text": " x y"}]'), ("cc3m", b"bad\xff")):
        assert pretrain.parse_caption({"txt": raw}, name) == jax_pretrain.parse_caption(
            {"txt": raw}, name)


@pytest.mark.parametrize("workers", [1, 2])
def test_interleaved_batches_equal_jax(tmp_path, workers):
    rng = np.random.RandomState(7)
    files = []
    for i in range(2):
        files.append(str(tmp_path / f"mmc4-{i}.tar"))
        synthetic.write_mmc4_shard(files[-1], 5, rng, images=(2, 5))
    kw = dict(shards=files, batch_size=2, max_tokens=48, image_size=28, max_num_images=3,
              shuffle_buffer=3, seed=1, loss_multiplier=2.0)
    want = loaded(jax_data_loader.make_loader, jax_interleaved.batches,
                  jax_interleaved.InterleavedConfig(**kw), JaxHashTokenizer(), workers)
    got = loaded(data_loader.make_loader, interleaved.batches,
                 interleaved.InterleavedConfig(**kw), HashTokenizer(), workers)
    assert_batches_equal(got, want, FIELDS)
    media = HashTokenizer().info.media_id
    counts = [int((row == media).sum()) for b in got for row in b.input_ids]
    assert min(counts) < 3 and got[0].images.shape[1:] == (3, 28, 28, 3)


@pytest.fixture(scope="module")
def sft_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("sft")
    synthetic.write_sft_datasets(root, np.random.RandomState(3), n=3)
    return root


def sft_blocks(root):
    return loader.load_config("aki_torch/configs/sft.yaml", [f"root={root}"]).datasets


@pytest.mark.parametrize("name", ["llava150k", "vqa", "gqa", "ocrvqa", "aokvqa", "scienceqa",
                                  "vsr", "vg", "refcoco", "refcoco+", "refcocog"])
def test_parsers_equal_jax(sft_root, name):
    block = sft_blocks(sft_root)[name]
    want = jax_parsers.PARSERS[block["classname"]](**block["data_cfg"])
    got = parsers.PARSERS[block["classname"]](**block["data_cfg"])
    assert got == want and len(got) >= 3
    assert parsers.TEMPLATE_NAME_BY_TASK == jax_parsers.TEMPLATE_NAME_BY_TASK


def sft_epoch(mod, tok, blocks, workers, epoch_seed, sampling, force_one, batch=2,
              max_length=40):
    """The SFT CLI's epoch: per-worker clones of the datasets, a mixture
    each, batches round-robin over the workers."""
    rng = random.Random(mod.worker_seed(11, 0, 0))
    datasets = [mod.SFTDataset(b["classname"], dict(b["data_cfg"]), tok, max_length=max_length,
                               image_size=28, rng=rng) for b in blocks.values()]

    def mk(w, n):
        rng_w = random.Random(mod.worker_seed(epoch_seed, 0, w))
        mixture = mod.MultiDataset([d.clone_for_worker(rng_w) for d in datasets],
                                   sampling_weights=sampling, force_one_per_dataset=force_one,
                                   batch_per_device=batch, num_ranks=n,
                                   seed=rng_w.randrange(2 ** 31))
        return mod.batches(mixture, batch, tok.info.pad_id, max_length, 28)
    make = jax_data_loader.make_loader if mod is jax_sft else data_loader.make_loader
    return list(make(mk, num_workers=workers))


@pytest.mark.parametrize("workers,sampling,force_one", [
    (1, "uniform", False), (2, "length_ratio", True), (3, "weights", False)])
def test_sft_batches_equal_jax(sft_root, workers, sampling, force_one):
    blocks = sft_blocks(sft_root)
    if sampling == "weights":
        sampling = [1.0 + i for i in range(len(blocks))]
    want = sft_epoch(jax_sft, JaxHashTokenizer(), blocks, workers, 5, sampling, force_one)
    got = sft_epoch(sft, HashTokenizer(), blocks, workers, 5, sampling, force_one)
    assert_batches_equal(got, want, FIELDS[:4])
    assert sft.worker_seed(42, 0, 3) == jax_sft.worker_seed(42, 0, 3)


def test_loader_pool_order_and_errors_equal_jax():
    def mk(w, n):
        for i in range(3 + w):
            if w == 1 and i == 3:
                raise RuntimeError("worker 1 failed")
            yield (w, i)
    want, got = [], []
    for make, out in ((jax_data_loader.make_loader, want), (data_loader.make_loader, got)):
        with pytest.raises(RuntimeError, match="worker 1 failed"):
            for item in make(mk, num_workers=3):
                out.append(item)
    assert got == want and len(got) >= 6
