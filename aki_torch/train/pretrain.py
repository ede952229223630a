"""Pretraining CLI: webdataset image-caption and interleaved (MMC4-style)
shards, several datasets at once (counterpart of
``aki_tpu/train/pretrain.py``).

The per-dataset knobs (batch size, loss multiplier, sample budget, shard
globs, ``train.py:100-116``) live under ``datasets:`` blocks of one YAML.
One optimizer step consumes one batch from every dataset and their
(weighted) gradients sum before the update (``zip(*dataloaders)`` and a
backward per dataset, ``train_utils.py:215-252``). A dataset is
interleaved when its block says ``type: interleaved`` or its name holds
``mmc4``. One device: rank 0 of 1.

Usage:
    python -m aki_torch.train.pretrain --config aki_torch/configs/pretrain.yaml \
        [--device cuda|cpu] [key.path=value ...]

``AKI_REMAT_POLICY`` (``dots`` by default, or ``dots_nowide``, ``full``)
picks what the recompute keeps; ``training.tensorboard: false`` writes
``metrics.jsonl`` only.
"""

from __future__ import annotations

import dataclasses

from ..configs.loader import load_config
from ..data.interleaved import InterleavedConfig
from ..data.interleaved import batches as interleaved_batches
from ..data.loader import make_loader
from ..data.pretrain import PretrainConfig, batches
from ..data.tokenizer import load_tokenizer
from ..models.common import resolve_device
from ..ops.flash_mma_args import MAX_IMAGES
from .cli import (is_main, join_group, model_config, parallel_fields, parse_args,
                  refuse_unported, remat_policy)
from .metrics import MetricsLogger
from .runner import RunnerConfig, Trainer


def runner_config(tc, cfg=None) -> RunnerConfig:
    return RunnerConfig(
        run_dir=tc.get("run_dir", "runs/pretrain"),
        learning_rate=tc.get("learning_rate", 1e-4),
        min_lr=tc.get("min_lr", 1e-5),
        weight_decay=tc.get("weight_decay", 0.01),
        warmup_steps=tc.get("warmup_steps", 2000),
        total_steps=tc.get("total_steps", 100000),
        lr_schedule=tc.get("lr_scheduler", "cosine"),
        grad_accum=tc.get("gradient_accumulation_steps", 1),
        precision=tc.get("precision", "bf16"),
        remat=tc.get("gradient_checkpointing", True),
        remat_policy=remat_policy(),
        checkpoint_steps=tc.get("checkpoint_steps", 1000),
        keep_last_checkpoints=1 if tc.get("delete_previous_checkpoint") else None,
        seed=tc.get("seed", 42),
        decay_policy=tc.get("decay_policy", "all"),
        training_mode=tc.get("training_mode", "resume"),
        log_every=tc.get("log_every", 10),
        host_offload=tc.get("host_offload", False),
        frozen_bf16=tc.get("frozen_bf16", False),
        moe_aux_weight=tc.get("moe_aux_weight", 0.01),
        **parallel_fields(cfg, tc),
    )


def dataset_configs(cfg, model_cfg, seed: int, device) -> list:
    """[(dataset config, its batches function)] in the YAML's order. On the
    card an interleaved dataset may carry at most ``MAX_IMAGES`` images a
    row: the attention kernels take that many MMA rectangles."""
    out = []
    size = model_cfg.siglip.image_size
    for name, d in cfg.datasets.items():
        kind = d.get("type", "interleaved" if "mmc4" in name else "paired")
        if kind == "interleaved":
            n_img = d.get("max_num_images", 6)
            if device.type == "cuda" and n_img > MAX_IMAGES:
                raise ValueError(
                    f"dataset {name}: max_num_images={n_img}, but the attention kernels "
                    f"take at most flash_mma_args.MAX_IMAGES = {MAX_IMAGES} images a row")
            out.append((InterleavedConfig(
                shards=d["shards"],
                batch_size=d.get("batch_size", 4),
                max_tokens=d.get("max_text_len", 256),
                image_size=size,
                sim_threshold=d.get("mmc4_textsim_threshold", 0.24),
                min_num_images=d.get("min_num_images", 1),
                max_num_images=n_img,
                seed=seed,
                loss_multiplier=d.get("loss_multiplier", 1.0),
            ), interleaved_batches))
        else:
            out.append((PretrainConfig(
                shards=d["shards"],
                batch_size=d.get("batch_size", 8),
                max_text_len=d.get("max_text_len", 128),
                image_size=size,
                dataset_name=name,
                seed=seed,
                num_samples=d.get("train_num_samples"),
                resampled=d.get("resampled", False),
                loss_multiplier=d.get("loss_multiplier", 1.0),
            ), batches))
    return out


def run(cfg, device="cuda") -> Trainer:
    """Train on the loaded config ``cfg``; returns the finished trainer."""
    device = resolve_device(device)
    tc = cfg.training
    refuse_unported(cfg, tc)
    tokenizer = load_tokenizer(cfg.get("tokenizer_path"))
    model_cfg = model_config(cfg, tokenizer)
    run_cfg = runner_config(tc, cfg)
    ds_cfgs = dataset_configs(cfg, model_cfg, run_cfg.seed, device)
    trainer = Trainer(model_cfg, run_cfg, device=device, metrics=MetricsLogger(
        run_cfg.run_dir, use_tensorboard=tc.get("tensorboard", True)) if is_main() else None)

    num_workers = tc.get("workers", 4)   # reference: 4 workers per GPU

    def make_ds_iter(dc, batches_fn, epoch):
        def mk(w, n):
            cfg_w = dc
            if getattr(dc, "num_samples", None):
                # the budget split with its remainder on the first workers:
                # a plain // floors small budgets to 0
                share = dc.num_samples // n + (1 if w < dc.num_samples % n else 0)
                cfg_w = dataclasses.replace(dc, num_samples=share)
            return batches_fn(cfg_w, tokenizer, epoch=epoch, rank=0, world=1,
                              worker=w, num_workers=n)
        return mk

    epoch = trainer.epoch
    for epoch in range(trainer.epoch, tc.get("num_epochs", 1)):
        # one loader per dataset; zip stops at the shortest
        iters = [make_loader(make_ds_iter(dc, fn, epoch), num_workers=num_workers)
                 for dc, fn in ds_cfgs]
        stream = iters[0] if len(iters) == 1 else zip(*iters)
        if trainer.run_epoch(stream, epoch) >= run_cfg.total_steps:
            break
    trainer.finish(epoch)
    if is_main():
        print(f"done at step {trainer.state.step}")
    return trainer


def main(argv=None) -> Trainer:
    args = parse_args(argv, "AKI pretraining on webdataset shards")
    return run(load_config(args.config, args.overrides), join_group(args.device))


if __name__ == "__main__":
    main()
