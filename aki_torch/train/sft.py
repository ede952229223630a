"""Instruction fine-tuning CLI: a weighted mixture of SFT datasets
(counterpart of ``aki_tpu/train/sft.py``).

The reference's ``train/instruction_finetune.py`` knobs (``configs/sft.yaml``)
in the YAML system: ``training_mode`` sft_scratch (the weights of the run
dir's newest checkpoint, a fresh optimizer, step 0) or sft_resume, sampling
weights, the 50k-step budget, prompt-masked labels from the data layer. An
epoch is one pass of the mixture; epochs repeat until ``total_training_steps``
or until one yields no batch. One device: rank 0 of 1.

Usage:
    python -m aki_torch.train.sft --config aki_torch/configs/sft.yaml \
        [--device cuda|cpu] [key.path=value ...]

``AKI_REMAT_POLICY`` and ``training_config.tensorboard`` as for
:mod:`aki_torch.train.pretrain`.
"""

from __future__ import annotations

import random

from ..configs.loader import load_config
from ..data.loader import make_loader
from ..data.sft.pipeline import MultiDataset, SFTDataset, batches, worker_seed
from ..data.tokenizer import load_tokenizer
from ..models.common import resolve_device
from .cli import (is_main, join_group, model_config, parallel_fields, parse_args,
                  refuse_unported, remat_policy)
from .metrics import MetricsLogger
from .runner import RunnerConfig, Trainer


def runner_config(tc, cfg=None) -> RunnerConfig:
    return RunnerConfig(
        run_dir=tc.get("run_dir", "runs/sft"),
        learning_rate=tc.get("learning_rate", 2e-5),
        min_lr=tc.get("min_lr", 1e-6),
        weight_decay=tc.get("weight_decay", 1e-4),
        warmup_steps=tc.get("warmup_steps", 150),
        total_steps=tc.get("total_training_steps", 50000),
        lr_schedule=tc.get("lr_scheduler_type", "cosine"),
        grad_accum=tc.get("gradient_accumulation_steps", 1),
        precision=tc.get("precision", "bf16"),
        remat=tc.get("gradient_checkpointing", True),
        remat_policy=remat_policy(),
        checkpoint_steps=tc.get("checkpoint_steps", 1000),
        seed=tc.get("seed", 42),
        decay_policy=tc.get("decay_policy", "all"),
        training_mode=tc.get("training_mode", "sft_scratch"),
        log_every=tc.get("log_every", 10),
        host_offload=tc.get("host_offload", False),
        frozen_bf16=tc.get("frozen_bf16", False),
        moe_aux_weight=tc.get("moe_aux_weight", 0.01),
        **parallel_fields(cfg, tc),
    )


def run(cfg, device="cuda") -> Trainer:
    """Fine-tune on the loaded config ``cfg``; returns the finished trainer."""
    device = resolve_device(device)
    tc = cfg.training_config
    refuse_unported(cfg, tc)
    tokenizer = load_tokenizer(cfg.get("tokenizer_path"))
    model_cfg = model_config(cfg, tokenizer)
    run_cfg = runner_config(tc, cfg)
    trainer = Trainer(model_cfg, run_cfg, device=device, metrics=MetricsLogger(
        run_cfg.run_dir, use_tensorboard=tc.get("tensorboard", True)) if is_main() else None)

    max_length = tc.get("max_length", 512)
    rng = random.Random(worker_seed(run_cfg.seed, 0, 0))
    datasets, weights = [], []
    for block in cfg.datasets.values():
        datasets.append(SFTDataset(block["classname"], dict(block["data_cfg"]), tokenizer,
                                   max_length=max_length,
                                   image_size=model_cfg.siglip.image_size, rng=rng))
        weights.append(block.get("weight", 1.0))

    batch_size = tc.get("batch_size_per_device", 4)
    sampling = tc.get("sampling_weights") or weights or "uniform"
    # configs/sft.yaml workers: 4, capped so that every worker owns at least
    # one full batch (tiny datasets would otherwise make empty epochs)
    total_len = sum(len(d) for d in datasets)
    num_workers = max(1, min(tc.get("workers", 4), total_len // max(batch_size, 1)))

    def make_epoch_iter(epoch_seed):
        def mk(w, n):
            # a worker's mixture over the shared parsed records, with its own
            # random state; num_ranks splits the epoch's length between them
            rng_w = random.Random(worker_seed(epoch_seed, 0, w))
            mixture = MultiDataset(
                [d.clone_for_worker(rng_w) for d in datasets], sampling_weights=sampling,
                force_one_per_dataset=tc.get("force_one_per_dataset", False),
                batch_per_device=batch_size, num_ranks=n,
                seed=rng_w.randrange(2 ** 31))
            return batches(mixture, batch_size, tokenizer.info.pad_id, max_length,
                           model_cfg.siglip.image_size)
        return mk

    epoch = trainer.epoch
    while trainer.state.step < run_cfg.total_steps:
        before = trainer.state.step
        trainer.run_epoch(make_loader(make_epoch_iter(run_cfg.seed + epoch),
                                      num_workers=num_workers), epoch)
        epoch += 1
        if trainer.state.step == before:
            print("warning: epoch produced no batches; stopping")
            break
    trainer.finish(epoch)
    if is_main():
        print(f"done at step {trainer.state.step}")
    return trainer


def main(argv=None) -> Trainer:
    args = parse_args(argv, "AKI instruction fine-tuning on a dataset mixture")
    return run(load_config(args.config, args.overrides), join_group(args.device))


if __name__ == "__main__":
    main()
