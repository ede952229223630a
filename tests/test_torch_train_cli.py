"""The port's training CLIs (``aki_torch.train.pretrain`` and ``.sft``)
against the JAX CLIs on the same YAML and synthetic files.

Both ``main``s run with their module's ``Trainer`` replaced by a recorder
that keeps the runner config, the model config and every batch its
``run_epoch`` is given, and runs no step (the JAX side runs no JAX step):
the shared runner fields and the model configs must be equal and the
batches byte-equal, for paired shards alone, paired + interleaved, and
the SFT mixture. Then the port's CLIs train for real on the CPU
(``--device cpu``, ``tiny``, fp32, 3 steps): finite losses in
``metrics.jsonl``, equal to the port ``Trainer`` driven on the recorded
batches, and the logged losses and grad norms within 1e-4 relative of the
JAX ``make_train_step`` (one device, no mesh; the same f32 math summed in
another order over three AdamW steps) from the same initial weights, carried
across by ``aki_tpu.convert``, on the same batches; checkpoints at
``checkpoint_steps`` and at the end, ``delete_previous_checkpoint`` keeping
one; an ``sft_scratch`` run on a pretrain run's checkpoint starts from its
weights with a fresh optimizer at step 0; and the keys the port does not
run raise.
"""

import dataclasses
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import aki_tpu.train.pretrain as jax_pretrain
import aki_tpu.train.sft as jax_sft
import jax
import jax.numpy as jnp
from aki_tpu.convert.torch_to_jax import convert_aki_checkpoint
from aki_tpu.models.common import F32 as JAX_F32
from aki_tpu.train import optim as jax_optim
from aki_tpu.train import schedules as jax_schedules
from aki_tpu.train.step import Batch as JaxBatch
from aki_tpu.train.step import TrainState as JaxTrainState
from aki_tpu.train.step import make_train_step as jax_make_train_step
from aki_torch.data import synthetic
from aki_torch.models.aki import AKIModel
from aki_torch.train import pretrain, sft
from aki_torch.train.checkpoints import CheckpointManager
from aki_torch.train.metrics import MetricsLogger
from aki_torch.train.runner import Trainer

from .test_torch_train_data import assert_batches_equal

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("input_ids", "attn_valid", "labels", "images")
LOSS_RTOL = 1e-4


class Recorder:
    """Stands in for a CLI's ``Trainer``: no model, no step; ``run_epoch``
    takes batches up to ``total_steps`` as the runner does."""

    def __init__(self, model_cfg, run_cfg, *args, **kw):
        self.model_cfg, self.cfg = model_cfg, run_cfg
        self.epoch, self.state, self.batches = 0, SimpleNamespace(step=0), []
        self.kw = kw
        Recorder.last = self

    def run_epoch(self, batch_iter, epoch):
        for b in batch_iter:
            if self.state.step >= self.cfg.total_steps:
                break
            self.batches.append(b)
            self.state.step += 1
        return self.state.step

    def finish(self, epoch):
        self.finished = epoch


def record(module, argv, monkeypatch):
    monkeypatch.setattr(module, "Trainer", Recorder)
    if hasattr(module, "init_distributed"):
        monkeypatch.setattr(module, "init_distributed", lambda: None)
    module.main(argv)
    monkeypatch.undo()
    return Recorder.last


def write_pretrain(tmp_path, mixed: bool, delete_previous: bool = False) -> Path:
    tmp_path.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(11)
    for i in range(2):
        synthetic.write_caption_shard(tmp_path / f"pair-{i:04d}.tar", 8, rng,
                                      sizes=((40, 40), (56, 48)), prefix=f"p{i}_")
        synthetic.write_mmc4_shard(tmp_path / f"mmc4-{i:04d}.tar", 6, rng, images=(2, 5))
    datasets = {"blip3_kale": {"shards": "${root}/pair-{0000..0001}.tar", "batch_size": 4,
                               "max_text_len": 16, "train_num_samples": 10,
                               "loss_multiplier": 0.5}}
    if mixed:
        datasets["mmc4"] = {"type": "interleaved", "shards": "${root}/mmc4-{0000..0001}.tar",
                            "batch_size": 2, "max_text_len": 48, "max_num_images": 3}
    path = tmp_path / "pt.yaml"
    path.write_text(yaml.safe_dump({
        "root": str(tmp_path), "tokenizer_path": None, "tiny": True,
        "mesh": {"data": 1, "fsdp": -1, "tensor": 1},
        "training": {"run_dir": str(tmp_path / "run"), "precision": "fp32",
                     "learning_rate": 1e-3, "total_steps": 3, "num_epochs": 2,
                     "warmup_steps": 1, "checkpoint_steps": 2, "log_every": 1, "workers": 2,
                     "delete_previous_checkpoint": delete_previous, "tensorboard": False},
        "datasets": datasets}))
    return path


def write_sft(tmp_path) -> Path:
    tmp_path.mkdir(parents=True, exist_ok=True)
    synthetic.write_sft_datasets(tmp_path, np.random.RandomState(12), n=6,
                                 names=["llava150k", "vqa"])
    (tmp_path / "sft_datasets").mkdir()
    for name in ("llava150k", "vqa"):
        shutil.copy(ROOT / "aki_torch" / "configs" / "sft_datasets" / f"{name}.yaml",
                    tmp_path / "sft_datasets")
    path = tmp_path / "sft.yaml"
    path.write_text(yaml.safe_dump({
        "defaults": [{"sft_datasets": "llava150k"}, {"sft_datasets": "vqa"}, "_self_"],
        "root": str(tmp_path), "tokenizer_path": None, "tiny": True,
        "mesh": {"data": 1, "fsdp": -1, "tensor": 1},
        "training_config": {"run_dir": str(tmp_path / "run"), "precision": "fp32",
                            "learning_rate": 1e-3, "total_training_steps": 3,
                            "max_length": 32, "batch_size_per_device": 2, "warmup_steps": 1,
                            "checkpoint_steps": 2, "training_mode": "sft_scratch",
                            "log_every": 1, "workers": 2, "tensorboard": False,
                            "sampling_weights": [2.0, 1.0]}}))
    return path


def assert_same_run(got, want):
    jax_fields = {f.name for f in dataclasses.fields(want.cfg)}
    shared = [f.name for f in dataclasses.fields(got.cfg) if f.name in jax_fields]
    assert len(shared) >= 20
    for name in shared:
        g, w = getattr(got.cfg, name), getattr(want.cfg, name)
        if dataclasses.is_dataclass(w):          # the mesh: each package's MeshConfig
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g == w, name
    assert dataclasses.asdict(got.model_cfg) == dataclasses.asdict(want.model_cfg)
    assert len(got.batches) == len(want.batches) == got.cfg.total_steps
    for g, w in zip(got.batches, want.batches):
        g, w = (g, w) if isinstance(g, tuple) else ((g,), (w,))
        assert len(g) == len(w)
        for gi, wi in zip(g, w):
            assert_batches_equal([gi], [wi], FIELDS)
            assert getattr(gi, "loss_weight", 1.0) == getattr(wi, "loss_weight", 1.0)


def jax_metrics(got, want) -> list[dict]:
    """Loss and grad_norm of each step of the JAX ``make_train_step`` on one
    device, no mesh, over the recorded batches: built as the JAX runner
    builds it from the run's config, from the port run's initial weights."""
    cfg = got.cfg
    assert cfg.precision == "fp32" and cfg.remat and cfg.grad_accum == 1
    model = AKIModel(got.model_cfg, device="cpu",
                     generator=torch.Generator().manual_seed(cfg.seed))
    params = jax.tree.map(jnp.asarray, convert_aki_checkpoint(model.state_dict(),
                                                              want.model_cfg))
    schedule = jax_schedules.make_schedule(cfg.lr_schedule, cfg.learning_rate, cfg.min_lr,
                                           cfg.warmup_steps, cfg.total_steps)
    decay = (jax_optim.decay_everything if cfg.decay_policy == "all"
             else jax_optim.decay_except_embeddings)
    opt = jax_optim.make_optimizer(params, schedule, weight_decay=cfg.weight_decay,
                                   grad_clip=cfg.grad_clip, decay_predicate=decay)
    step = jax.jit(jax_make_train_step(want.model_cfg, opt, policy=JAX_F32, remat=True,
                                       use_flash=False))

    def to_jax(b):
        lw = getattr(b, "loss_weight", None)
        return JaxBatch(*(jnp.asarray(getattr(b, f)) for f in
                          ("input_ids", "images", "attn_valid", "labels")),
                        loss_weight=None if lw in (None, 1.0) else jnp.float32(lw))

    state, out = JaxTrainState.create(params, opt), []
    for b in got.batches:
        state, m = step(state, tuple(map(to_jax, b)) if isinstance(b, tuple) else to_jax(b))
        out.append({k: float(v) for k, v in m.items()})
    return out


CASES = {"paired": (pretrain, jax_pretrain), "mixed": (pretrain, jax_pretrain),
         "sft": (sft, jax_sft)}


@pytest.fixture(scope="module", params=list(CASES))
def recorded(request, tmp_path_factory):
    case = request.param
    tmp = tmp_path_factory.mktemp(case)
    path = write_sft(tmp) if case == "sft" else write_pretrain(tmp, case == "mixed")
    port, jax_mod = CASES[case]
    with pytest.MonkeyPatch.context() as mp:
        want = record(jax_mod, ["--config", str(path)], mp)
        got = record(port, ["--config", str(path), "--device", "cpu"], mp)
    return case, path, got, want


def test_recorded_configs_and_batches_equal_jax(recorded):
    case, _, got, want = recorded
    assert_same_run(got, want)
    assert got.cfg.remat_policy == "dots" and got.kw["device"].type == "cpu"
    if case == "mixed":
        paired, inter = got.batches[0]
        assert paired.loss_weight == 0.5 and inter.images.ndim == 5


def test_cli_trains_on_the_cpu(recorded, monkeypatch):
    """The real CLI: finite losses equal to a Trainer driven directly on the
    recorded batches and, with the grad norms, to the JAX step's;
    checkpoints at step 2 and at the end."""
    case, path, got, jax_run = recorded
    mod = CASES[case][0]
    monkeypatch.delenv("AKI_REMAT_POLICY", raising=False)
    trainer = mod.main(["--config", str(path), "--device", "cpu"])
    run_dir = Path(got.cfg.run_dir)
    logged = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in logged] == [1, 2, 3] and trainer.state.step == 3
    assert all(np.isfinite(m["training_loss"]) for m in logged)

    direct_dir = run_dir.parent / "direct"
    direct = Trainer(got.model_cfg, dataclasses.replace(got.cfg, run_dir=str(direct_dir)),
                     device="cpu", metrics=MetricsLogger(str(direct_dir), use_tensorboard=False))
    want = []
    for b in got.batches:
        direct.run_epoch(iter([b]), 0)
        want.append(direct.metrics.last["training_loss"])
    np.testing.assert_allclose([m["training_loss"] for m in logged], want, rtol=1e-6)
    for name, p in direct.model.named_parameters():
        torch.testing.assert_close(trainer.model.get_parameter(name), p, rtol=0, atol=0)
    jax_logged = jax_metrics(got, jax_run)
    for key, jax_key in (("training_loss", "loss"), ("grad_norm", "grad_norm")):
        np.testing.assert_allclose([m[key] for m in logged],
                                   [m[jax_key] for m in jax_logged], rtol=LOSS_RTOL,
                                   err_msg=key)

    # step 2 (checkpoint_steps) in epoch 0, the end (step 3) in epoch 1
    names = sorted(p.name for p in run_dir.glob("checkpoint_*.pt"))
    assert names == ["checkpoint_0_2.pt", "checkpoint_1_3.pt"], names
    blob = torch.load(run_dir / names[-1], map_location="cpu", weights_only=False)
    assert blob["step"] == 3
    for k, v in blob["model_state_dict"].items():
        assert torch.equal(v, trainer.model.state_dict()[k]), k


def test_delete_previous_checkpoint_keeps_one(tmp_path):
    path = write_pretrain(tmp_path, mixed=False, delete_previous=True)
    pretrain.main(["--config", str(path), "--device", "cpu"])
    assert [p.name for p in (tmp_path / "run").glob("checkpoint_*.pt")] == ["checkpoint_1_3.pt"]


def test_sft_scratch_starts_from_a_pretrain_checkpoint(tmp_path):
    """An sft_scratch run in a pretrain run's directory: the checkpoint's
    weights, a fresh optimizer, step 0."""
    pt = pretrain.main(["--config", str(write_pretrain(tmp_path / "pt", mixed=False)),
                        "--device", "cpu"])
    ckpt = CheckpointManager(str(tmp_path / "pt" / "run")).latest()
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert saved["step"] == 3 and saved["optimizer_state_dict"]["adamw"]["state"]
    trainer = sft.main(["--config", str(write_sft(tmp_path / "sft")), "--device", "cpu",
                        f"training_config.run_dir={tmp_path / 'pt' / 'run'}",
                        "training_config.total_training_steps=0"])
    fresh = trainer.state.optimizer.state_dict()
    assert trainer.state.step == 0 and fresh["count"] == 0 and not fresh["adamw"]["state"]
    live = trainer.model.state_dict()
    for k, v in saved["model_state_dict"].items():
        assert torch.equal(live[k], v), k
        assert torch.equal(v, pt.model.state_dict()[k]), k
    # not the SFT run's own init: the weights came from the checkpoint
    init = AKIModel(trainer.model_cfg, device="cpu",
                    generator=torch.Generator().manual_seed(trainer.cfg.seed)).state_dict()
    assert any(not torch.equal(init[k], v) for k, v in saved["model_state_dict"].items())


@pytest.mark.parametrize("override,match", [
    ("mesh.tensor=2", "not divisible by 2"), ("mesh={data: -1, fsdp: -1}", "at most one"),
    ("mesh.pipe=2", "not divisible by 2"), ("mesh.expert=2", "not divisible by 2"),
    ("training.fsdp_strategy=zero3", "fsdp_strategy")])
def test_unported_keys_raise(override, match):
    sft_override = override.replace("training.", "training_config.")
    for mod, cfg, ov in ((pretrain, "pretrain", override), (sft, "sft", sft_override)):
        with pytest.raises((NotImplementedError, ValueError), match=match):
            mod.main(["--config", f"aki_torch/configs/{cfg}.yaml", "--device", "cpu", ov])


@pytest.mark.parametrize("case", ["paired", "sft"])
def test_clis_read_moe_aux_weight(case, tmp_path, monkeypatch):
    """``moe_aux_weight`` reaches the runner config as in the JAX CLIs: the
    default 0.01, and a YAML override."""
    path = write_sft(tmp_path) if case == "sft" else write_pretrain(tmp_path, False)
    port, jax_mod = CASES[case]
    key = "training_config" if case == "sft" else "training"
    for argv, weight in (([], 0.01), ([f"{key}.moe_aux_weight=0.3"], 0.3)):
        want = record(jax_mod, ["--config", str(path), *argv], monkeypatch)
        got = record(port, ["--config", str(path), "--device", "cpu", *argv], monkeypatch)
        assert got.cfg.moe_aux_weight == want.cfg.moe_aux_weight == weight


def test_accum_unroll_accepted_and_default_device_is_the_card():
    """``accum_unroll`` is a key the CLIs do not read (nothing to unroll in
    an eager loop): a YAML that sets it builds the same runner config."""
    plain = pretrain.runner_config(
        pretrain.load_config("aki_torch/configs/pretrain.yaml", ["training.host_offload=true"])
        .training)
    cfg = pretrain.load_config("aki_torch/configs/pretrain.yaml",
                               ["training.accum_unroll=true", "training.host_offload=true"])
    run_cfg = pretrain.runner_config(cfg.training)
    assert cfg.training.accum_unroll is True and run_cfg == plain and run_cfg.host_offload
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pretrain.main(["--config", "aki_torch/configs/pretrain.yaml"])


def test_clis_run_sharded_under_gloo(tmp_path, monkeypatch):
    """Both CLIs on a 2-rank gloo group with ``mesh.fsdp=2`` (pretrain also
    ``fsdp_strategy=grad_op``, SFT ``host_offload_params`` refused under
    the group): rank 0 logs, rank 1 does not, and the logged losses and grad
    norms are the single-device CLI's within 1e-4; ``mesh.tensor=2`` still
    raises."""
    from ._torch_dist import run_group

    monkeypatch.delenv("AKI_REMAT_POLICY", raising=False)
    pt, st = write_pretrain(tmp_path / "pt", False), write_sft(tmp_path / "sft")
    want = {}
    for name, mod, path, key in (("pretrain", pretrain, pt, "training"),
                                 ("sft", sft, st, "training_config")):
        run_dir = tmp_path / f"{name}_single"
        mod.main(["--config", str(path), "--device", "cpu", f"{key}.run_dir={run_dir}"])
        want[name] = [json.loads(line)
                      for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    ranks = run_group("_torch_dist_cases:cli_cases", 2, tmp_path / "group", timeout=300,
                      pretrain_cfg=str(pt), sft_cfg=str(st), out=str(tmp_path))
    for name in ("pretrain", "sft"):
        got = ranks[0][name]
        assert ranks[1][name] is None                   # rank 1 writes no metrics
        assert [m["step"] for m in got] == [m["step"] for m in want[name]] == [1, 2, 3]
        for k in ("training_loss", "grad_norm"):
            np.testing.assert_allclose([m[k] for m in got], [m[k] for m in want[name]],
                                       rtol=LOSS_RTOL, err_msg=f"{name} {k}")
    for r in ranks:
        assert "item 10" in r["tensor"] and "item 10" in r["offload"]
