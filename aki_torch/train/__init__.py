"""Training: optimizer, schedules, the train step, metrics, checkpoints and
the runner (counterpart of ``aki_tpu/train``; single device)."""
