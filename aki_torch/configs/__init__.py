"""The port's YAML configs and their loader (counterpart of
``aki_tpu/configs``)."""
