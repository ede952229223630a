"""aki_torch — the AKI model on PyTorch and CUDA (NVIDIA Hopper).

A second package beside ``aki_tpu``: the same model, generation engine,
training path and MMA attention, with ``aki_tpu`` as the numerical
reference. Plain tensor code is PyTorch; the flash MMA attention forward
and backward are CUDA C++ kernels written for ``sm_90a``
(``csrc/flash_mma_fwd.cu``, ``csrc/flash_mma_bwd.cu``), built with ``nvcc``
on first use.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back.
"""
