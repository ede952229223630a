"""Host-side data helpers of the port: tokenizers, image preprocessing and
chat templates (counterparts of ``aki_tpu/data``)."""
