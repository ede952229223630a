"""Attention, masks and rotary embeddings; the CUDA kernel wrappers."""
