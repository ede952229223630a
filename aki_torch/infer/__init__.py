"""KV-cached generation and sampling."""
