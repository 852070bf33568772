"""Drivers of the LM: ``serve`` (prefill a batch of prompts, then decode
greedily with a KV cache)."""
