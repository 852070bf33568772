"""Drivers of the LM and DeepFM: ``serve`` (prefill a batch of prompts, then
decode greedily with a KV cache) and ``train`` (the training CLI)."""
