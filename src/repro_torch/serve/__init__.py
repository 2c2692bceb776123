"""Batched serving: prefill and greedy or sampled decode with a KV cache."""
