"""Batched serving: prefill and a greedy or sampled decode loop."""
