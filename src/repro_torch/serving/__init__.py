"""The batched serving runtime (prefill + greedy decode)."""
