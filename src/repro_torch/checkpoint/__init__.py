"""Atomic checkpoints of the train path."""
