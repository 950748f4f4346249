"""The optimizer of the train path: AdamW on the model's tensors."""
