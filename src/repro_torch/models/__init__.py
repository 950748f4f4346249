"""The LM substrate's model stack: layers, the Mamba-2 block and the
transformer assembly (init, forward, prefill, decode)."""
