"""Flash attention over explicit positions (``csrc/flash_attention.cu``)."""
