"""The chunked Mamba-2 SSD scan (``csrc/ssd_scan.cu``)."""
