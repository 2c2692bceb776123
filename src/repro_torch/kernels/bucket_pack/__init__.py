"""Merged-gradient bucket pack/unpack (paper §5.3) in CUDA."""
