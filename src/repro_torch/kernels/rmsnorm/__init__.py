"""Fused RMSNorm (K3) in CUDA."""
