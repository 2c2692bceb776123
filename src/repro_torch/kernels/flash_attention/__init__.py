"""Flash attention forward (K4) in CUDA."""
