"""PyTorch/CUDA port of ``repro`` (MG-WFBP), for NVIDIA Hopper.

The package mirrors ``repro``'s layout file for file.  It imports ``torch``
and never ``jax``, and nothing of ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
