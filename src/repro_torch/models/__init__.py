"""Model building blocks, the LM and the architecture registry."""
