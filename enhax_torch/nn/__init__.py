"""Layers of the port (NCHW inside, as ``torch.nn`` expects)."""
