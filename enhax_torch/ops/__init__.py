"""Tensor ops on NHWC images (layout, resize) and host-side image I/O."""
