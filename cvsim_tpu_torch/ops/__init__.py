"""Plain PyTorch primitives (twins of cvsim_tpu.ops)."""
