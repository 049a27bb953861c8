"""Gen-2 engine: stage path and fused chain (twins of cvsim_tpu.models)."""
