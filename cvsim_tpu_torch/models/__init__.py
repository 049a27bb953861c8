"""The gen-2 and gen-1 engines: stage paths and fused chains (twins of
cvsim_tpu.models)."""
