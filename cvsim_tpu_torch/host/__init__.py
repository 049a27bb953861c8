"""Host-side streaming pipeline (twin of cvsim_tpu.host.pipeline_yiq)."""
