"""Host-side streaming pipelines (twins of cvsim_tpu.host.pipeline_yiq and
of the video side of cvsim_tpu.host.pipeline)."""
