"""Command line (twin of cvsim_tpu.cli): all 17 commands, `serve` and
the `-via` client."""
