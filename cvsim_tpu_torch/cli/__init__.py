"""Command line (twin of cvsim_tpu.cli.main, ntsc only)."""
