"""Command line (twin of cvsim_tpu.cli.main: ntsc and to-composite)."""
