"""Fields the window completed, over the window's whole wall time (a
render's window ends when `run_video` returns, its drain included)."""


def read(run):
    return run.window.fields / run.window.seconds
