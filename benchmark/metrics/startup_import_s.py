"""Host wall of the start-up steps inside set-up: `import torch`, the
port's modules that the cell runs, and the kernel library's load
(`kernels.load()`: a build with nvcc on a checkout's first run)."""


def read(run):
    return sum(run.startup.get(k, 0.0) for k in ("torch", "port", "kernels"))
