"""cvsim_tpu_torch — the PyTorch/CUDA port of cvsim_tpu.

A second package beside `cvsim_tpu` (the JAX reference, which stays as it
is). Module names mirror the JAX package's, so each twin sits where a
reader expects it:

- ops/       C-semantics helpers, phase tables, counter-based noise, the
             blocked one-pole IIR with its log-depth carry scan for long
             axes (plain PyTorch)
- audio/     the VHS audio chain and the cassette chain (plain PyTorch:
             the JAX package runs them without a TPU kernel)
- models/    the gen-2 YIQ and gen-1 YUV 4:2:2 stage paths (yiq.py,
             yuv422.py) and their fused chains (fused_yiq.py,
             fused_yuv.py: the plain chain and the wrappers of the
             hand-written CUDA kernels), with both chains' per-field and
             per-line inputs in chain_prep.py
- csrc/      CUDA C++ kernels for Hopper (sm_90a)
- kernels.py builds csrc/ at first use and is the only module that
             talks to the library: every wrapper calls kernels.launch
- parallel/  the multi-device paths: fields over n devices (-devices),
             the line-sharded gen-2 program over row shards
- host/      the gen-2 and gen-1 GOP pipelines, the audio stream
             (`CompositePipeline.run_audio`: decode, gap fill, resample,
             1M-sample chunks), and the host I/O they need (Y4M, WAV,
             field clock, batching, checkpoints, ffmpeg pipes)
- native/    the host frame scaler and the cvsim-av container tool
             (C++, built with g++ at first use)
- config.py, presets.py   the configuration dataclasses and flag parsing
- utils/     logging, phase lines, the CVSIM_PROFILE trace, and the
             vaporwave and repo tools
- cli/       `python -m cvsim_tpu_torch [--device cuda|cpu] <command>`,
             all 17 of the JAX CLI's commands, `serve` and `-via`

The package imports torch and numpy, and neither jax nor cvsim_tpu: where
it needs a module of the JAX package that has no device code (config,
presets, host I/O, native, the host tools), it keeps its own copy under
the same name. The host-only commands never import torch.
"""

__version__ = "0.1.0"
