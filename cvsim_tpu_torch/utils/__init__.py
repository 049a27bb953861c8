"""Host utilities (twins of cvsim_tpu.utils): logging, phase lines, the
CVSIM_PROFILE trace and the recorder of spans and counters, the vaporwave
text tool and the repo tools."""

from cvsim_tpu_torch.utils.log import get_logger, profile_trace

__all__ = ["get_logger", "profile_trace"]
