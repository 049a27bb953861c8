"""Host utilities (twins of cvsim_tpu.utils): logging, phase lines and
the CVSIM_PROFILE trace, the vaporwave text tool and the repo tools."""

from cvsim_tpu_torch.utils.log import Progress, get_logger, profile_trace

__all__ = ["get_logger", "Progress", "profile_trace"]
