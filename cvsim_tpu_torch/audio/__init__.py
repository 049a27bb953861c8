from cvsim_tpu_torch.audio.chains import (
    AudioState,
    buzz_pulse_counts,
    composite_audio_process,
    init_audio_state,
)

__all__ = [
    "AudioState",
    "buzz_pulse_counts",
    "composite_audio_process",
    "init_audio_state",
]
