from audio_training_tpu_torch.utils.logging import init_logging

__all__ = ["init_logging"]
