"""Command-line entry points (``python -m audio_training_tpu_torch.cli.<name>``)."""
