"""DSP ops: framing, STFT, mel, PCEN and the featurizer backends."""
