"""Training data on the device (port of ``audio_training_tpu/data``): the
batch preprocess and the class weighting.  The record readers and loaders
are not ported yet (ROADMAP.md queue item 4)."""
