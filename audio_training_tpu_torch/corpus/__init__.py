"""Host-side corpus tooling; so far the audio decode of the Predictor."""
