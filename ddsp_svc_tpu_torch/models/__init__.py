"""The CombSubFast synthesizer and the model factory."""
