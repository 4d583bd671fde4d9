"""FastSpeech2 encoders."""
