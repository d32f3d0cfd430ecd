"""Models of the voice-cloning path: GE2E encoder, Tacotron, WaveRNN."""
