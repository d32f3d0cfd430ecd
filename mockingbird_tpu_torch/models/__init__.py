"""Models of the voice-cloning paths: GE2E encoder, Tacotron, the vocoders,
VITS and PPG voice conversion."""
