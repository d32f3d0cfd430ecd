from .model import (  # noqa: F401
    FusedLSTMLayer, SpeakerEncoder,
    MEL_N_CHANNELS, MODEL_EMBEDDING_SIZE, MODEL_HIDDEN_SIZE, MODEL_NUM_LAYERS,
)
from .inference import SpeakerEncoderInference, compute_partial_slices  # noqa: F401
