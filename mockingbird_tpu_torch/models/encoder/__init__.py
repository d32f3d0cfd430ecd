from .model import (  # noqa: F401
    FusedLSTMLayer, SpeakerEncoder, similarity_matrix, ge2e_loss, equal_error_rate,
    init_params, init_similarity_params,
    MEL_N_CHANNELS, MODEL_EMBEDDING_SIZE, MODEL_HIDDEN_SIZE, MODEL_NUM_LAYERS,
)
from .inference import SpeakerEncoderInference, compute_partial_slices  # noqa: F401
from .dataset import (  # noqa: F401
    RandomCycler, Speaker, SpeakerBatchSampler, SpeakerVerificationDataset, Utterance,
)
from .train import train  # noqa: F401
