from .inference import load_vocoder  # noqa: F401
from .wavernn import (  # noqa: F401
    WaveRNN, WaveRnnVocoder, fold_with_overlap, wavernn_config, xfade_and_unfold,
)
