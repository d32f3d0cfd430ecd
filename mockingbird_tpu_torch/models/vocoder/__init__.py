from .fregan import FreGanGenerator, FreGanResBlock, dwt_haar, fregan_config  # noqa: F401
from .hifigan import Generator, ResBlock1, ResBlock2, hifigan_config  # noqa: F401
from .inference import GanVocoder, load_vocoder  # noqa: F401
from .wavernn import (  # noqa: F401
    WaveRNN, WaveRnnVocoder, fold_with_overlap, wavernn_config, xfade_and_unfold,
)
