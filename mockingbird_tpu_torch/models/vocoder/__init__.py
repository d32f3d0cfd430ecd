from .fregan import (FreGanDiscriminators, FreGanGenerator, FreGanResBlock,  # noqa: F401
                     dwt_haar, fregan_config)
from .hifigan import (Generator, HifiganDiscriminators, MultiPeriodDiscriminator,  # noqa: F401
                      MultiScaleDiscriminator, ResBlock1, ResBlock2, hifigan_config,
                      init_discriminators, init_generator)
from .inference import GanVocoder, load_vocoder  # noqa: F401
from .wavernn import (  # noqa: F401
    WaveRNN, WaveRnnVocoder, fold_with_overlap, wavernn_config, xfade_and_unfold,
)
