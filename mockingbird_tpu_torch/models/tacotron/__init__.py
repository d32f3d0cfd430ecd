from .model import (  # noqa: F401
    CBHG, LSA, GlobalStyleToken, PreNet, Tacotron, TacotronDecoderCell,
    TacotronEncoder, tacotron_config,
)
from .inference import Synthesizer  # noqa: F401
