"""PPG one-shot voice conversion: Conformer PPG extractor → ppg2mel
MOL-attention decoder → vocoder."""
from .extractor import ConformerEncoder, PPGExtractor, PPGModel, ppg_config  # noqa: F401
from .ppg2mel import MelDecoderMOLv2, MOLAttention, ppg2mel_config  # noqa: F401
from .convert import VoiceConverter  # noqa: F401
