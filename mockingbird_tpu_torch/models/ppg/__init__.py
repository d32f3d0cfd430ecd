"""PPG one-shot voice conversion: Conformer PPG extractor → ppg2mel
MOL-attention decoder → vocoder, and the ppg2mel trainer."""
from .extractor import ConformerEncoder, PPGExtractor, PPGModel, ppg_config  # noqa: F401
from .ppg2mel import MelDecoderMOLv2, MOLAttention, ppg2mel_config  # noqa: F401
from .train import OneshotVcDataset, collate_vc, train  # noqa: F401
from .convert import VoiceConverter, preprocess_vc_dataset  # noqa: F401
