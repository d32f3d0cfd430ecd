from .model import (  # noqa: F401
    CBHG, LSA, GlobalStyleToken, PreNet, Tacotron, TacotronDecoderCell,
    TacotronEncoder, tacotron_config,
)
from .inference import Synthesizer  # noqa: F401
from .dataset import DataLoader, SynthesizerDataset, collate_synthesizer  # noqa: F401
from .train import DEFAULT_SCHEDULE, run_gta_synthesis, tacotron_loss, train  # noqa: F401
from .preprocess import (create_embeddings, create_emotion_embeddings,  # noqa: F401
                         preprocess_dataset)
