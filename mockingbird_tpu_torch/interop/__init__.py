"""Reference and HF PyTorch state_dicts → the port's modules.

Port of ``mockingbird_tpu/interop/``: a state_dict becomes the flax param
tree (``torch_weights``), which ``weights.load_flax`` loads into the port's
module; ``import_checkpoint`` writes it as an ``.npz`` export with a
``.json`` sidecar; ``reference_loader`` imports the reference's own torch
classes for tests.
"""
from .torch_weights import (  # noqa: F401
    convert_conformer_encoder, convert_encoder, convert_fregan_generator,
    convert_hifigan_generator, convert_ppg2mel, convert_tacotron, convert_vits,
    convert_wav2vec2_emotion, convert_wavernn, state_dict_to_numpy,
)
from .reference_loader import (  # noqa: F401
    load_reference_conformer, load_reference_encoder, load_reference_fregan,
    load_reference_hifigan_generator, load_reference_ppg2mel,
    load_reference_tacotron, load_reference_vits,
    load_reference_wavernn, reference_available,
)
