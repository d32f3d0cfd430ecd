"""Reference and HF PyTorch state_dicts → the port's modules.

Port of ``mockingbird_tpu/interop/``, the emotion extractor's converter
only: a state_dict becomes the flax param tree, which ``weights.load_flax``
loads into the port's module.
"""
from .torch_weights import convert_wav2vec2_emotion, state_dict_to_numpy  # noqa: F401
