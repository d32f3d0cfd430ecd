"""Import the reference's PyTorch model code for equivalence testing.

The port's own copy of ``mockingbird_tpu/interop/reference_loader.py``. The
reference source is pure torch for the model classes; unavailable host deps
(librosa, webrtcvad, pypinyin, the compiled monotonic_align, ...) are
stubbed before import so the module graphs load. The reference checkout is
at the JAX package's fixed ``REFERENCE_ROOT``. Only used by tests/tools,
never by the production path.
"""
from __future__ import annotations

import sys
import types
from pathlib import Path

REFERENCE_ROOT = Path("/root/reference")

_STUBS = ["imp", "librosa", "librosa.filters", "librosa.core", "librosa.effects",
          "librosa.feature", "librosa.util", "webrtcvad", "pypinyin",
          "pypinyin.contrib", "pypinyin.contrib.neutral_tone",
          "pypinyin.converter", "pypinyin.core", "monotonic_align",
          "loguru", "pyworld", "soundfile", "visdom", "umap", "resampy",
          "tqdm", "unidecode", "inflect", "cn2an", "pywt",
          "torch_complex", "torch_complex.tensor", "humanfriendly",
          "espnet", "espnet.nets", "espnet.nets.pytorch_backend",
          "espnet.nets.pytorch_backend.transformer",
          "espnet.nets.pytorch_backend.transformer.embedding"]


_STUBBED: set = set()


def _stub(name: str) -> None:
    if name in sys.modules:
        return
    # never shadow a real installed package (e.g. tqdm, which transformers
    # needs working — a fake module here breaks unrelated later imports)
    import importlib.util
    try:
        if importlib.util.find_spec(name) is not None:
            return
    except Exception:
        pass  # parent is itself a stub / no spec — go ahead and stub
    mod = types.ModuleType(name)
    mod.__path__ = []  # mark as package so dotted children resolve
    mod.__getattr__ = lambda attr: (lambda *a, **k: None)  # type: ignore
    if name == "loguru":
        class _L:
            def __getattr__(self, a):
                return lambda *x, **k: None
        mod.logger = _L()
    if name == "tqdm":
        mod.tqdm = lambda it, *a, **k: it
    sys.modules[name] = mod
    _STUBBED.add(name)


def reference_available() -> bool:
    return REFERENCE_ROOT.exists()


def setup_reference_imports() -> None:
    """Add the reference checkout to sys.path with dependency stubs installed."""
    for s in _STUBS:
        _stub(s)
    # the reference targets numpy<2 — restore removed aliases it uses
    import numpy as np
    for alias, repl in (("cumproduct", np.cumprod), ("int", int),
                        ("float", float), ("bool", bool), ("object", object)):
        if not hasattr(np, alias):
            setattr(np, alias, repl)
    if str(REFERENCE_ROOT) not in sys.path:
        sys.path.insert(0, str(REFERENCE_ROOT))


def teardown_reference_imports() -> None:
    """Undo `setup_reference_imports`: drop the stub modules and the
    reference's own cached top-level packages so later imports of real
    libraries (e.g. transformers pulling in its optional deps) are clean."""
    for name in list(sys.modules):
        if name in _STUBBED or name.split(".")[0] in _STUBBED:
            del sys.modules[name]
    _STUBBED.clear()
    ref_modules = [n for n, m in sys.modules.items()
                   if getattr(m, "__file__", None)
                   and str(getattr(m, "__file__")).startswith(str(REFERENCE_ROOT))]
    for name in ref_modules:
        del sys.modules[name]
    if str(REFERENCE_ROOT) in sys.path:
        sys.path.remove(str(REFERENCE_ROOT))


def load_reference_hifigan_generator(cfg):
    """Instantiate the reference HiFi-GAN Generator with our config values."""
    setup_reference_imports()
    from types import SimpleNamespace
    from models.vocoder.hifigan.models import Generator as TorchGenerator  # type: ignore
    h = SimpleNamespace(
        resblock=cfg.resblock,
        upsample_rates=list(cfg.upsample_rates),
        upsample_kernel_sizes=list(cfg.upsample_kernel_sizes),
        upsample_initial_channel=cfg.upsample_initial_channel,
        resblock_kernel_sizes=list(cfg.resblock_kernel_sizes),
        resblock_dilation_sizes=[list(d) for d in cfg.resblock_dilation_sizes],
        sampling_rate=cfg.sample_rate,
    )
    return TorchGenerator(h)


def load_reference_wavernn(cfg):
    setup_reference_imports()
    from models.vocoder.wavernn.models.fatchord_version import WaveRNN as TorchWaveRNN  # type: ignore
    return TorchWaveRNN(
        rnn_dims=cfg.rnn_dims, fc_dims=cfg.fc_dims, bits=cfg.bits, pad=cfg.pad,
        upsample_factors=tuple(cfg.upsample_factors), feat_dims=cfg.feat_dims,
        compute_dims=cfg.compute_dims, res_out_dims=cfg.res_out_dims,
        res_blocks=cfg.res_blocks, hop_length=cfg.hop_size,
        sample_rate=cfg.sample_rate, mode=cfg.mode)


def load_reference_encoder():
    setup_reference_imports()
    import torch
    from models.encoder.model import SpeakerEncoder as TorchEncoder  # type: ignore
    return TorchEncoder(torch.device("cpu"), torch.device("cpu"))


def load_reference_tacotron(cfg):
    setup_reference_imports()
    from models.synthesizer.models.tacotron import Tacotron as TorchTacotron  # type: ignore
    return TorchTacotron(
        embed_dims=cfg.embed_dims, num_chars=cfg.num_chars,
        encoder_dims=cfg.encoder_dims, decoder_dims=cfg.decoder_dims,
        n_mels=cfg.n_mels, fft_bins=cfg.fft_bins, postnet_dims=cfg.postnet_dims,
        encoder_K=cfg.encoder_K, lstm_dims=cfg.lstm_dims, postnet_K=cfg.postnet_K,
        num_highways=cfg.num_highways, dropout=cfg.dropout,
        stop_threshold=cfg.stop_threshold,
        speaker_embedding_size=cfg.speaker_embedding_size)


def load_reference_vits(cfg):
    """Instantiate the reference Vits (`models/synthesizer/models/vits.py:389`)
    with our config values."""
    setup_reference_imports()
    from models.synthesizer.models.vits import Vits as TorchVits  # type: ignore
    return TorchVits(
        n_vocab=cfg.n_vocab, spec_channels=cfg.spec_channels,
        segment_size=cfg.segment_size // cfg.hop_size,
        inter_channels=cfg.inter_channels, hidden_channels=cfg.hidden_channels,
        filter_channels=cfg.filter_channels, n_heads=cfg.n_heads,
        n_layers=cfg.n_layers, kernel_size=cfg.kernel_size,
        p_dropout=cfg.p_dropout, resblock=cfg.resblock,
        resblock_kernel_sizes=list(cfg.resblock_kernel_sizes),
        resblock_dilation_sizes=[list(d) for d in cfg.resblock_dilation_sizes],
        upsample_rates=list(cfg.upsample_rates),
        upsample_initial_channel=cfg.upsample_initial_channel,
        upsample_kernel_sizes=list(cfg.upsample_kernel_sizes),
        n_speakers=cfg.n_speakers, gin_channels=cfg.gin_channels,
        use_sdp=cfg.use_sdp)


def load_reference_fregan(cfg):
    """Instantiate the reference FreGAN generator (`fregan/generator.py:79`)."""
    setup_reference_imports()
    from types import SimpleNamespace
    from models.vocoder.fregan.generator import FreGAN as TorchFreGAN  # type: ignore
    h = SimpleNamespace(
        resblock=cfg.resblock,
        upsample_rates=list(cfg.upsample_rates),
        upsample_kernel_sizes=list(cfg.upsample_kernel_sizes),
        upsample_initial_channel=cfg.upsample_initial_channel,
        resblock_kernel_sizes=list(cfg.resblock_kernel_sizes),
        resblock_dilation_sizes=[list(d) for d in cfg.resblock_dilation_sizes],
        sampling_rate=cfg.sample_rate,
    )
    return TorchFreGAN(h, top_k=cfg.top_k)


def load_reference_conformer(cfg, input_layer: str = "linear"):
    """Instantiate the reference ConformerEncoder
    (`ppg_extractor/encoder/conformer_encoder.py:31`) with our config."""
    setup_reference_imports()
    from models.ppg_extractor.encoder.conformer_encoder import (  # type: ignore
        ConformerEncoder as TorchConformer)
    return TorchConformer(
        input_size=cfg.num_mels, attention_dim=cfg.output_size,
        attention_heads=cfg.attention_heads, linear_units=cfg.linear_units,
        num_blocks=cfg.num_blocks, dropout_rate=cfg.dropout_rate,
        positional_dropout_rate=cfg.dropout_rate, attention_dropout_rate=0.0,
        input_layer="linear" if input_layer == "linear" else "conv2d",
        no_subsample=True, macaron_style=True, pos_enc_layer_type="rel_pos",
        selfattention_layer_type="rel_selfattn", activation_type="swish",
        use_cnn_module=True, cnn_module_kernel=cfg.cnn_kernel)


def load_reference_ppg2mel(cfg):
    """Instantiate the reference MelDecoderMOLv2 (`ppg2mel/__init__.py:20`)."""
    setup_reference_imports()
    from models.ppg2mel import MelDecoderMOLv2 as TorchP2M  # type: ignore
    return TorchP2M(
        num_speakers=cfg.num_speakers, spk_embed_dim=cfg.spk_embed_dim,
        bottle_neck_feature_dim=cfg.bottle_neck_feature_dim,
        encoder_dim=cfg.encoder_dim,
        encoder_downsample_rates=list(cfg.encoder_downsample_rates),
        attention_rnn_dim=cfg.attention_rnn_dim,
        decoder_rnn_dim=cfg.decoder_rnn_dim,
        num_decoder_rnn_layer=cfg.num_decoder_rnn_layer,
        concat_context_to_last=cfg.concat_context_to_last,
        prenet_dims=list(cfg.prenet_dims),
        num_mixtures=cfg.num_mixtures,
        frames_per_step=cfg.frames_per_step)
