"""Signal processing: host numpy/scipy (``audio``, ``mel``, ``mulaw``, copies
of the JAX package's framework-free modules) and device torch (``stft``)."""
from .mel import mel_filterbank, hz_to_mel, mel_to_hz  # noqa: F401
from .stft import (  # noqa: F401
    stft, stft_magnitude, frame, melspectrogram, mel_encoder,
    preemphasis, amp_to_db, normalize_db, spectrogram_vits, spec_to_mel_vits, mel_vits,
)
from .audio import (  # noqa: F401
    load_wav, save_wav, resample, normalize_volume, rescale_peak,
    preemphasis_np, inv_preemphasis_np, trim_long_silences, preprocess_wav,
)
from .mulaw import decode_mu_law, label_2_float  # noqa: F401
