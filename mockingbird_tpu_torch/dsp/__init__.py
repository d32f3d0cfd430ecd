"""Signal processing: host numpy/scipy (``audio``, ``mel``, ``logmmse``, the
numpy half of ``mulaw``: copies of the JAX package's framework-free modules)
and device torch (``stft``, ``mulaw.encode_mulaw8_device``)."""
from .mel import mel_filterbank, hz_to_mel, mel_to_hz  # noqa: F401
from .stft import (  # noqa: F401
    stft, stft_magnitude, frame, istft, melspectrogram, linearspectrogram, mel_encoder,
    preemphasis, inv_preemphasis, amp_to_db, db_to_amp, normalize_db, denormalize_db,
    inv_mel_spectrogram, griffin_lim, spsi, spectrogram_vits, spec_to_mel_vits, mel_vits,
)
from .audio import (  # noqa: F401
    load_wav, save_wav, resample, normalize_volume, rescale_peak,
    preemphasis_np, inv_preemphasis_np, trim_long_silences, preprocess_wav,
)
from .mulaw import (encode_mu_law, decode_mu_law, label_2_float,  # noqa: F401
                    float_2_label, encode_mulaw8_device, decode_mulaw8_to_int16)
