"""F0 estimation + continuous-lf0/UV transforms (host-side numpy).

A copy of ``mockingbird_tpu/dsp/f0.py`` (the port imports nothing of the JAX
package). A functional replacement for the reference's pyworld-harvest
pipeline (`utils/f0_utils.py:14-124`): `compute_f0` here is a
normalized-autocorrelation pitch tracker (10 ms frames, 80–600 Hz search
band, energy+clarity voicing decision with median smoothing). The lf0/UV
conversion utilities mirror the reference exactly.
"""
from __future__ import annotations

import numpy as np
from scipy.interpolate import interp1d


def compute_f0(wav: np.ndarray, sr: int = 16000, frame_period: float = 10.0,
               f0_floor: float = 80.0, f0_ceil: float = 600.0) -> np.ndarray:
    """Frame-rate F0 track, 0 for unvoiced (`f0_utils.py:14-19` contract).

    Fully vectorised over frames: one strided frame gather, one batched FFT
    autocorrelation, vectorised peak refinement and voicing — no per-frame
    Python loop (a real VC corpus is minutes of audio per utterance).
    """
    wav = np.asarray(wav, np.float64)
    hop = int(sr * frame_period / 1000)
    win = int(sr * 0.04)  # 40 ms analysis window
    n_frames = max(1, int(np.ceil((len(wav) + 1) / hop)))
    pad = win // 2
    x = np.pad(wav, (pad, win))

    lag_min = int(sr / f0_ceil)
    lag_max = min(int(sr / f0_floor), win - 1)
    rms_all = np.sqrt(np.mean(wav**2) + 1e-12)

    idx = np.arange(n_frames)[:, None] * hop + np.arange(win)[None, :]
    segs = x[idx]
    segs = segs - segs.mean(axis=1, keepdims=True)
    rms = np.sqrt(np.mean(segs**2, axis=1) + 1e-12)

    # normalized autocorrelation via batched FFT
    n_fft = int(2 ** np.ceil(np.log2(2 * win)))
    spec = np.fft.rfft(segs, n_fft, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), axis=1)[:, : lag_max + 1]
    valid = (rms >= 0.05 * rms_all) & (ac[:, 0] > 0)
    nac = ac / np.where(ac[:, :1] > 0, ac[:, :1], 1.0)

    rows = np.arange(n_frames)
    k = np.argmax(nac[:, lag_min : lag_max + 1], axis=1) + lag_min
    # parabolic interpolation around the peak
    a = nac[rows, np.maximum(k - 1, 0)]
    b = nac[rows, k]
    c = nac[rows, np.minimum(k + 1, lag_max)]
    denom = a - 2 * b + c
    interp_ok = (k >= 1) & (k < lag_max) & (np.abs(denom) > 1e-12)
    shift = np.where(interp_ok, 0.5 * (a - c) / np.where(interp_ok, denom, 1.0), 0.0)
    k_ref = k + np.clip(shift, -1, 1)

    clarity = np.where(valid, b, 0.0)
    f0 = np.where(valid & (clarity > 0.5), sr / k_ref, 0.0).astype(np.float32)

    # 3-tap median smoothing over the voiced neighbours (octave-glitch killer);
    # np.median of a 2-element window is their mean, as in the loop original
    if n_frames > 2:
        l, m, r = f0[:-2], f0[1:-1], f0[2:]
        lp, rp = l > 0, r > 0
        med3 = np.maximum(np.minimum(l, m), np.minimum(np.maximum(l, m), r))
        smoothed = np.where(lp & rp, med3,
                            np.where(lp, (l + m) / 2,
                                     np.where(rp, (m + r) / 2, m)))
        f0s = f0.copy()
        f0s[1:-1] = np.where(m > 0, smoothed, f0[1:-1])
        return f0s.astype(np.float32)
    return f0


# -- lf0 / UV transforms (parity: `f0_utils.py:21-124`) ----------------------

def compute_mean_std(lf0: np.ndarray):
    nonzero = np.nonzero(lf0)
    if len(nonzero[0]) == 0:
        return 0.0, 1.0
    return float(np.mean(lf0[nonzero])), float(np.std(lf0[nonzero]) + 1e-8)


def f02lf0(f0: np.ndarray) -> np.ndarray:
    lf0 = f0.copy()
    nz = np.nonzero(f0)
    lf0[nz] = np.log(f0[nz])
    return lf0


def convert_continuous_f0(f0: np.ndarray):
    """F0 → (uv mask, linearly interpolated continuous f0)."""
    uv = np.float32(f0 != 0)
    if (f0 == 0).all():
        return uv, f0
    f0 = f0.copy()
    start_f0 = f0[f0 != 0][0]
    end_f0 = f0[f0 != 0][-1]
    start_idx = np.where(f0 == start_f0)[0][0]
    end_idx = np.where(f0 == end_f0)[0][-1]
    f0[:start_idx] = start_f0
    f0[end_idx:] = end_f0
    nz = np.where(f0 != 0)[0]
    cont = interp1d(nz, f0[nz])(np.arange(len(f0)))
    return uv, cont


def get_cont_lf0(f0: np.ndarray, frame_period: float = 10.0):
    uv, cont_f0 = convert_continuous_f0(f0)
    cont_lf0 = cont_f0.copy()
    cont_lf0[cont_f0 > 0] = np.log(cont_f0[cont_f0 > 0])
    return uv, cont_lf0


def get_converted_lf0uv(wav: np.ndarray, lf0_mean_trg: float, lf0_std_trg: float,
                        convert: bool = True, sr: int = 16000) -> np.ndarray:
    """Source wav → (T, 2) [continuous lf0 converted to target stats, uv]
    (`f0_utils.py:27-49`)."""
    f0_src = compute_f0(wav, sr)
    if not convert:
        uv, cont_lf0 = get_cont_lf0(f0_src)
        return np.stack([cont_lf0, uv], axis=1).astype(np.float32)

    lf0_src = f02lf0(f0_src)
    lf0_mean_src, lf0_std_src = compute_mean_std(lf0_src)
    lf0_vc = lf0_src.copy()
    mask = lf0_src > 0.0
    lf0_vc[mask] = ((lf0_src[mask] - lf0_mean_src) / lf0_std_src
                    * lf0_std_trg + lf0_mean_trg)
    f0_vc = lf0_vc.copy()
    f0_vc[mask] = np.exp(lf0_vc[mask])

    uv, cont_lf0_vc = get_cont_lf0(f0_vc)
    return np.stack([cont_lf0_vc, uv], axis=1).astype(np.float32)
