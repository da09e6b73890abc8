"""Kaiser low-pass filter design for the alias-free (StyleGAN3) synthesis
(counterpart: latentaugment_tpu/models/stylegan3/filters.py; numpy only,
so the same code).

Each synthesis layer carries windowed-sinc up/down FIRs whose
cutoff/width follow the layer's sampling-rate plan
(networks.generator_config):
  * 1-D separable taps for ordinary layers,
  * 2-D radially symmetric (jinc) taps for the non-critically-sampled
    layers of translation-rotation-equivariant configs,
  * numtaps == 1 -> None (identity; filtered_lrelu treats None as [1]).

Everything here runs once at config/init time on the host.
"""

import numpy as np


def kaiser_attenuation(numtaps, width_over_nyquist):
    """Stopband attenuation (dB) reachable by a Kaiser window of length
    `numtaps` with transition width `width_over_nyquist` (= width / (fs/2))."""
    return 2.285 * (numtaps - 1) * np.pi * width_over_nyquist + 7.95


def kaiser_beta(attenuation_db):
    """Kaiser shape parameter for a target stopband attenuation (dB)."""
    a = float(attenuation_db)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def _bessel_j1(x):
    """First-order Bessel J1 on a numpy array (scipy if present, else torch)."""
    try:
        from scipy.special import j1

        return j1(x)
    except ImportError:
        import torch

        return torch.special.bessel_j1(torch.as_tensor(np.asarray(x))).numpy()


def design_lowpass_filter(numtaps, cutoff, width, fs, radial=False):
    """Design one layer's FIR. Returns float32 taps, or None for identity.

    Args:
      numtaps: filter length (even in practice: filter_size * up/down factor).
      cutoff: passband edge (half-amplitude point), in units of fs.
      width: transition-band width, in units of fs.
      fs: sampling rate of the signal the filter runs at.
      radial: design a 2-D radially symmetric jinc filter instead of 1-D
        separable taps (rotation-equivariant configs only).
    """
    numtaps = int(numtaps)
    assert numtaps >= 1
    if numtaps == 1:
        return None

    beta = kaiser_beta(kaiser_attenuation(numtaps, width / (fs / 2)))
    if not radial:
        # Kaiser-windowed sinc, unity DC gain — scipy.signal.firwin(
        # numtaps, cutoff, width=width, fs=fs) designs exactly this.
        m = np.arange(numtaps) - (numtaps - 1) / 2
        h = np.sinc(2 * cutoff / fs * m) * np.kaiser(numtaps, beta)
        return (h / h.sum()).astype(np.float32)

    # Radial: jinc (first-order Bessel) profile with a separable Kaiser
    # window, normalized to unity DC gain. The r -> 0 limit of
    # J1(2*pi*c*r)/(pi*r) is c.
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(invalid="ignore", divide="ignore"):
        f = _bessel_j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    f = np.where(r == 0, cutoff, f)
    w = np.kaiser(numtaps, beta)
    f = f * np.outer(w, w)
    return (f / f.sum()).astype(np.float32)
