"""The multi-resolution STFT loss written plainly, as MB-iSTFT-VITS applies it
to PQMF sub-bands (``stft_loss.py``, from ParallelWaveGAN by Tomoki Hayashi,
and ``losses.py::subband_stft_loss`` of github.com/MasayaKawamura/MB-iSTFT-VITS).

For each resolution (FFT size, hop, window length): the magnitude of
``torch.stft`` with a Hann window of the window length (centred frames,
reflect padding), sqrt(clamp(re^2 + im^2, 1e-7)); the spectral convergence
||mag_y - mag_x||_F / ||mag_y||_F over the whole batch and the log-magnitude
L1, mean |log mag_y - log mag_x|; each averaged over the resolutions.
``subband_stft_loss`` views the real and generated sub-bands [B, N, T] as
B * N signals, cuts the generated to the real's length and returns the sum
of the two averages.

Departures from the published code: ``torch.stft`` is called with
``return_complex=True`` and its real and imaginary parts taken (the
published code predates that argument); the window is made on the input's
device. ``sc_parts`` splits the spectral convergence into the squared norms
it divides, for a step computed a block of rows at a time.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


def stft(x, fft_size, hop_size, win_length, window):
    """x [N, T] -> magnitude [N, frames, fft_size // 2 + 1]."""
    x_stft = torch.stft(x, fft_size, hop_size, win_length, window.to(x.device),
                        return_complex=True)
    real = x_stft.real
    imag = x_stft.imag
    # NOTE(kan-bayashi): clamp is needed to avoid nan or inf
    return torch.sqrt(torch.clamp(real**2 + imag**2, min=1e-7)).transpose(2, 1)


class STFTLoss(torch.nn.Module):
    def __init__(self, fft_size=1024, shift_size=120, win_length=600, window="hann_window"):
        super().__init__()
        self.fft_size = fft_size
        self.shift_size = shift_size
        self.win_length = win_length
        self.window = getattr(torch, window)(win_length)

    def magnitudes(self, x, y):
        return (stft(x, self.fft_size, self.shift_size, self.win_length, self.window),
                stft(y, self.fft_size, self.shift_size, self.win_length, self.window))

    def forward(self, x, y):
        """x: generated, y: real, both [N, T] -> (spectral convergence,
        log STFT magnitude loss)."""
        x_mag, y_mag = self.magnitudes(x, y)
        sc_loss = torch.norm(y_mag - x_mag, p="fro") / torch.norm(y_mag, p="fro")
        mag_loss = F.l1_loss(torch.log(y_mag), torch.log(x_mag))
        return sc_loss, mag_loss


class MultiResolutionSTFTLoss(torch.nn.Module):
    def __init__(self, fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                 win_lengths=(600, 1200, 240), window="hann_window"):
        super().__init__()
        assert len(fft_sizes) == len(hop_sizes) == len(win_lengths)
        self.stft_losses = torch.nn.ModuleList(
            STFTLoss(fs, ss, wl, window) for fs, ss, wl in zip(fft_sizes, hop_sizes, win_lengths))

    def forward(self, x, y):
        sc_loss = 0.0
        mag_loss = 0.0
        for f in self.stft_losses:
            sc_l, mag_l = f(x, y)
            sc_loss += sc_l
            mag_loss += mag_l
        sc_loss /= len(self.stft_losses)
        mag_loss /= len(self.stft_losses)
        return sc_loss, mag_loss

    def sc_parts(self, x, y):
        """Each resolution's (||mag_y - mag_x||_F^2, ||mag_y||_F^2)."""
        out = []
        for f in self.stft_losses:
            x_mag, y_mag = f.magnitudes(x, y)
            out.append((torch.sum((y_mag - x_mag) ** 2), torch.sum(y_mag**2)))
        return out

    def mag_loss(self, x, y):
        """The log-magnitude L1 averaged over the resolutions."""
        return sum(F.l1_loss(torch.log(y_mag), torch.log(x_mag))
                   for x_mag, y_mag in (f.magnitudes(x, y) for f in self.stft_losses)) \
            / len(self.stft_losses)


def flat(y_mb, y_hat_mb):
    """[B, N, T] real and [B, N, T'] generated sub-bands -> (generated cut to
    T, real), each [B * N, T]."""
    y_mb = y_mb.reshape(-1, y_mb.size(2))
    y_hat_mb = y_hat_mb.reshape(-1, y_hat_mb.size(2))
    return y_hat_mb[:, : y_mb.size(-1)], y_mb


def subband_stft_loss(h, y_mb, y_hat_mb):
    """MB-iSTFT-VITS's sub-band loss at the configuration's resolutions."""
    sub_stft_loss = MultiResolutionSTFTLoss(h.train.fft_sizes, h.train.hop_sizes,
                                            h.train.win_lengths)
    sub_sc_loss, sub_mag_loss = sub_stft_loss(*flat(y_mb, y_hat_mb))
    return sub_sc_loss + sub_mag_loss
