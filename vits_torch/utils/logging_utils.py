"""Run-dir logging, TensorBoard summaries, git-hash guard, mel plotting (port
of ``vits_tpu/utils/logging_utils.py``).

Behavioral reference: reference utils.py:119-130 (summarize), :141-167
(mel->image), :220-268 (git hash guard, per-model-dir file logger).

``tensorboard`` and ``matplotlib`` are optional here: where
``torch.utils.tensorboard`` does not import, ``make_writer`` returns a
``NullWriter`` that drops every summary and names that once in the run's
log; where ``matplotlib`` does not import, ``plot_spectrogram_to_numpy``
raises ``ImportError`` and ``have_matplotlib`` says so beforehand. Nothing on
the device depends on either.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import subprocess

import numpy as np


def get_logger(model_dir: str, filename: str = "train.log") -> logging.Logger:
    logger = logging.getLogger(os.path.basename(os.path.abspath(model_dir)))
    logger.setLevel(logging.DEBUG)
    if not logger.handlers:
        os.makedirs(model_dir, exist_ok=True)
        h = logging.FileHandler(os.path.join(model_dir, filename))
        h.setLevel(logging.DEBUG)
        h.setFormatter(
            logging.Formatter("%(asctime)s\t%(name)s\t%(levelname)s\t%(message)s")
        )
        logger.addHandler(h)
    return logger


def check_git_hash(model_dir: str, logger: logging.Logger | None = None) -> None:
    """Record the git hash on first run; warn if it drifts on resume
    (reference utils.py:220-249)."""
    source_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if not os.path.exists(os.path.join(source_dir, ".git")):
        return
    try:
        cur_hash = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=source_dir,
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return
    path = os.path.join(model_dir, "githash")
    if os.path.exists(path):
        with open(path) as f:
            saved = f.read().strip()
        if saved != cur_hash and logger is not None:
            logger.warning("git hash mismatch: saved %s vs current %s",
                           saved[:8], cur_hash[:8])
    else:
        os.makedirs(model_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(cur_hash)


class NullWriter:
    """A SummaryWriter's surface that writes nothing (no tensorboard)."""

    def add_scalar(self, *args, **kwargs):
        pass

    def add_image(self, *args, **kwargs):
        pass

    def add_audio(self, *args, **kwargs):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def make_writer(model_dir: str, logger: logging.Logger | None = None):
    """TensorBoard writer. torch's implementation encodes audio without the
    optional `soundfile` dependency that tensorboardX requires. Without
    tensorboard: a ``NullWriter``, named once in ``logger``."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        if logger is not None:
            logger.warning("no TensorBoard summaries (scalars, images, audio) are "
                           "written: torch.utils.tensorboard does not import (%s)", e)
        return NullWriter()
    return SummaryWriter(log_dir=model_dir)


def summarize(
    writer,
    global_step: int,
    scalars: dict | None = None,
    images: dict | None = None,
    audios: dict | None = None,
    audio_sampling_rate: int = 22050,
):
    """Reference utils.py:119-130."""
    for k, v in (scalars or {}).items():
        writer.add_scalar(k, float(v), global_step)
    for k, v in (images or {}).items():
        writer.add_image(k, v, global_step, dataformats="HWC")
    for k, v in (audios or {}).items():
        writer.add_audio(k, v, global_step, audio_sampling_rate)


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def plot_spectrogram_to_numpy(spectrogram: np.ndarray) -> np.ndarray:
    """[F, T] or [T, F] mel -> HWC uint8 image (reference utils.py:141-167)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    spec = np.asarray(spectrogram)
    if spec.shape[0] > spec.shape[1]:  # [T, F] -> [F, T]
        spec = spec.T
    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(spec, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.tight_layout()
    fig.canvas.draw()
    data = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    data = data.reshape(fig.canvas.get_width_height()[::-1] + (4,))[..., :3]
    plt.close(fig)
    return data
