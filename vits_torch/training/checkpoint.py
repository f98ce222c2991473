"""Checkpointing: the dual-artifact convention of the JAX package (port of
``vits_tpu/training/checkpoint.py``) with ``torch.save`` files.

Behavioral reference: reference utils.py:24-116,133-138. ``train_{step}``
holds the full ``TrainState`` (generator, discriminator, both AdamW
``state_dict``s, the step) and the epoch; ``eval_{step}`` holds the
generator only (what serving loads). Resume picks the latest by step;
``keep_ckpts`` prunes older pairs. Each artifact is one file, written to a
temporary name and renamed, and loaded with ``weights_only=True``:

  train_{step}: {"state": {"step", "g_params", "d_params", "g_opt_state",
                 "d_opt_state"}, "epoch"}
  eval_{step}:  {"g_params": generator state_dict}

Partial/shape-safe loading (transfer learning, reference utils.py:73-88) is
provided by ``merge_compatible``: only matching-name, matching-shape entries
are taken from the loaded ``state_dict``.
"""

from __future__ import annotations

import os
import re

import torch

from vits_torch.training.step import TrainState


def _ckpt_steps(model_dir: str, prefix: str) -> list[int]:
    if not os.path.isdir(model_dir):
        return []
    steps = []
    for name in os.listdir(model_dir):
        m = re.fullmatch(rf"{prefix}_(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint(model_dir: str, prefix: str = "train") -> str | None:
    steps = _ckpt_steps(model_dir, prefix)
    if not steps:
        return None
    return os.path.join(model_dir, f"{prefix}_{steps[-1]}")


def _save(obj, path: str) -> int:
    """torch.save to a temporary name, then rename; returns the size."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return os.path.getsize(path)


def save_checkpoint(
    model_dir: str,
    step: int,
    train_state: TrainState,
    epoch: int,
    keep_ckpts: int = 3,
) -> dict[str, int]:
    """Save train_{step} (full state) and eval_{step} (generator only);
    returns {path: bytes}."""
    os.makedirs(model_dir, exist_ok=True)
    s = train_state
    g_params = s.model.state_dict()
    payload_train = {
        "state": {
            "step": int(s.step),
            "g_params": g_params,
            "d_params": s.disc.state_dict(),
            "g_opt_state": s.optim_g.state_dict(),
            "d_opt_state": s.optim_d.state_dict(),
        },
        "epoch": int(epoch),
    }
    sizes = {}
    for prefix, payload in (("train", payload_train), ("eval", {"g_params": g_params})):
        path = os.path.join(model_dir, f"{prefix}_{step}")
        sizes[path] = _save(payload, path)
    if keep_ckpts and keep_ckpts > 0:
        for prefix in ("train", "eval"):
            for old in _ckpt_steps(model_dir, prefix)[:-keep_ckpts]:
                os.remove(os.path.join(model_dir, f"{prefix}_{old}"))
    return sizes


def load_checkpoint(path: str, target: TrainState) -> tuple[TrainState, int]:
    """Restore a train_{step} file into ``target`` in place (models,
    optimizers, step) -> (target, epoch)."""
    payload = torch.load(path, map_location=target.model.device, weights_only=True)
    st = payload["state"]
    target.model.load_state_dict(st["g_params"])
    target.disc.load_state_dict(st["d_params"])
    target.optim_g.load_state_dict(st["g_opt_state"])
    target.optim_d.load_state_dict(st["d_opt_state"])
    target.step = int(st["step"])
    return target, int(payload["epoch"])


def load_eval_params(path: str, map_location="cpu") -> dict[str, torch.Tensor]:
    """The generator ``state_dict`` of an eval_{step} file. A bare generator
    ``state_dict`` saved by ``torch.save`` loads as it is."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    return payload.get("g_params", payload)


def merge_compatible(init_sd: dict, loaded_sd: dict) -> tuple[dict, int, int]:
    """Take entries from loaded_sd where name+shape match init_sd (reference
    utils.py:73-88 partial load) -> (merged, used, skipped)."""
    out = {}
    used, skipped = 0, 0
    for name, value in init_sd.items():
        cand = loaded_sd.get(name)
        if cand is not None and tuple(cand.shape) == tuple(value.shape):
            out[name] = cand
            used += 1
        else:
            out[name] = value
            skipped += 1
    return out, used, skipped
