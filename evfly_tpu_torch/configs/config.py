"""Config files of the reference learner: ``key = value`` text, ``[a, b]`` lists.

A copy of ``evfly_tpu/configs/config.py`` (the port imports nothing of the
JAX package), so the same ``.txt`` files drive training, offline eval and
deployment in both packages.  It parses those files into a typed
dataclass, keeping every flag name, default, and list/scalar normalization
quirk the reference relies on:

* ``nargs='+'`` flags parse to lists; a bare token parses to a 1-list.
* ``model_type`` of length 1 collapses to a string (learner.py:339-340).
* ``checkpoint_path`` is append-style: always a list after parsing; a 1-list
  collapses to its element (learner.py:232-233).
* booleans accept True/False/1/0 (store_true flags in config files).

The one addition is ``config_device``: how the port reads ``device``.  The
JAX package's default ``tpu`` stays the default, so the repo's config files
keep working: ``tpu``, ``gpu`` and ``cuda`` all mean the CUDA card.
"""

from __future__ import annotations

import dataclasses
import shlex
import sys
from dataclasses import dataclass, field
from typing import Any, List, Optional, Union


def _parse_scalar(tok: str, typ):
    if typ is bool:
        return tok.strip().lower() in ("true", "1", "yes")
    if typ is int:
        return int(float(tok))
    return typ(tok)


def _parse_value(raw: str, typ, nargs: bool):
    raw = raw.strip()
    if raw.startswith("[") and raw.endswith("]"):
        inner = raw[1:-1].strip()
        toks = [t.strip() for t in inner.split(",")] if inner else []
        vals = [_parse_scalar(t.strip("'\""), typ) for t in toks if t != ""]
        return vals
    raw = raw.strip("'\"")
    if nargs:
        if raw == "":
            # e.g. ``checkpoint_path = ''`` -> [''] (appended empty value)
            return [""] if typ is str else None
        if raw.lower() == "none":
            return None
        # space-separated multi-token values also allowed
        toks = raw.split()
        if len(toks) > 1:
            return [_parse_scalar(t, typ) for t in toks]
        return [_parse_scalar(raw, typ)]
    if raw.lower() == "none":
        return None
    return _parse_scalar(raw, typ)


# (type, is_list, default) per flag — mirrors learner.py:1167-1272.
_SPEC = {
    "config": (str, False, None),
    "basedir": (str, False, "."),
    "logdir": (str, False, "learner/logs"),
    "datadir": (str, False, "data/datasets"),
    "ws_suffix": (str, False, ""),
    "model_type": (str, True, ["LSTMNet"]),
    "velpred": (int, False, 0),
    "dataset": (str, True, None),
    "use_h5": (bool, False, False),
    "short": (int, False, 0),
    "val_split": (float, False, 0.2),
    "seed": (int, False, None),
    "batch_size": (int, False, 0),
    "device": (str, False, "tpu"),
    "load_trainval": (bool, False, False),
    "checkpoint_path": (str, True, None),
    "lr": (float, False, 1e-4),
    "N_eps": (int, False, 100),
    "lr_warmup_epochs": (int, False, 5),
    "lr_decay": (bool, False, False),
    "save_model_freq": (int, False, 25),
    "val_freq": (int, False, 10),
    "optional_loss_param": (float, True, None),
    "num_recurrent": (int, True, [0]),
    "events": (str, False, ""),
    "keep_collisions": (bool, False, False),
    "do_transform": (bool, False, False),
    "eval_tools_freq": (int, False, 0),
    "eval_tools_on_best": (bool, False, False),
    "print_trainprogress_freq": (int, False, 1),
    # chunk-level data parallelism (parallel/): dp_devices > 0 trains
    # dp_devices x dp_chunks_per_device chunks per Adam step, one process
    # per card (dp_devices > 1 under torchrun)
    "dp_devices": (int, False, 0),
    "dp_chunks_per_device": (int, False, 1),
    # the JAX package's dispatch layouts of one epoch (a trajectory or the
    # whole epoch in one device program); parsed and accepted, the port runs
    # the same chunk steps one by one either way (ROADMAP §3)
    "traj_scan": (bool, False, True),
    "epoch_scan": (bool, False, True),
    "scan_group": (int, False, 0),
    # store the device-resident training frames quantized (int8 events in
    # [-1,1]/127 steps, uint8 depths in [0,1]/255 steps) instead of bf16:
    # error <= 1/254 per value. Off by default.
    "device_data_quantized": (bool, False, False),
    # V(phi) pretraining aid: transform depth inputs by clip(scale*x, 0, 1)
    # so standalone depth->velocity training sees the composite's
    # clip(2*depth, 0, 1) input distribution (learner_models.py:634).
    "input_frame_scale": (float, False, 1.0),
    "num_out_channels": (int, False, 1),
    "num_in_channels": (int, False, 2),
    "resize_input": (int, True, None),
    "loss_weights": (float, True, None),
    "split_method": (str, False, "train-val"),
    "num_outputs": (int, False, 2),
    "rescale_depth": (float, False, 0.0),
    "rescale_evs": (float, False, 0.0),
    "domain_randomization": (float, False, 0.0),
    "bev": (int, False, 0),
    "skip_type": (str, False, "crop"),
    "combine_checkpoints": (bool, False, False),
    "data_augmentation": (float, False, 0.0),
    "evs_min_cutoff": (float, False, 0.0),
    # encoder
    "enc_num_layers": (int, False, 2),
    "enc_kernel_sizes": (int, True, [5, 5]),
    "enc_kernel_strides": (int, True, [2, 2]),
    "enc_out_channels": (int, True, [16, 64]),
    "enc_activations": (str, True, ["relu", "relu"]),
    "enc_pool_type": (str, False, "max"),
    "enc_invert_pool_inputs": (bool, False, False),
    "enc_pool_kernels": (int, True, [2, 2]),
    "enc_pool_strides": (int, True, [2, 2]),
    "enc_conv_function": (str, False, "conv2d"),
    # decoder
    "dec_num_layers": (int, False, 2),
    "dec_kernel_sizes": (int, True, [5, 5]),
    "dec_kernel_strides": (int, True, [2, 2]),
    "dec_out_channels": (int, True, [64, 16]),
    "dec_activations": (str, True, ["relu", "sigmoid"]),
    "dec_pool_type": (str, False, "max"),
    "dec_pool_kernels": (int, True, [2, 2]),
    "dec_pool_strides": (int, True, [2, 2]),
    "dec_conv_function": (str, False, "upconv2d"),
    # fc
    "fc_num_layers": (int, False, 3),
    "fc_layer_sizes": (int, True, [128, 32, 1]),
    "fc_activations": (str, True, ["leaky_relu", "leaky_relu", "tanh"]),
    "fc_dropout_p": (float, False, 0.1),
    # deployment-compat flags (parsed, mostly unused in training)
    "align_evframe": (bool, False, False),
    "vision_based": (bool, False, False),
    "ppo_path": (str, False, None),
    "model_path": (str, False, None),
    "keyboard": (bool, False, False),
    "planner": (bool, False, False),
}


@dataclass
class EvflyConfig:
    """Typed view of the reference's ~70 training/eval/deployment flags."""

    # populated dynamically from _SPEC in __init__ below
    def __init__(self, **kwargs):
        for name, (_typ, _is_list, default) in _SPEC.items():
            val = kwargs.pop(name, default)
            if isinstance(default, list) and val is default:
                val = list(default)
            setattr(self, name, val)
        if kwargs:
            raise TypeError(f"Unknown config keys: {sorted(kwargs)}")

    def __repr__(self):  # stable, sorted, diffable
        items = ", ".join(f"{k}={getattr(self, k)!r}" for k in sorted(_SPEC))
        return f"EvflyConfig({items})"

    def to_dict(self):
        return {k: getattr(self, k) for k in _SPEC}

    # --- normalizations the reference Learner applies (learner.py:196-240) ---

    @property
    def model_type_norm(self) -> Union[str, List[str]]:
        mt = self.model_type
        if isinstance(mt, list) and len(mt) == 1:
            return mt[0]
        return mt

    @property
    def checkpoint_path_norm(self):
        cp = self.checkpoint_path
        if isinstance(cp, list) and len(cp) == 1:
            return cp[0]
        return cp

    @property
    def events_filename(self) -> str:
        """'evs_frames' -> 'evs_frames.npy' (learner.py:235-239)."""
        ev = self.events
        if ev != "" and "." not in ev:
            ev = ev + ("_tf.npy" if self.do_transform else ".npy")
        return ev


def parse_config_file(path: str, overrides: Optional[dict] = None) -> EvflyConfig:
    """Parse a reference-format ``key = value`` config .txt into EvflyConfig."""
    values: dict = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, raw = line.split("=", 1)
            key = key.strip().lstrip("-")
            if key not in _SPEC:
                # unknown keys tolerated, like parse_known_args (learner.py:1268)
                continue
            typ, is_list, _default = _SPEC[key]
            values[key] = _parse_value(raw, typ, is_list)
    values["config"] = path
    if overrides:
        values.update(overrides)
    return EvflyConfig(**values)


def argparsing(argv: Optional[List[str]] = None, filename: Optional[str] = None) -> EvflyConfig:
    """CLI-compatible entrypoint: ``--config file.txt [--key value ...]``.

    Mirrors the reference `argparsing()` (learner.py:1167): the config file
    provides defaults, explicit CLI flags override.
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg_path = filename
    overrides: dict = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            i += 1
            continue
        key = tok[2:]
        val_toks = []
        j = i + 1
        while j < len(argv) and not argv[j].startswith("--"):
            val_toks.append(argv[j])
            j += 1
        if key == "config":
            cfg_path = val_toks[0] if val_toks else cfg_path
        elif key in _SPEC:
            typ, is_list, _default = _SPEC[key]
            if not val_toks:  # store_true style
                overrides[key] = True
            else:
                raw = " ".join(val_toks)
                overrides[key] = _parse_value(raw, typ, is_list)
        i = j
    if cfg_path is None:
        raise ValueError("No --config provided")
    return parse_config_file(cfg_path, overrides)


CARD_DEVICES = ("tpu", "gpu", "cuda")


def config_device(device: Optional[str]) -> str:
    """The torch device a config's ``device`` names: ``"cuda"`` for
    ``tpu``, ``gpu`` or ``cuda`` (the accelerator of either package; None
    too, the JAX package's default being ``tpu``), ``"cpu"`` for ``cpu``.
    Anything else raises."""
    name = "tpu" if device is None else str(device).strip().lower()
    if name in CARD_DEVICES:
        return "cuda"
    if name == "cpu":
        return "cpu"
    raise ValueError(f"device = {device!r}: the port reads {CARD_DEVICES} as the card "
                     "and 'cpu' as the CPU")
