"""Model construction from a config: the reference's ``model_type`` dispatch
(learner.py:336-405), as ``evfly_tpu/models/registry.py``, for the families
the port has:

  'OrigUNet' (velpred 0)               -> OrigUNet
  ['OrigUNet', 'VITFLY_ViTLSTM']       -> OrigUNet_w_VITFLY_ViTLSTM
  'VITFLY_ViTLSTM' / 'LSTMNetVIT'      -> LSTMNetVIT

The other vitfly models and composites raise ``NotImplementedError``
naming the ROADMAP item that ports them; ``OrigUNet`` with a velocity head
(velpred > 0) raises in its constructor.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs import EvflyConfig
from ..device import DeviceLike
from .composites import OrigUNet_w_VITFLY_ViTLSTM
from .origunet import OrigUNet
from .vitfly import LSTMNetVIT


def enc_params_from_config(cfg: EvflyConfig) -> dict:
    return {
        "num_layers": cfg.enc_num_layers,
        "kernel_sizes": cfg.enc_kernel_sizes,
        "kernel_strides": cfg.enc_kernel_strides,
        "out_channels": cfg.enc_out_channels,
        "activations": cfg.enc_activations,
        "pool_type": cfg.enc_pool_type,
        "invert_pool_inputs": cfg.enc_invert_pool_inputs,
        "pool_kernels": cfg.enc_pool_kernels,
        "pool_strides": cfg.enc_pool_strides,
        "conv_function": cfg.enc_conv_function,
    }


def dec_params_from_config(cfg: EvflyConfig) -> dict:
    return {
        "num_layers": cfg.dec_num_layers,
        "kernel_sizes": cfg.dec_kernel_sizes,
        "kernel_strides": cfg.dec_kernel_strides,
        "out_channels": cfg.dec_out_channels,
        "activations": cfg.dec_activations,
        "pool_type": cfg.dec_pool_type,
        "pool_kernels": cfg.dec_pool_kernels,
        "pool_strides": cfg.dec_pool_strides,
        "conv_function": cfg.dec_conv_function,
    }


def fc_params_from_config(cfg: EvflyConfig) -> dict:
    return {
        "num_layers": cfg.fc_num_layers,
        "layer_sizes": cfg.fc_layer_sizes,
        "activations": cfg.fc_activations,
        "dropout_p": cfg.fc_dropout_p,
    }


_VITLSTM = ("VITFLY_ViTLSTM", "LSTMNetVIT")
# model types of the JAX package the port does not build yet -> ROADMAP item
_NOT_PORTED = {
    "VITFLY_ViT": 4, "ViT": 4, "VITFLY_LSTMNet": 4, "LSTMNet": 4,
    "VITFLY_ConvNet": 4, "ConvNet": 4, "VITFLY_UNetConvLSTMNet": 4, "UNetConvLSTMNet": 4,
    "ConvNet_w_VelPred": 3,
}


def _not_ported(mt, item: int) -> NotImplementedError:
    what = ("the velocity heads (models/layers.py) and the composites on them"
            if item == 3 else "the rest of the model zoo")
    return NotImplementedError(
        f"model_type {mt!r} is not ported yet: ROADMAP §1 item {item} ({what})")


def build_model(cfg: EvflyConfig, is_deployment: bool = False, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None):
    """The model ``cfg.model_type`` names, on ``device`` (the card unless
    the caller names another), its initial weights drawn from
    ``generator``."""
    mt = cfg.model_type_norm
    resize = cfg.resize_input if cfg.resize_input is not None else [260, 346]
    origunet_kwargs = dict(
        num_in_channels=cfg.num_in_channels,
        num_out_channels=cfg.num_out_channels,
        num_recurrent=cfg.num_recurrent,
        input_shape=[1, 1, resize[0], resize[1]],
        velpred=cfg.velpred,
        form_BEV=cfg.bev,
        is_deployment=is_deployment,
        evs_min_cutoff=cfg.evs_min_cutoff,
        skip_type=cfg.skip_type,
        generator=generator,
        device=device,
    )
    if isinstance(mt, list):
        if mt[0] == "OrigUNet" and mt[1] == "VITFLY_ViTLSTM":
            return OrigUNet_w_VITFLY_ViTLSTM(**origunet_kwargs)
        if mt[0] == "OrigUNet" and mt[1] == "ConvNet_w_VelPred":
            raise _not_ported(mt, 3)
        raise ValueError(f"Multi-model_type {mt} not implemented")
    if mt == "OrigUNet":
        return OrigUNet(**origunet_kwargs)
    if mt in _VITLSTM:
        return LSTMNetVIT(generator=generator, device=device)
    if mt in _NOT_PORTED:
        raise _not_ported(mt, _NOT_PORTED[mt])
    raise ValueError(f"Invalid model_type {mt}")
