"""Model construction from a config: the reference's ``model_type`` dispatch
(learner.py:336-405), as ``evfly_tpu/models/registry.py``:

  'OrigUNet' (velpred 0, 1, 11, 2)     -> OrigUNet
  ['OrigUNet', 'VITFLY_ViTLSTM']       -> OrigUNet_w_VITFLY_ViTLSTM
  ['OrigUNet', 'ConvNet_w_VelPred']    -> OrigUNet_w_ConvNet_w_VelPred
  'VITFLY_ViTLSTM' / 'LSTMNetVIT'      -> LSTMNetVIT
  'VITFLY_ViT' / 'ViT'                 -> ViT
  'VITFLY_LSTMNet' / 'LSTMNet'         -> LSTMNet
  'VITFLY_ConvNet' / 'ConvNet'         -> ConvNet
  'VITFLY_UNetConvLSTMNet' / 'UNetConvLSTMNet' -> UNetConvLSTMNet
  'ConvNet_w_VelPred'                  -> ConvNet_w_VelPred
  'RVT'                                -> RVT (RVT-B at 1 Mpx, models/rvt.py)
  'ERAFT'                              -> ERAFT (E-RAFT at DSEC's 480x640, models/eraft.py)
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs import EvflyConfig
from ..device import DeviceLike
from .composites import (
    ConvNet_w_VelPred,
    OrigUNet_w_ConvNet_w_VelPred,
    OrigUNet_w_VITFLY_ViTLSTM,
)
from .eraft import ERAFT
from .origunet import OrigUNet
from .rvt import RVT
from .vitfly import ConvNet, LSTMNet, LSTMNetVIT, UNetConvLSTMNet, ViT


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


_VITFLY = {
    "VITFLY_ViTLSTM": LSTMNetVIT,
    "LSTMNetVIT": LSTMNetVIT,
    "VITFLY_ViT": ViT,
    "ViT": ViT,
    "VITFLY_LSTMNet": LSTMNet,
    "LSTMNet": LSTMNet,
    "VITFLY_ConvNet": ConvNet,
    "ConvNet": ConvNet,
    "VITFLY_UNetConvLSTMNet": UNetConvLSTMNet,
    "UNetConvLSTMNet": UNetConvLSTMNet,
}


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
        enc_params=enc_params_from_config(cfg),
        fc_params=fc_params_from_config(cfg),
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
            return OrigUNet_w_ConvNet_w_VelPred(num_outputs=cfg.num_outputs, **origunet_kwargs)
        raise ValueError(f"Multi-model_type {mt} not implemented")
    if mt == "OrigUNet":
        return OrigUNet(**origunet_kwargs)
    if mt == "ConvNet_w_VelPred":
        return ConvNet_w_VelPred(
            num_in_channels=1,
            num_recurrent=cfg.num_recurrent[1] if len(cfg.num_recurrent) > 1 else 0,
            num_outputs=cfg.num_outputs,
            enc_params=origunet_kwargs["enc_params"],
            fc_params=origunet_kwargs["fc_params"],
            input_shape=[1, 1, resize[0], resize[1]],
            generator=generator, device=device,
        )
    if mt in _VITFLY:
        return _VITFLY[mt](generator=generator, device=device)
    if mt == "RVT":
        return RVT(generator=generator, device=device)
    if mt == "ERAFT":
        return ERAFT(generator=generator, device=device)
    raise ValueError(f"Invalid model_type {mt}")
