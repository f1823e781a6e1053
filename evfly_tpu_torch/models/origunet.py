"""D(theta): the events -> depth ``OrigUNet``, with its ConvLSTM bottleneck
and its optional velocity head.

Port of ``evfly_tpu/models/origunet.py`` (reference learner_models.py:339-616):

* a 5-level valid-padding UNet on 260x346 inputs, channels 32 -> 512, the
  bottleneck (512, 8, 13) and the decoder output (1, 68, 148) bilinearly
  upsampled (align_corners=False) back to the input size;
* skip connections by center crop, bilinear interpolation or none;
* an optional 1-layer ConvLSTM with 1x1 kernels and no bias at the
  bottleneck, run over the frames of a sequence with batch 1, or over each
  of G streams with batch G (``forward`` with a leading stream axis);
* the velocity heads velpred 1, 11 and 2, tapping the interpolated depth,
  the decoder output or the bottleneck: ``DynamicConvNet`` -> an optional
  ``LSTM`` over the frames (``num_recurrent[1]`` layers, hidden size the
  encoder's feature count) -> ``VelPredictor`` with one output
  (learner_models.py:428-472,594-614); velpred 0 emits the constant
  velocity (1, 0, 0);
* event-frame input forming: ``evs_min_cutoff`` zeroing, then 2-channel
  neg/pos (form_BEV 0), |x| (1) or a binary mask (2).

Parameters keep the reference's state_dict keys (``unet_e11.weight``,
``lstm.cell_list.0.conv.weight``, ``convnet_velpred.layers.conv2d_0.weight``,
``lstm_velpred.weight_hh_l0``, ``velpred_head.fcnet.layers.fc_0.bias``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops import imageops
from .common import Conv2d, ConvTranspose2d
from .layers import VelPredictor, dynamic_convnet, head_features
from .recurrent import LSTM, ConvLSTM, convlstm_init_hidden

Size = Tuple[int, int]


def _unet_sizes(H: int, W: int):
    """Valid-conv arithmetic of the 5-level UNet -> (skip sizes [(big,
    small)] per decoder level, middle, decoded).  At 260x346 it gives the
    reference's constants (learner_models.py:558-580)."""
    def enc(h):
        sizes = []
        for _ in range(4):
            h = h - 4          # two valid 3x3 convs
            sizes.append(h)
            h = h // 2         # maxpool 2/2 floor
        h = h - 4              # e51/e52
        sizes.append(h)
        return sizes

    eh, ew = enc(H), enc(W)
    bigs = list(zip(eh[:4][::-1], ew[:4][::-1]))  # y_e4, y_e3, y_e2, y_e1
    middle = (eh[4], ew[4])
    smalls = []
    h, w = middle
    for _ in range(4):
        h, w = h * 2, w * 2    # upconv k2 s2
        smalls.append((h, w))
        h, w = h - 4, w - 4    # two valid 3x3 convs
    decoded = (h, w)
    skip_sizes = [(bigs[i], smalls[i]) for i in range(4)]
    return skip_sizes, middle, decoded


_ENCODER = (("e1", 32), ("e2", 64), ("e3", 128), ("e4", 256), ("e5", 512))
_DECODER = (("d1", 256), ("d2", 128), ("d3", 64), ("d4", 32))


class OrigUNet(nn.Module):
    def __init__(
        self,
        num_in_channels: int = 2,
        num_out_channels: int = 1,
        num_recurrent=(0, 0),
        enc_params: Optional[dict] = None,
        fc_params: Optional[dict] = None,
        input_shape=(1, 2, 260, 346),
        velpred: int = 0,
        form_BEV: int = 0,
        is_deployment: bool = False,
        evs_min_cutoff: float = 1e-3,
        skip_type: str = "crop",
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        if velpred not in (0, 1, 11, 2):
            raise ValueError(f"velpred {velpred}")
        if form_BEV in (1, 2):
            num_in_channels = 1
        elif form_BEV != 0:
            raise ValueError(f"form_BEV should be 0/1/2, but is {form_BEV}")
        if skip_type not in ("crop", "interp", "none"):
            raise ValueError(f"unknown skip_type {skip_type!r}")
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.num_in_channels = num_in_channels
        self.num_out_channels = num_out_channels
        self.num_recurrent = (
            [num_recurrent, 0] if isinstance(num_recurrent, int) else list(num_recurrent)
        )
        self.input_h, self.input_w = input_shape[-2], input_shape[-1]
        self.velpred = velpred
        self.form_BEV = form_BEV
        self.is_deployment = is_deployment
        self.evs_min_cutoff = evs_min_cutoff
        self.skip_type = skip_type
        self.skip_sizes, self.middle_hw, self.decoded_hw = _unet_sizes(self.input_h, self.input_w)

        cin = num_in_channels
        for name, cout in _ENCODER:
            setattr(self, f"unet_{name}1", Conv2d(cin, cout, 3, gen, dev))
            setattr(self, f"unet_{name}2", Conv2d(cout, cout, 3, gen, dev))
            cin = cout
        skip_mult = 1 if skip_type == "none" else 2
        for level, (name, cout) in enumerate(_DECODER, start=1):
            setattr(self, f"unet_{name}1", Conv2d(skip_mult * cout, cout, 3, gen, dev))
            setattr(self, f"unet_{name}2", Conv2d(cout, cout, 3, gen, dev))
            setattr(self, f"unet_upconv{level}",
                    ConvTranspose2d(2 * cout, cout, 2, gen, dev, stride=2))
        self.unet_out = Conv2d(32, num_out_channels, 1, gen, dev)
        if self.num_recurrent[0] > 0:
            self.lstm = ConvLSTM(512, [512] * self.num_recurrent[0], (1, 1), gen, dev, bias=False)
        self.velpred_lstm_size = 0
        if velpred > 0:
            # the tap: the interpolated depth, the decoder output, the bottleneck
            in_ch, in_hw = {1: (1, (self.input_h, self.input_w)), 11: (1, self.decoded_hw),
                            2: (512, self.middle_hw)}[velpred]
            self.convnet_velpred = dynamic_convnet(in_ch, enc_params, gen, dev)
            c, h, w = self.convnet_velpred.output_shape(in_hw)
            self.velpred_lstm_size = c * h * w
            if self.num_recurrent[1] > 0:
                self.lstm_velpred = LSTM(self.velpred_lstm_size, self.velpred_lstm_size,
                                         self.num_recurrent[1], gen, dev, dropout=0.1)
            self.velpred_head = VelPredictor(self.velpred_lstm_size, 1, fc_params, gen, dev)

    # ------------------------------------------------------------- helpers

    def form_input(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.where(x.abs() < self.evs_min_cutoff, 0.0, x)
        if self.form_BEV == 0:
            neg = torch.where(x < 0, x.abs(), 0.0)
            pos = torch.where(x > 0, x, 0.0)
            return torch.cat([neg, pos], dim=1)
        if self.form_BEV == 1:
            return x.abs()
        return torch.where(x != 0.0, 1.0, 0.0).to(x.dtype)

    def form_output(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        upsampled = imageops.interpolate_bilinear(
            x, (self.input_h, self.input_w), align_corners=False
        )
        upconv = x
        if self.num_out_channels == 2:
            upsampled = (upsampled[:, 1] - upsampled[:, 0])[:, None]
            upconv = (x[:, 1] - x[:, 0])[:, None]
        return upsampled, upconv

    def skip(self, y: torch.Tensor, big: Size, small: Size) -> Optional[torch.Tensor]:
        if self.skip_type == "crop":
            h0 = big[0] // 2 - small[0] // 2
            w0 = big[1] // 2 - small[1] // 2
            return y[:, :, h0:big[0] // 2 + small[0] // 2, w0:big[1] // 2 + small[1] // 2]
        if self.skip_type == "interp":
            return imageops.interpolate_bilinear(y, small, align_corners=False)
        return None

    def init_hidden(self, streams: Optional[int] = None):
        """Zero hidden state (h_unet, h_velpred) on the module's device: the
        ConvLSTM's [(h, c)] with batch 1, or ``streams``; the head LSTM's
        (h, c), each (L, F) or (streams, L, F), or None without one."""
        dev = self.unet_out.weight.device
        h_unet = h_velpred = None
        if self.num_recurrent[0] > 0:
            h_unet = convlstm_init_hidden(
                1 if streams is None else streams, [512] * self.num_recurrent[0],
                *self.middle_hw, device=dev,
            )
        if hasattr(self, "lstm_velpred"):
            shape = (self.num_recurrent[1], self.velpred_lstm_size)
            shape = shape if streams is None else (streams, *shape)
            h_velpred = (torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
        return (h_unet, h_velpred)

    # ------------------------------------------------------------- forward

    def _block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        relu = torch.relu
        return relu(getattr(self, f"unet_{name}2")(relu(getattr(self, f"unet_{name}1")(x))))

    def forward(
        self, x: torch.Tensor, hidden=None, generator: Optional[torch.Generator] = None,
        frame_mask: Optional[torch.Tensor] = None,
    ):
        """x: event frames (N, 1, H, W), a sequence whose N axis is the time
        axis of the ConvLSTM and the head's LSTM; or (G, N, 1, H, W), G
        streams of N frames, their batch axis G.  hidden: (h_unet,
        h_velpred) or None.  ``generator`` draws the head's dropout in
        training (none without one); ``frame_mask`` (N,) marks the valid
        frames of a padded chunk for the head's BatchNorm statistics.

        Returns (y_vel, (y_interp, y_upconv, (h_unet, h_velpred))) with the
        leading axes of x: y_vel the head's velocity, or the constant
        (1, 0, 0) of velpred = 0; y_interp the depth at the input size,
        y_upconv the decoder output (both None when deploying with velpred 0
        or 2, which need neither).
        """
        lead = x.shape[:-3]
        im = x.reshape(-1, *x.shape[-3:])
        if self.num_in_channels == 2 or self.form_BEV > 0:
            im = self.form_input(im)
        h_unet_in, h_velpred_in = hidden if hidden is not None else (None, None)

        skips: List[torch.Tensor] = []
        y = im
        for i, (name, _) in enumerate(_ENCODER):
            if i:
                skips.append(y)
                y = imageops.max_pool2d(y, 2, 2)
            y = self._block(name, y)

        h_unet = None
        if self.num_recurrent[0] > 0:
            # (G, N) streams x time, or one sequence: batch 1, time N
            seq = y.reshape(*(lead if len(lead) == 2 else (1, *lead)), *y.shape[1:])
            outs, h_unet = self.lstm(seq, h_unet_in)
            y = outs.reshape(y.shape)

        y_e5 = y
        y_interp = y_upconv = None
        if not self.is_deployment or self.velpred in (1, 11):
            for level, (name, _) in enumerate(_DECODER, start=1):
                sk = self.skip(skips[-level], *self.skip_sizes[level - 1])
                up = getattr(self, f"unet_upconv{level}")(y)
                y = self._block(name, torch.cat([sk, up], dim=1) if sk is not None else up)
            y_interp, y_upconv = self.form_output(self.unet_out(y))

        h_velpred = None
        if self.velpred > 0:
            tap = {1: y_interp, 11: y_upconv, 2: y_e5}[self.velpred]
            feats = self.convnet_velpred(tap, frame_mask)
            feats = feats.reshape(feats.shape[0], -1)
            if hasattr(self, "lstm_velpred"):
                seq, h_velpred = self.lstm_velpred(head_features(feats, lead), h_velpred_in,
                                                   generator)
                feats = seq.reshape(feats.shape)
            y_vel = self.velpred_head(feats, generator).reshape(*lead, 3)
        else:
            # made on the device, not copied from the host, so a CUDA graph
            # can capture the forward
            y_vel = torch.eye(1, 3, dtype=x.dtype, device=x.device)[0].expand(*lead, 3)
        if y_interp is not None:
            y_interp = y_interp.reshape(*lead, *y_interp.shape[1:])
            y_upconv = y_upconv.reshape(*lead, *y_upconv.shape[1:])
        return y_vel, (y_interp, y_upconv, (h_unet, h_velpred))
