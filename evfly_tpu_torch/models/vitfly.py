"""The vitfly model zoo: depth (or events) -> velocity policies V(phi).

Port of ``evfly_tpu/models/vitfly.py``: ``LSTMNetVIT`` (the paper's V(phi),
3,563,663 params), ``ConvNet`` (235,269), ``LSTMNet`` (2,949,937), ``ViT``
(3,101,199) and ``UNetConvLSTMNet`` (2,955,822), with ``refine_inputs``.
Their ``_speclin`` layers are ``common.SpectralLinear`` and their masked
BatchNorms ``common.BatchNorm2d``.  Each model takes a depth (or event)
image (N, 1, H, W), the desired velocity (N, 1), an optional attitude
quaternion (N, 4) and an optional LSTM state, and returns velocity commands
(N, 3) with the LSTM's (h, c), or None for the models without an LSTM.  An
LSTM runs over the N axis as its time axis (unbatched nn.LSTM semantics), so
hidden states are (L, hidden); with a leading stream axis G (the batched
streaming pipeline) they are (G, L, hidden).  LSTMNet's LSTM (hidden 395)
and UNetConvLSTMNet's (hidden 200) always take the plain loop: the fused
kernels take hidden sizes that are multiples of 128
(``recurrent.fused_wanted``), as in the JAX package.

``LSTMNetVIT`` serves an inference call on CUDA of whole sequences from a
zero state by replaying a CUDA graph of its forward (``ServeKey``), captured
as the streaming pipelines capture theirs (``stream.pipeline._Steps``).
"""

from __future__ import annotations

import itertools
import weakref
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops import imageops
from ..precision import get_precision, with_precision
from ..stream.pipeline import StepStats, _Slot, _Steps
from ..utils import profiling
from . import recurrent
from .common import BatchNorm2d, Conv2d, ConvTranspose2d, Linear, Params, SpectralLinear
from .recurrent import LSTM
from .vit import MixTransformerEncoderLayer


def refine_inputs(img: torch.Tensor, quat: Optional[torch.Tensor]):
    """Resize the image to 60x90 and default the quaternion to identity
    (vitfly_models.py:18-31)."""
    if quat is None:
        quat = img.new_zeros(img.shape[0], 4, dtype=torch.float32)
        quat[:, 0] = 1.0
    if img.shape[-2] != 60 or img.shape[-1] != 90:
        img = imageops.interpolate_bilinear(img, (60, 90), align_corners=False)
    return img, quat


class ServeKey(NamedTuple):
    """What a serving graph of ``LSTMNetVIT`` depends on beyond its buffers'
    addresses; a change to any of it captures anew."""
    inputs: tuple             # (shape, dtype) of img, desvel and quat (None when not given)
    device: torch.device
    precision: str            # set_precision
    fused_lstm: bool          # set_fused_lstm
    lstm: Tuple[str, str]     # the LSTM's (mode, route)
    weights: tuple            # (data_ptr, _version) of every parameter and buffer


def _serves_by_graph(model: nn.Module, img: torch.Tensor, hidden, generator) -> bool:
    """Whether ``LSTMNetVIT.forward`` replays a serving graph, from what the
    call shows alone: a CUDA input, no autograd (``no_grad`` or
    ``inference_mode``), eval mode, whole sequences from a zero state
    (``hidden`` None), no generator, and no graph capture around the call
    (the streaming pipelines capture the joint model's head whole)."""
    return (img.is_cuda and not torch.is_grad_enabled() and not model.training
            and hidden is None and generator is None
            and not torch.cuda.is_current_stream_capturing())


def _weights_key(module: nn.Module) -> tuple:
    """(data_ptr, _version) of every parameter and buffer of ``module``, as
    ``recurrent.LSTM.packed`` keys its cache: a replaced tensor changes its
    address, an edit in place (``load_state_dict``, an optimizer step) its
    version.  A walk of the module dicts: ``parameters()`` takes 2.5 times
    as long."""
    out = []
    stack = [module]
    while stack:
        m = stack.pop()
        for t in itertools.chain(m._parameters.values(), m._buffers.values()):
            if t is not None:
                out.append((t.data_ptr(), t._version))
        stack.extend(m._modules.values())
    return tuple(out)


class LSTMNetVIT(nn.Module):
    """ViT + LSTM, the paper's V(phi): 3,563,663 params."""

    def __init__(self, generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev, gen = resolve_device(device), _generator(generator)
        self.encoder_blocks = _encoder_blocks(gen, dev)
        self.decoder = SpectralLinear(4608, 512, gen, dev)
        self.lstm = LSTM(517, 128, 3, gen, dev, bias=True, dropout=0.1)
        self.nn_fc2 = SpectralLinear(128, 3, gen, dev)
        self.down_sample = Conv2d(48, 12, 3, gen, dev, padding=1)
        # the serving graphs' counters (steps, captures, searched per ServeKey)
        self.serve_stats = StepStats()
        self._serving: Optional[_Steps] = None

    def load_params(self, params: Params) -> "LSTMNetVIT":
        """Load a state_dict (a checkpoint, or ``port.from_jax_params``);
        every key must match."""
        self.load_state_dict(params, strict=True)
        return self

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(_vit_features(self, x))

    @with_precision
    def forward(
        self,
        img: torch.Tensor,
        desvel: torch.Tensor,
        quat: Optional[torch.Tensor] = None,
        hidden: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
        frame_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """img (N, 1, H, W), desvel (N, 1), quat (N, 4) or None: the LSTM
        runs over N as its time axis, hidden (3, 128) each.  With a leading
        stream axis, img (G, N, 1, H, W), desvel (G, N, 1), quat (G, N, 4):
        G sequences through one LSTM launch, hidden (G, 3, 128) each.
        ``generator`` draws the LSTM's inter-layer dropout in training, as
        the JAX package's ``rng``; without one there is no dropout.
        ``frame_mask`` is taken for the zoo's common signature and unused:
        the model has no BatchNorm.  Runs at the precision of
        ``evfly_tpu_torch.set_precision``; the span ``evfly.head``
        (``utils.profiling``), whose count ``replayed`` is 1 for a replay.

        On CUDA, a call with no autograd, in eval mode, from a zero state
        and with no generator, outside a graph capture
        (``_serves_by_graph``), replays a CUDA graph of this forward
        captured for its ``ServeKey``: the inputs are copied into the
        graph's buffers, and velocity, h and c come back as clones.  Each
        key seen once costs one capture (``stream.pipeline._Steps``: two
        warm-up calls under cuDNN's algorithm search, then the capture; its
        spans ``evfly.serve.fill``, ``.capture`` and ``.replay``); new
        weights (``load_params``, an optimizer step) replace the graph of
        their input shape.  ``serve_stats`` counts the calls and captures
        per key.  Every other call runs eagerly.
        Returns (velocity (..., 3), (h, c))."""
        replay = _serves_by_graph(self, img, hidden, generator)
        with profiling.span("evfly.head", replayed=int(replay)):
            if replay:
                vel, h, c = self._replay(img, desvel, quat)
                return vel, (h, c)
            return self._head(img, desvel, quat, hidden, generator)

    def _head(self, img, desvel, quat, hidden=None, generator=None):
        """The forward's body, run eagerly."""
        lead, img, desvel, quat = _flatten(img, desvel, quat)
        out = torch.cat([self._encode(img), desvel / 10.0, quat], dim=1)
        out, h = self.lstm(out.reshape(*lead, out.shape[-1]), hidden, generator)
        return self.nn_fc2(out), h

    def serve_key(self, img: torch.Tensor, desvel: torch.Tensor,
                  quat: Optional[torch.Tensor] = None) -> ServeKey:
        """The key of a served call on these inputs under the current
        settings and weights."""
        return ServeKey(
            tuple(None if t is None else (tuple(t.shape), t.dtype) for t in (img, desvel, quat)),
            img.device, get_precision(), recurrent.fused_lstm_enabled(), self.lstm.kernel(),
            _weights_key(self))

    def _replay(self, img, desvel, quat) -> tuple:
        """One served call: the slot of its key (the slot of the same
        inputs under other weights dropped), filled and replayed."""
        steps = self._serving
        if steps is None or steps.device != img.device:
            steps = self._serving = _Steps(img.device, True, [], "evfly.serve")
            steps.stats = self.serve_stats
        key = self.serve_key(img, desvel, quat)
        if key not in steps.slots:
            for old in [k for k in steps.slots
                        if k._replace(weights=()) == key._replace(weights=())]:
                del steps.slots[old]
        given = {"img": img, "desvel": desvel, "quat": quat}
        model = weakref.ref(self)  # the graph's body holds no reference to the model

        def make():
            # ordinary tensors even under inference_mode: later calls may copy under no_grad
            with torch.inference_mode(False):
                bufs = {name: torch.empty_like(t, memory_format=torch.contiguous_format)
                        for name, t in given.items() if t is not None}

            def body():
                vel, (h, c) = model()._head(bufs["img"], bufs["desvel"], bufs.get("quat"))
                return vel, h, c

            return _Slot(bufs, body)

        def fill(bufs):
            for name, buf in bufs.items():
                buf.copy_(given[name])

        return steps.run(key, make, fill)


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def _encoder_blocks(gen, dev) -> nn.ModuleList:
    """The two MixTransformer blocks of LSTMNetVIT and ViT."""
    return nn.ModuleList([
        MixTransformerEncoderLayer(1, 32, patch_size=7, stride=4, padding=3, n_layers=2,
                                   reduction_ratio=8, num_heads=1, expansion_factor=8,
                                   gen=gen, device=dev),
        MixTransformerEncoderLayer(32, 64, patch_size=3, stride=2, padding=1, n_layers=2,
                                   reduction_ratio=4, num_heads=2, expansion_factor=8,
                                   gen=gen, device=dev),
    ])


def _vit_features(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The flattened (B, 4608) input of LSTMNetVIT's and ViT's decoder."""
    e1 = model.encoder_blocks[0](x)   # (B, 32, 15, 23)
    e2 = model.encoder_blocks[1](e1)  # (B, 64, 8, 12)
    fused = torch.cat(
        [
            imageops.pixel_shuffle(e2, 2),                                    # (B, 16, 16, 24)
            imageops.interpolate_bilinear(e1, (16, 24), align_corners=True),  # (B, 32, 16, 24)
        ],
        dim=1,
    )
    fused = model.down_sample(fused)
    return fused.reshape(fused.shape[0], -1)


def _flatten(img, desvel, quat):
    """(lead, img (B, 1, 60, 90), desvel (B, 1), quat (B, 4)): the inputs
    with any leading stream axis folded into the batch, refined."""
    lead = img.shape[:-3]
    img = img.reshape(-1, *img.shape[-3:])
    desvel = desvel.reshape(-1, desvel.shape[-1])
    if quat is not None:
        quat = quat.reshape(-1, quat.shape[-1])
    img, quat = refine_inputs(img, quat)
    return lead, img, desvel, quat


def _min_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """-max_pool2d(-x, k, 1), the zoo's min-pool."""
    return -imageops.max_pool2d(-x, k, 1)


class _ZooModel(nn.Module):
    """The common signature of the zoo's other models: as
    ``LSTMNetVIT.forward``, with ``frame_mask`` (N,) marking the valid
    frames of a padded chunk for the BatchNorms in training (their
    statistics and running-stat updates cover those frames only); with a
    leading chunk axis, img (G, N, 1, H, W) and ``frame_mask`` (G, N), each
    chunk's BatchNorm statistics are its own (``common.BatchNorm2d``)."""

    def load_params(self, params: Params):
        """Load a state_dict (a checkpoint, or ``port.from_jax_params``);
        every key must match."""
        self.load_state_dict(params, strict=True)
        return self

    @with_precision
    def forward(
        self,
        img: torch.Tensor,
        desvel: torch.Tensor,
        quat: Optional[torch.Tensor] = None,
        hidden: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
        frame_mask: Optional[torch.Tensor] = None,
    ):
        """Returns (velocity (..., 3), (h, c) or None)."""
        lead, img, desvel, quat = _flatten(img, desvel, quat)
        if frame_mask is not None:
            frame_mask = frame_mask.reshape(lead)
        return self._body(lead, img, desvel, quat, hidden, generator, frame_mask)


class ConvNet(_ZooModel):
    """Conv + FC network, 235,269 params (vitfly_models.py:33-70)."""

    def __init__(self, generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev, gen = resolve_device(device), _generator(generator)
        self.conv1 = Conv2d(1, 4, 3, gen, dev, stride=3)
        self.conv2 = Conv2d(4, 10, 3, gen, dev, stride=2)
        self.bn1 = BatchNorm2d(4, dev)
        self.fc0 = Linear(845, 256, gen, dev, bias=False)
        self.fc1 = Linear(256, 64, gen, dev, bias=False)
        self.fc2 = Linear(64, 32, gen, dev, bias=False)
        self.fc3 = Linear(32, 3, gen, dev)

    def _body(self, lead, img, desvel, quat, hidden, generator, frame_mask):
        x = self.bn1(torch.relu(self.conv1(img)), frame_mask)
        x = _min_pool(x, 2)
        x = imageops.avg_pool2d(torch.relu(self.conv2(x)), 3, 1)
        x = torch.cat([x.reshape(x.shape[0], -1), desvel * 0.1, quat], dim=1)
        x = imageops.leaky_relu(self.fc0(x))
        x = imageops.leaky_relu(self.fc1(x))
        x = torch.tanh(self.fc2(x))
        x = self.fc3(x)
        return x.reshape(*lead, 3), None


class LSTMNet(_ZooModel):
    """Conv + LSTM + FC network, 2,949,937 params (vitfly_models.py:72-109);
    its LSTM (hidden 395, 2 layers, no bias) takes the plain loop."""

    def __init__(self, generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev, gen = resolve_device(device), _generator(generator)
        self.conv1 = Conv2d(1, 4, 5, gen, dev, stride=3, padding=1)
        self.conv2 = Conv2d(4, 10, 3, gen, dev, stride=2)
        self.bn1 = BatchNorm2d(4, dev)
        self.bn2 = BatchNorm2d(10, dev)
        self.lstm = LSTM(665, 395, 2, gen, dev, bias=False, dropout=0.15)
        self.fc1 = SpectralLinear(395, 64, gen, dev)
        self.fc2 = SpectralLinear(64, 16, gen, dev)
        self.fc3 = SpectralLinear(16, 3, gen, dev)

    def _body(self, lead, img, desvel, quat, hidden, generator, frame_mask):
        x = self.bn1(torch.relu(self.conv1(img)), frame_mask)
        x = _min_pool(x, 3)
        x = self.bn2(torch.relu(self.conv2(x)), frame_mask)
        x = imageops.avg_pool2d(x, 3, 1)
        x = torch.cat([x.reshape(x.shape[0], -1), desvel * 0.1, quat], dim=1)
        x, h = self.lstm(x.reshape(*lead, x.shape[-1]), hidden, generator)
        x = imageops.leaky_relu(self.fc1(x))
        x = imageops.leaky_relu(self.fc2(x))
        return self.fc3(x), h


class ViT(_ZooModel):
    """ViT + FC network, 3,101,199 params (vitfly_models.py:152-186): the
    encoder of LSTMNetVIT with a plain linear decoder and no LSTM."""

    def __init__(self, generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev, gen = resolve_device(device), _generator(generator)
        self.encoder_blocks = _encoder_blocks(gen, dev)
        self.decoder = Linear(4608, 512, gen, dev)
        self.nn_fc1 = SpectralLinear(517, 256, gen, dev)
        self.nn_fc2 = SpectralLinear(256, 3, gen, dev)
        self.down_sample = Conv2d(48, 12, 3, gen, dev, padding=1)

    def _body(self, lead, img, desvel, quat, hidden, generator, frame_mask):
        out = self.decoder(_vit_features(self, img))
        out = torch.cat([out, desvel / 10.0, quat], dim=1)
        out = imageops.leaky_relu(self.nn_fc1(out))
        return self.nn_fc2(out).reshape(*lead, 3), None


_UNET_CONVS = (  # name, in, out, kernel, stride, padding
    ("unet_e11", 1, 4, 3, 1, 1), ("unet_e12", 4, 4, 3, 1, 1),
    ("unet_e21", 4, 8, 3, 1, 1), ("unet_e22", 8, 8, 3, 1, 1),
    ("unet_e31", 8, 16, 3, 1, 1), ("unet_e32", 16, 16, 3, 1, 1),
    ("unet_d11", 16, 8, 3, 1, 1), ("unet_d12", 8, 8, 3, 1, 1),
    ("unet_d21", 8, 4, 3, 1, 1), ("unet_d22", 4, 4, 3, 1, 1),
    ("unet_out", 4, 1, 1, 1, 0),
    ("conv_conv1", 2, 4, 5, 3, 0), ("conv_conv2", 4, 10, 5, 2, 0),
)


class UNetConvLSTMNet(_ZooModel):
    """UNet + ConvNet + LSTM network, 2,955,822 params
    (vitfly_models.py:188-263); its LSTM (hidden 200, 2 layers, no bias)
    takes the plain loop."""

    def __init__(self, generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev, gen = resolve_device(device), _generator(generator)
        for name, ci, co, k, stride, padding in _UNET_CONVS:
            setattr(self, name, Conv2d(ci, co, k, gen, dev, stride=stride, padding=padding))
        self.unet_upconv1 = ConvTranspose2d(16, 8, 2, gen, dev, stride=2)
        self.unet_upconv2 = ConvTranspose2d(8, 4, 3, gen, dev, stride=3)
        self.conv_bn1 = BatchNorm2d(4, dev)
        self.lstm = LSTM(3065, 200, 2, gen, dev, bias=False, dropout=0.15)
        self.nn_fc1 = SpectralLinear(200, 64, gen, dev)
        self.nn_fc2 = SpectralLinear(64, 32, gen, dev)
        self.nn_fc3 = SpectralLinear(32, 3, gen, dev)

    def _body(self, lead, img, desvel, quat, hidden, generator, frame_mask):
        relu = torch.relu
        y_e1 = relu(self.unet_e12(relu(self.unet_e11(img))))
        enc1 = imageops.max_pool2d(y_e1, 2, 3)
        y_e2 = relu(self.unet_e22(relu(self.unet_e21(enc1))))
        enc2 = imageops.max_pool2d(y_e2, 2, 2)
        y_e3 = relu(self.unet_e32(relu(self.unet_e31(enc2))))

        up1 = self.unet_upconv1(y_e3)
        d1 = relu(self.unet_d12(relu(self.unet_d11(torch.cat([up1, y_e2], dim=1)))))
        up2 = self.unet_upconv2(d1)
        d2 = relu(self.unet_d22(relu(self.unet_d21(torch.cat([up2, y_e1], dim=1)))))
        y_unet = self.unet_out(d2)

        y = self.conv_bn1(self.conv_conv1(torch.cat([img, y_unet], dim=1)), frame_mask)
        y = _min_pool(relu(y), 2)
        y = imageops.avg_pool2d(relu(self.conv_conv2(y)), 2, 1)

        x_lstm = torch.cat([y.reshape(y.shape[0], -1), y_e3.reshape(y_e3.shape[0], -1),
                            desvel * 0.1, quat], dim=1)
        y, h = self.lstm(x_lstm.reshape(*lead, x_lstm.shape[-1]), hidden, generator)
        y = imageops.leaky_relu(self.nn_fc1(y))
        y = imageops.leaky_relu(self.nn_fc2(y))
        return self.nn_fc3(y), h
