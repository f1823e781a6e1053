"""The counts against hand-worked values."""

import pytest
import torch
import torch.nn.functional as F

from perfbench.counts import kernels, model_flops
from perfbench.reference import models


def test_least_time_takes_the_larger_bound():
    assert kernels.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert kernels.least_s(0, 67e12) == pytest.approx(1.0)
    assert kernels.least_s(3.35e9, 67e12) == pytest.approx(1.0)


def test_k1_one_window():
    # 5,000 events of 12 bytes, a 260x346 f32 frame; an add per event, a
    # scaling per cell: 0.000125 ms at 3.35 TB/s (the kernel table's bound)
    n_bytes, n_flops = kernels.k1(5000, 260, 346)
    assert n_bytes == 60000 + 359840 and n_flops == 5000 + 89960
    assert kernels.least_s(n_bytes, n_flops) * 1e3 == pytest.approx(0.000125, rel=0.01)


def test_k3_batch():
    n_bytes, n_flops = kernels.k3(256 * 5000, 256, 260, 346, 60, 90)
    assert n_bytes == 12 * 256 * 5000 + 4 * 256 * (5400 + 1)
    assert n_flops == 256 * 5000 + 2 * 256 * 89960 + 10 * 256 * 5400


def test_lstm_serving_shape():
    # G 1, T 256, H 128, L 3: 2 * 256 * 128 * 512 * 5 operations, 0.0025 ms
    n_bytes, n_flops = kernels.lstm(1, 256, 128, 3)
    assert n_flops == 2 * 256 * 128 * 512 * 5
    assert kernels.least_s(n_bytes, n_flops) * 1e3 == pytest.approx(0.0025, rel=0.01)
    weights = 5 * 512 * 128 + 3 * 512
    assert n_bytes == 4 * (256 * 512 + weights + 2 * 3 * 128) + 4 * (256 * 128 + 2 * 3 * 128)


def test_conv_counts_forward_and_backward():
    x = torch.randn(2, 3, 10, 12, requires_grad=True)
    w = torch.randn(8, 3, 3, 3, requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    # 2 x 8 x 8 x 10 outputs x 27 multiply-adds
    fwd = model_flops.count(lambda: F.conv2d(x, w, b))
    assert fwd["conv_flops"] == 2 * (2 * 8 * 8 * 10) * 27 == fwd["flops"]
    both = model_flops.count(lambda: F.conv2d(x, w, b).sum().backward())
    assert both["conv_flops"] == 3 * fwd["conv_flops"]
    up = model_flops.count(lambda: F.conv_transpose2d(torch.randn(1, 4, 5, 5),
                                                       torch.randn(4, 2, 2, 2), stride=2))
    assert up["conv_flops"] == 2 * (4 * 5 * 5) * (2 * 2 * 2) == up["flops"]


def test_joint_step_operations():
    # the joint model at 260x346, one window: about 12.43 GFLOP, 12.37 of it
    # in its convolutions
    sd = {k: torch.zeros(s) for k, s in models.joint_shapes().items()}
    for k in sd:
        if k.endswith(".weight_u") or k.endswith(".weight_v"):
            sd[k] = torch.ones(sd[k].shape)
    with torch.no_grad():
        c = model_flops.count(lambda: models.stream_step(
            sd, torch.zeros(1, 260, 346), torch.ones(1), None, None))
    assert c["flops"] / 1e9 == pytest.approx(12.43, abs=0.01)
    assert c["conv_flops"] / 1e9 == pytest.approx(12.37, abs=0.01)
