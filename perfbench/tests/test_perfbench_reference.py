"""The benchmark's plain reference against the port's plain CPU path, at
small sizes: the same state_dict and inputs through both."""

import pytest
import torch

from perfbench.reference import events, models, train
from perfbench import weights

from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
from evfly_tpu_torch.models.vitfly import LSTMNetVIT
from evfly_tpu_torch.ops import voxelizer
from evfly_tpu_torch.stream.pipeline import BatchedStreamingPipeline, StreamingPipeline
from evfly_tpu_torch.train import stepfn

CPU = torch.device("cpu")
H, W = 190, 190  # the smallest frame the UNet takes
JOINT = dict(num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0],
             input_shape=[1, 1, H, W], velpred=0, form_BEV=2, evs_min_cutoff=0.0,
             skip_type="interp")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.shape == b.shape
    err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    assert err <= tol, err


def _events(seed, B, N, h=H, w=W):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(B, N, generator=g) * w
    y = torch.rand(B, N, generator=g) * h
    p = torch.randint(0, 2, (B, N), generator=g, dtype=torch.int32) * 2 - 1
    p[:, N // 2 + seed % 7:] = 0  # padding
    return x, y, p


def test_parameter_counts():
    assert models.count_params(models.vitlstm_shapes()) == 3_563_663
    assert models.count_params(models.joint_shapes()) == 13_420_336


def test_keys_load_strict():
    sd = weights.init_state_dict(models.joint_shapes(), 5, CPU)
    OrigUNet_w_VITFLY_ViTLSTM(device=CPU, **JOINT).load_params(sd)
    sd = weights.init_state_dict(models.vitlstm_shapes(), 5, CPU)
    LSTMNetVIT(device=CPU).load_params(sd)


def test_histograms():
    x, y, p = _events(1, 3, 4000, 260, 346)
    _close(events.histogram(x, y, p, 260, 346),
           voxelizer.hist_frame_plain(x, y, p, 260, 346), 0.0)
    _close(events.scaled_resized(x, y, p, 260, 346, 60, 90),
           voxelizer.hist_scaled_resized_plain(x, y, p, 260, 346, 60, 90)[0], 1e-6)


def test_vitlstm_over_a_batch():
    sd = weights.init_state_dict(models.vitlstm_shapes(), 2, CPU)
    port = LSTMNetVIT(device=CPU).load_params(sd).eval()
    img = torch.rand(12, 1, 60, 90, generator=torch.Generator().manual_seed(3)) * 2 - 1
    desvel = torch.full((12, 1), 4.0)
    with torch.no_grad():
        v_ref, (h_ref, c_ref) = models.vitlstm(sd, img, desvel)
        v, (h, c) = port(img, desvel)
    _close(v, v_ref, 1e-5)
    _close(h, h_ref, 1e-5)
    _close(c, c_ref, 1e-5)


def test_stream_step_chains():
    sd = weights.init_state_dict(models.joint_shapes(), 4, CPU)
    model = OrigUNet_w_VITFLY_ViTLSTM(device=CPU, **JOINT).load_params(sd).eval()
    pipe = StreamingPipeline(model, input_hw=(H, W), device=CPU)
    h_unet = h_vit = None
    desvel = torch.tensor([4.0])
    with torch.no_grad():
        for k in range(3):
            x, y, p = _events(10 + k, 1, 3000)
            vel, depth = pipe.step_events(x[0], y[0], p[0])
            frame = events.quantile_scale(events.histogram(x, y, p, H, W))
            v_ref, d_ref, h_unet, h_vit = models.stream_step(sd, frame, desvel, h_unet, h_vit)
            _close(vel, v_ref[0], 1e-5)
            _close(depth, d_ref[0], 1e-5)
    (h_u, c_u), = pipe.hidden[0][0]
    _close(h_u, h_unet[0], 1e-5)
    _close(pipe.hidden[1][1], h_vit[1][0], 1e-5)


def test_batched_step_with_reset():
    G = 2
    sd = weights.init_state_dict(models.joint_shapes(), 6, CPU)
    model = OrigUNet_w_VITFLY_ViTLSTM(device=CPU, **JOINT).load_params(sd).eval()
    pipe = BatchedStreamingPipeline(model, G, input_hw=(H, W), device=CPU)
    g = torch.Generator().manual_seed(8)
    h_unet = h_vit = None
    desvel = torch.full((G,), 4.0)
    with torch.no_grad():
        for k in range(3):
            frames = (torch.rand(G, H, W, generator=g) < 0.1) * 0.2
            mask = torch.tensor([k == 2, False])
            vel, depth = pipe.step_frames(frames, mask)
            if h_unet is not None:
                keep = (~mask).to(torch.float32)
                h_unet = tuple(t * keep[:, None, None, None] for t in h_unet)
                h_vit = tuple(t * keep[:, None, None] for t in h_vit)
            v_ref, d_ref, h_unet, h_vit = models.stream_step(
                sd, events.quantile_scale(frames), desvel, h_unet, h_vit)
            _close(vel, v_ref, 1e-5)
            _close(depth, d_ref, 1e-5)


def test_train_step():
    B = 4
    sd = weights.init_state_dict(models.joint_shapes(), 9, CPU)
    g = torch.Generator().manual_seed(1)
    data = {"evs": torch.randint(-127, 128, (B + 2, H, W), generator=g, dtype=torch.int8),
            "depths": torch.randint(0, 256, (B + 2, H, W), generator=g, dtype=torch.uint8),
            "desvel": torch.full((B + 2,), 5.0),
            "velcmd": torch.rand(B + 2, 3, generator=g)}
    data["evs"] *= (torch.rand(B + 2, H, W, generator=g) < 0.1).to(torch.int8)
    model = OrigUNet_w_VITFLY_ViTLSTM(device=CPU, **JOINT).load_params(
        {k: v.clone() for k, v in sd.items()})
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    step = stepfn.make_train_step(model, "joint_vitlstm", opt, [10.0, 1.0], [5.0, -1.0],
                                  batch_fn=stepfn.make_batch_slicer(B, 2, 1))
    ref = {k: v.clone() for k, v in sd.items()}
    adam = train.Adam(train.trained_keys(ref))
    for s in (0, 1):
        loss, _values, gn = step(data, {"start": s, "ev_start": s, "n_valid": B})
        ref_loss, grads = train.train_step(ref, adam, train.decode_chunks(data, [s], B))
        assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
        ref_gn = torch.sqrt(sum((g_ ** 2).sum() for g_ in grads.values()))
        assert abs(float(gn) - float(ref_gn)) <= 1e-4 * float(ref_gn)
    # Adam turns the rounding of near-zero gradients (a key's bias under
    # softmax) into lr-sized steps, so each leaf's change is held by its norm
    got = model.state_dict()
    for k in adam.keys:
        d_ref = (ref[k] - sd[k]).norm()
        assert abs(float((got[k] - sd[k]).norm() - d_ref)) <= 1e-4 * float(d_ref), k
