"""The port's two report tools (evfly_tpu_torch/tools/esim_divergence_report.py,
upsample_report.py) against the repo's JAX tools, on the CPU at small
sizes (the JAX ESIM tool renders at its render's default size: its render
is patched to 48x64 here; the upsample tool takes --hw).

The margin rule decides the tolerance.  The packages' renders may differ
only at pixels within RENDER_MARGIN of a render edge (render_margins), and
ESIM's and difflog's counts only there or within 1e-5 of a quantization
crossing (esim_margins, difflog_margins; ESIM's carried reference passes a
flip on to later windows, so a flagged pixel stays flagged after).  So:
- the count frames are held EQUAL away from the flagged pixel-windows;
- each metric of the JSON is a statistic over pixel-windows, which the
  differing ones (all flagged) can move by at most their share s of the
  nonzero entries or of the count mass (the larger): every metric within 4 s x max(|m|, 1) (4: a
  ratio or a normalized statistic moves by its numerator's and its
  denominator's share, each counted twice for the two packages), the
  quantiles of the counts within JAX's quantiles at q -/+ 100 s', s' the
  differing share of the nonzero counts, and the integer maxima within one
  count.  The upsample report's renders are held under the margin rule
  (grayscale within 1e-5, flow within 1e-3 + 1e-4 |f| away from the
  flagged pixels), and each metric within the bound its inputs'
  differences give (below); its adaptive factors (ceil of the largest flow
  over a frame) within one step.
"""

import functools
import json
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import evfly_tpu.sim.render as j_render
from evfly_tpu.ops.esim import esim_event_frames as j_esim
from evfly_tpu.ops.voxelizer import difflog_events as j_difflog
from evfly_tpu_torch.ops.esim import esim_event_frames as t_esim
from evfly_tpu_torch.ops.esim import esim_margins
from evfly_tpu_torch.ops.upsample import linear_log_upsample as t_linear_log_upsample
from evfly_tpu_torch.ops.upsample import upsample_sequence as t_upsample_sequence
from evfly_tpu_torch.ops.voxelizer import difflog_margins
from evfly_tpu_torch.sim import generate_forest, render
from evfly_tpu_torch.sim.batched import pad_fields
from evfly_tpu_torch.tools import esim_divergence_report as esim_tool
from evfly_tpu_torch.tools import upsample_report as up_tool

from torch_tools_cases import jax_tool
from torch_tools_cases import few_torch_threads, keep_precision  # noqa: F401  (fixtures)

CPU = torch.device("cpu")
H, W = 48, 64
MARGIN = 1e-5


def _field_pad(seed):
    field = generate_forest(np.random.default_rng(seed), num_obstacles=30, trees=True)
    return pad_fields([field], K_min=48, device=CPU)


def _held(ref: dict, got: dict, s: float, quantiles: dict):
    assert ref.keys() == got.keys()
    for k, r in ref.items():
        g = got[k]
        if k in quantiles:
            lo, hi, top = quantiles[k]
            assert all(a - 1e-9 <= x <= b + 1e-9 for a, x, b in zip(lo, g[:3], hi)), (k, g, lo, hi)
            assert abs(g[3] - r[3]) <= top, k
        elif isinstance(r, (list, str)) or k in ("frames", "base_frames", "gt_rate_multiple"):
            if k != "adaptive_factor_p50_p95_max":
                assert g == r, k
        elif k == "max_abs_count_diff":
            assert abs(g - r) <= 1, k
        else:
            assert abs(g - r) <= 4 * s * max(abs(r), 1.0), (k, g, r, s)


def test_esim_divergence_report_matches_jax(monkeypatch, tmp_path):
    frames_n, seed, th = 10, 11, 0.2
    monkeypatch.setattr(j_render, "render_depth_intensity",
                        functools.partial(j_render.render_depth_intensity, H=H, W=W))
    jtool = jax_tool("esim_divergence_report")
    monkeypatch.setattr(sys, "argv", ["x", "--frames", str(frames_n), "--out-json",
                                      str(tmp_path / "j.json")])
    jtool.main()
    ref = json.loads((tmp_path / "j.json").read_text())
    got = esim_tool.report(seed, frames_n, hw=(H, W), device=CPU)

    # the counts behind both reports, and the flagged pixel-windows
    frames = esim_tool.render_trajectory(seed, frames_n, 30.0, 4.0, (H, W), CPU)
    ce, cd = esim_tool.counts(frames, th, CPU)
    centers, radii = _field_pad(seed)
    pos = torch.tensor([[4.0 / 30.0 * i, 0.0, 2.0] for i in range(frames_n)])
    jf = np.stack([np.asarray(j_render.render_depth_intensity(
        jnp.asarray(p.numpy()), jnp.asarray(centers[0].numpy()), jnp.asarray(radii[0].numpy()),
        is_trees=True)[1]) for p in pos])
    je = np.rint(np.asarray(j_esim(jnp.asarray(jf), th, th)) / th).astype(np.int64)
    jd = np.rint(np.stack([np.asarray(j_difflog(jnp.asarray(jf[i + 1]), jnp.asarray(jf[i]), th, th))
                           for i in range(frames_n - 1)]) / th).astype(np.int64)
    rflag = (render.render_margins(pos, centers.expand(frames_n, -1, -1),
                                   radii.expand(frames_n, -1), H=H, W=W, is_trees=True,
                                   device=CPU) < render.RENDER_MARGIN).numpy()
    win = rflag[1:] | rflag[:-1]
    flag_d = win | (difflog_margins(frames[1:], frames[:-1], th, th, device=CPU).numpy() < MARGIN)
    flag_e = np.logical_or.accumulate(
        win | (esim_margins(frames, th, th, device=CPU).numpy() < MARGIN), axis=0)
    np.testing.assert_array_equal(ce[~flag_e], je[~flag_e])
    np.testing.assert_array_equal(cd[~flag_d], jd[~flag_d])

    # the pixel-windows where the packages' counts differ (all flagged,
    # checked above), as a share of the entries and of the count mass
    shares, nz_shares = [], []
    for ours, theirs in ((ce, je), (cd, jd)):
        diff = ours != theirs
        for c in (ours, theirs):
            a = np.abs(c)
            shares += [a[diff].sum() / a.sum(), diff.sum() / max((c != 0).sum(), 1)]
            nz_shares.append(diff[c != 0].mean())
    s, s_nz = max(shares), max(nz_shares)
    print(f"esim report: {int(rflag.sum())} render-flagged pixels of {rflag.size}; "
          f"{int((ce != je).sum())} ESIM and {int((cd != jd).sum())} difflog counts differ, "
          f"all flagged; share s {s:.4g} (nonzero counts {s_nz:.4g}); metric diffs "
          + ", ".join(f"{k} {abs(got[k] - ref[k]):.3g}" for k in ref
                      if isinstance(ref[k], float)))
    assert s < 0.05
    quantiles = {}
    for key, c in (("count_quantiles_esim_p50_p95_p99_max", je),
                   ("count_quantiles_difflog_p50_p95_p99_max", jd)):
        nz = np.abs(c[c != 0])
        qs = np.array([50, 95, 99])
        quantiles[key] = (np.percentile(nz, np.clip(qs - 100 * s_nz, 0, 100)),
                          np.percentile(nz, np.clip(qs + 100 * s_nz, 0, 100)), 1)
    _held(ref, got, s, quantiles)


def test_upsample_report_matches_jax(monkeypatch, tmp_path):
    """The renders (grayscale and flow) held under the margin rule; then
    each metric within the bound that the differences of its inputs give
    by the triangle inequality (frame MAE: mean |up - up'| + mean |hi -
    hi'|; event L1: the sums of the event frames' differences; a cosine:
    2 (|a - a'| / |a'| + |b - b'| / |b'|) per window; a ratio n / d: (|n -
    n'| + |n' / d'| |d - d'|) / (|d'| - |d - d'|)), the JAX side of each
    recomputed here from the JAX package's functions as the JAX tool
    computes it."""
    from evfly_tpu.ops import upsample as j_up

    T, K, seed, fps, th = 5, 4, 11, 15.0, 0.2
    jtool = jax_tool("upsample_report")
    monkeypatch.setattr(sys, "argv", ["x", "--frames", str(T), "--factor", str(K), "--hw",
                                      str(H), str(W), "--out-json", str(tmp_path / "j.json")])
    jtool.main()
    ref = json.loads((tmp_path / "j.json").read_text())
    vel = np.array([3.0, 1.0, 0.0], np.float32)
    hi, flows_hi = up_tool.render_sequence(seed, T, K, fps, vel, (H, W), CPU)
    got = up_tool.upsample_report(hi, flows_hi, K, fps, vel, th, CPU)

    centers, radii = _field_pad(seed)
    n, dt = T * K + 1, 1.0 / fps
    pos = np.stack([np.array([0.0, 0.0, 2.0], np.float32) + vel * (i * dt / K)
                    for i in range(n)]).astype(np.float32)
    lw = np.array([0.299, 0.587, 0.114], np.float32)
    jr = [j_render.render_rgbd_flow(jnp.asarray(p), jnp.asarray(vel), jnp.zeros(3),
                                    jnp.asarray(centers[0].numpy()), jnp.asarray(radii[0].numpy()),
                                    H=H, W=W, is_trees=True) for p in pos]
    jhi = np.stack([np.asarray(rgb) @ lw for rgb, _, _ in jr])
    jflows = np.stack([np.asarray(f) for _, _, f in jr])
    ok = (render.render_margins(torch.as_tensor(pos), centers.expand(n, -1, -1),
                                radii.expand(n, -1), H=H, W=W, is_trees=True, device=CPU)
          >= render.RENDER_MARGIN).numpy()
    np.testing.assert_allclose(hi[ok], jhi[ok], rtol=0, atol=1e-5)
    np.testing.assert_allclose(flows_hi[ok], jflows[ok], rtol=1e-4, atol=1e-3)

    # the JAX tool's intermediates
    frames, jframes = hi[::K], jhi[::K]
    jup, _ = j_up.upsample_sequence(jframes, jflows[::K], np.arange(T + 1) * dt, fixed_factor=K)
    up, _ = t_upsample_sequence(frames, flows_hi[::K], np.arange(T + 1) * dt, fixed_factor=K,
                                device=CPU)
    esim = lambda f: t_esim(f, th, th, device=CPU).numpy()
    jesim = lambda f: np.asarray(j_esim(jnp.asarray(f), th, th))
    truth, jtruth = esim(hi), jesim(jhi)
    upf, jupf = esim(up), jesim(jup)
    lin, jlin = (esim(t_linear_log_upsample(frames, K)),
                 jesim(j_up.linear_log_upsample(jframes, K)))

    mids = [i for i in range(n) if i % K]
    m = lambda a, b: float(np.mean([np.abs(a[i] - b[i]).mean() for i in mids]))
    fade = lambda f: np.stack([(1 - (i % K) / K) * f[i // K] + (i % K) / K * f[min(i // K + 1, T)]
                               for i in range(n)])
    b_warp = m(up, jup) + m(hi, jhi)
    b_fade = m(fade(frames), fade(jframes)) + m(hi, jhi)

    def ratio_bound(num, den, b_num, b_den):
        return (b_num + abs(num / den) * b_den) / (abs(den) - b_den)

    def cos_bound(a, b, ja, jb):
        out = []
        for i in range(len(a)):
            na, nb = np.linalg.norm(ja[i]), np.linalg.norm(jb[i])
            out.append(2.0 if na == 0 or nb == 0 else
                       2 * (np.linalg.norm(a[i] - ja[i]) / na + np.linalg.norm(b[i] - jb[i]) / nb))
        return float(np.mean(out))

    b_l1_up = float(np.abs(upf - jupf).sum() + np.abs(truth - jtruth).sum())
    b_l1_lin = float(np.abs(lin - jlin).sum() + np.abs(truth - jtruth).sum())
    bounds = {
        "frame_mae_flow_warp": b_warp,
        "frame_mae_crossfade": b_fade,
        "frame_mae_ratio": ratio_bound(ref["frame_mae_flow_warp"], ref["frame_mae_crossfade"],
                                       b_warp, b_fade),
        "fine_event_l1_flow_warp": b_l1_up,
        "fine_event_l1_linear_in_log": b_l1_lin,
        "fine_event_l1_ratio": ratio_bound(ref["fine_event_l1_flow_warp"],
                                           ref["fine_event_l1_linear_in_log"], b_l1_up, b_l1_lin),
        "fine_event_cosine_flow_warp": cos_bound(upf, truth, jupf, jtruth),
        "fine_event_cosine_linear_in_log": cos_bound(lin, truth, jlin, jtruth),
    }
    print("upsample report: " + ", ".join(
        f"{k} |diff| {abs(got[k] - ref[k]):.3g} (bound {b:.3g})" for k, b in bounds.items()))
    for k, b in bounds.items():
        assert abs(got[k] - ref[k]) <= b * (1 + 1e-6) + 1e-9, (k, got[k], ref[k], b)
    for k in ("base_frames", "gt_rate_multiple", "hw", "vel", "threshold"):
        assert got[k] == ref[k], k
    assert all(abs(a - b) <= 1 for a, b in zip(got["adaptive_factor_p50_p95_max"],
                                               ref["adaptive_factor_p50_p95_max"]))


@pytest.mark.parametrize("tool", ["esim_divergence_report", "upsample_report"])
def test_report_cli_on_cpu(tmp_path, tool):
    mod = {"esim_divergence_report": esim_tool, "upsample_report": up_tool}[tool]
    argv = ["--frames", "3", "--hw", "24", "32", "--device", "cpu", "--out-json",
            str(tmp_path / "r.json")]
    out = mod.main(argv)
    assert json.loads((tmp_path / "r.json").read_text()) == json.loads(json.dumps(out))
    assert out["hw"] == [24, 32]
